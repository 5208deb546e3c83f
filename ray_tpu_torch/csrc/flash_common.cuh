// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout: q, k, v, o and their gradients are [bh, seq, D] row-major and
// contiguous; lse and delta are [bh, seq] float32. Inputs are bf16, float16
// or float32; every product accumulates in float32.
//
// Two families of kernel bodies live on these pieces:
//
// - The Hopper bodies (namespace flash::sm90 below): the 16-bit (bf16 and
//   float16) forward, dQ and dK/dV kernels at D <= 128. One warp of a
//   producer warpgroup streams tiles into a ring in shared memory with TMA,
//   ordered by mbarriers; two consumer warpgroups take turns to run every
//   tile product on wgmma and keep probabilities and dS in registers.
// - The CUDA-core bodies of the three kernels: every float32 instance, and
//   the 16-bit ones at D 192 and 256. A block owns BLOCK = 64 rows, 4 warps
//   of 16 rows, and streams tiles of PlainTiles<D>::STREAM rows past them;
//   every operand of a tile product is read from shared memory by
//   `warp_gemm`, which runs the 16x8 mma.sync accumulator layout on the
//   CUDA cores in float32. wgmma has no float32 type, and TF32 keeps about
//   three decimal digits, too few for the 1e-4 the float32 instances are
//   held to, so those stay on the CUDA cores. The 16-bit instances at
//   D > 128 use these bodies until they get a Hopper design of their own.
// - The wide bodies (namespace flash::wide): every type at head dims above
//   256 that are a multiple of 64, d a run-time argument, accumulators in
//   shared memory, on the CUDA cores in float32.
//
// Accumulator layout (the mma.sync C fragment, which is also the layout of
// each warp's 16 rows of a wgmma accumulator), lane = 4 * g + t:
//   c[0], c[1] -> row g,     cols 2t, 2t+1 of the 8-wide tile
//   c[2], c[3] -> row g + 8, cols 2t, 2t+1

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr int BLOCK = 64;          // rows of every tile (queries or keys)
constexpr int WARPS = 4;           // 16 rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;  // mask fill, as in the TPU kernels

// Tiles of the CUDA-core bodies (mirrored by TILES in ray_tpu_torch/ops/
// attention.py): a block owns BLOCK rows and streams STREAM rows a tile.
// Above D = 128 the streamed tile halves, so that the tiles fit in shared
// memory and S, dP and the D-wide accumulators in registers, and the dK/dV
// block runs SPLIT = 2 warps per 16 keys, each holding the dK and dV
// accumulators of half the columns: at D = 256 the two accumulators of
// all D columns would take 256 floats a thread, more than a thread's 255
// registers.
template <int D>
struct PlainTiles {
  static constexpr int STREAM = D > 128 ? 32 : 64, SPLIT = D > 128 ? 2 : 1;
};

// One element as float32.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// Shared-memory row stride in elements: 16 bytes of padding per row keeps
// the fragment loads below free of bank conflicts.
template <typename T, int D>
__host__ __device__ constexpr int ld() { return D + 16 / (int)sizeof(T); }

// Copy rows [row0, row0 + ROWS) of a [seq, D] matrix into shared memory
// with 16-byte vectors, NT threads taking turns; rows at or past `seq` are
// zero-filled.
template <typename T, int D, int ROWS = BLOCK, int NT = THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int seq) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld<T, D>() + c) = val;
  }
}

// One warp, in float32 on the CUDA cores: C[16 x 8*NT] += A[16 x K] *
// B[K x 8*NT], in the 16x8 mma.sync accumulator layout; 16-bit operands are
// widened to float32 as they are read.
// A is row-major in shared memory (A(m, k) = A[m * lda + k]).
// B_NK: B(k, n) = B[n * ldb + k] (B stored as N x K, e.g. K for Q.K^T);
// otherwise B(k, n) = B[k * ldb + n] (stored as K x N, e.g. V for P.V).
template <bool B_NK, int NT, int K, typename T>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4], const T* A,
                                          int lda, const T* B, int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = to_float(A[g * lda + k]);
    const float a1 = to_float(A[(g + 8) * lda + k]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * t;
      const float b0 = to_float(B_NK ? B[n * ldb + k] : B[k * ldb + n]);
      const float b1 =
          to_float(B_NK ? B[(n + 1) * ldb + k] : B[k * ldb + n + 1]);
      c[nt][0] = fmaf(a0, b0, c[nt][0]);
      c[nt][1] = fmaf(a0, b1, c[nt][1]);
      c[nt][2] = fmaf(a1, b0, c[nt][2]);
      c[nt][3] = fmaf(a1, b1, c[nt][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
}

// Two neighbouring elements (p even-aligned) in one store.
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Write a warp's [16 x 8*NT] accumulator into a row-major T matrix
// (shared or global) whose row 0 is the warp's first row; rows at or past
// `rows` are dropped.
template <typename T, int NT>
__device__ __forceinline__ void store_acc(T* dst, int ldd, const float (&c)[NT][4],
                                          int rows) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (g < rows) store_pair(dst + g * ldd + col, c[nt][0], c[nt][1]);
    if (g + 8 < rows) store_pair(dst + (g + 8) * ldd + col, c[nt][2], c[nt][3]);
  }
}

// Sum (or max) over the four lanes that hold one accumulator row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Set a dynamic shared-memory size on a kernel and launch it; returns the
// CUDA error of the launch (0 on success).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace flash

// Codes the C entry points return besides CUDA's own errors.
#define FLASH_ERR_UNSUPPORTED 1000  // dtype or head dimension not compiled
#define FLASH_ERR_NO_ENCODER 1001   // libcuda has no cuTensorMapEncodeTiled
#define FLASH_ERR_TENSOR_MAP 1002   // cuTensorMapEncodeTiled refused a map
#define FLASH_ERR_SMEM 1003         // a wide body's tiles exceed 227 KB

// --------------------------------------------------------------------------
// Hopper pieces: TMA, mbarriers and wgmma, as short inline PTX.
// --------------------------------------------------------------------------

namespace flash {
namespace sm90 {

// Two consumer warpgroups of 64 rows each (warps 0-7), then one producer
// warpgroup, whose first warp issues the copies. The producer gives up
// registers (setmaxnreg) so that each consumer thread may hold 232: the
// accumulators alone take D / 2 floats each.
constexpr int CONSUMERS = 2;
constexpr int WG_THREADS = 128;
constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;
constexpr int PRODUCER_WARP = CONSUMERS * 4;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 65,536 in all
constexpr float LOG2E = 1.4426950408889634f;

// Tiles of the 16-bit Hopper kernels (mirrored by TILES in ray_tpu_torch/ops/
// attention.py). Every block owns 128 rows, 64 per consumer warpgroup (the M
// of wgmma), and streams tiles through a ring of STAGES slots. dQ and dK/dV
// stream a smaller tile at d = 128: dQ holds S, dP and dS of a tile beside
// its D / 2 floats of dQ in each thread's registers, dK/dV two
// accumulators of D / 2. dQ keeps a slot two turns (S_i, then dS_i K_i in
// the next turn), so it gets a fourth slot.
template <int D>
struct FwdTiles {  // forward: owns query rows, streams K and V
  static constexpr int ROWS = 128, TILE = 128, STAGES = 3;
};
template <int D>
struct DqTiles {  // dQ: owns query rows (Q, dO and O), streams K and V
  static constexpr int ROWS = 128, TILE = D == 128 ? 64 : 128, STAGES = 4;
};
template <int D>
struct DkvTiles {  // dK/dV: owns key rows, streams Q, dO, lse and delta
  static constexpr int ROWS = 128, TILE = D == 128 ? 32 : 64, STAGES = 3;
};

// A tile of R rows x D 16-bit columns lies in shared memory as D / C chunks
// of R rows x C columns, one TMA box each, swizzled by TMA as wgmma reads
// it: C = 64 (128-byte rows, 128B swizzle) or, at d = 32, C = 32 (64-byte
// rows, 64B swizzle). A chunk is a multiple of 1024 bytes, so each stays
// aligned to the swizzle pattern's period.
template <int D>
__host__ __device__ constexpr int chunk_cols() { return D < 64 ? D : 64; }
template <int D>
__host__ __device__ constexpr int row_bytes() { return chunk_cols<D>() * 2; }
template <int D>  // the descriptor's swizzle code: 2 = 64B, 1 = 128B
__host__ __device__ constexpr uint64_t layout_code() { return D < 64 ? 2 : 1; }
template <int R, int D>
__host__ __device__ constexpr uint32_t tile_bytes() { return R * D * 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// Operand for k-step kk (16 columns of the contraction) of a K-major tile:
// rows are the M or N dimension, the contraction runs along the stored
// row. A step inside a swizzled row advances the start address by 32 bytes;
// 8-row groups lie row_bytes * 8 apart.
template <int R, int D>
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  constexpr int C = chunk_cols<D>();
  const uint32_t addr = tile + (kk * 16 / C) * (R * row_bytes<D>()) +
                        (kk * 16 % C) * 2;
  return make_desc(addr, 16, 8 * row_bytes<D>(), layout_code<D>());
}

// Operand for k-step kk (16 rows) of an MN-major tile: the contraction runs
// down the rows, N along the stored row. A step advances 16 rows; the
// chunks of a d-128 tile (two 64-column atoms along N) lie LBO apart.
template <int R, int D>
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * row_bytes<D>(), R * row_bytes<D>(),
                   8 * row_bytes<D>(), layout_code<D>());
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Arrive and announce `bytes` of TMA traffic that completes the phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the completion of the barrier's phase with this parity: the
// n-th completion (from 0) has parity n & 1. A wait that lasts 2^35 cycles
// (over 15 s; a tile takes microseconds) means a lost copy or a barrier
// fault: it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 35)) {
      __trap();
    }
  }
}

// One TMA box of a [bh, seq, D] map: columns c0.., rows row0.., head bh.
// Rows past the tensor's seq are zero-filled, within the head.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int row0,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(row0), "r"(bh)
      : "memory");
}

// All chunks of one R-row tile, rows row0.. of head bh.
template <int R, int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int bh) {
  constexpr int C = chunk_cols<D>();
#pragma unroll
  for (int c = 0; c < D / C; ++c)
    tma_load(dst + c * R * row_bytes<D>(), map, bar, c * C, row0, bh);
}

// Move registers between warpgroups; every thread of the warpgroup runs it.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x on the special-function unit (ex2.approx, flushing denormals): one
// instruction, where exp2f adds a range check and two multiplies.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers of the two consumer warpgroups (ids 1 and 2; 0 is
// __syncthreads): a warpgroup waits at its own with bar.sync and releases
// the other's with bar.arrive.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(CONSUMERS * WG_THREADS)
               : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(CONSUMERS * WG_THREADS)
               : "memory");
}
// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma for either 16-bit type: TEXT(ty) spells the instruction with `ty`
// as the type of A and B (f16 or bf16); the operands follow.
#define FLASH_WGMMA(T, TEXT, ...)                       \
  if constexpr (std::is_same<T, __half>::value)         \
    asm volatile(TEXT("f16") __VA_ARGS__);              \
  else                                                  \
    asm volatile(TEXT("bf16") __VA_ARGS__)

template <int N, typename T>
struct Wgmma;

#define FLASH_WG_N32_SS(ty) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." ty "." ty " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
  "}, %16, %17, p, 1, 1, 0, 0;\n}\n"

#define FLASH_WG_N32_RS(ty) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." ty "." ty " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
  "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"

#define FLASH_WG_N64_SS(ty) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." ty "." ty " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31" \
  "}, %32, %33, p, 1, 1, 0, 0;\n}\n"

#define FLASH_WG_N64_RS(ty) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." ty "." ty " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31" \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"

#define FLASH_WG_N128_SS(ty) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." ty "." ty " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63" \
  "}, %64, %65, p, 1, 1, 0, 0;\n}\n"

#define FLASH_WG_N128_RS(ty) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." ty "." ty " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63" \
  "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"

template <typename T>
struct Wgmma<32, T> {
  // d[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
    FLASH_WGMMA(T, FLASH_WG_N32_SS,
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d[64 x 32] (+)= A[64 x 16] B[16 x 32], A in registers (each warp's
  // 16 rows as the mma.sync A fragment), B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    FLASH_WGMMA(T, FLASH_WG_N32_RS,
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <typename T>
struct Wgmma<64, T> {
  // d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    FLASH_WGMMA(T, FLASH_WG_N64_SS,
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers (each warp's
  // 16 rows as the mma.sync A fragment), B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    FLASH_WGMMA(T, FLASH_WG_N64_RS,
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <typename T>
struct Wgmma<128, T> {
  // d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
    FLASH_WGMMA(T, FLASH_WG_N128_SS,
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d[64 x 128] (+)= A[64 x 16] B[16 x 128], A in registers (each warp's
  // 16 rows as the mma.sync A fragment), B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    FLASH_WGMMA(T, FLASH_WG_N128_RS,
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

// Two floats as the 16-bit pair of an A fragment register (lower column in
// the low half).
template <typename T>
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The A fragments of a P (or dS) accumulator [64 x N] for a product that
// contracts over its N columns: k-step kk takes columns 16kk..16kk+15, which
// are the accumulator's 8-column tiles 2kk and 2kk+1.
template <int N, typename T>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[N / 16][4],
                                           const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_rn<T>(c[8 * kk + 0], c[8 * kk + 1]);  // row g,   cols 2t..
    a[kk][1] = pack_rn<T>(c[8 * kk + 2], c[8 * kk + 3]);  // row g+8, cols 2t..
    a[kk][2] = pack_rn<T>(c[8 * kk + 4], c[8 * kk + 5]);  // row g, cols 8+2t..
    a[kk][3] = pack_rn<T>(c[8 * kk + 6], c[8 * kk + 7]);  // row g+8, 8+2t..
  }
}

// acc + the dot product of two vectors of 8 16-bit elements each, in
// float32.
template <typename T>
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const T* x = reinterpret_cast<const T*>(&a);
  const T* y = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = fmaf(to_float(x[i]), to_float(y[i]), acc);
  return acc;
}

// Write a warp's 16 rows of a [64 x D] accumulator as 16-bit rows of a
// row-major [*, D] matrix whose row 0 is the warp's first row; rows at or
// past `rows` are dropped.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* dst,
                                           const float (&c)[D / 2], int rows) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (g < rows) store_pair(dst + g * D + col, c[4 * j], c[4 * j + 1]);
    if (g + 8 < rows)
      store_pair(dst + (g + 8) * D + col, c[4 * j + 2], c[4 * j + 3]);
  }
}

// Host: cuTensorMapEncodeTiled from libcuda, fetched at run time so that
// the library needs no -lcuda.
static PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The TMA map of a contiguous 16-bit [bh, seq, D] tensor, one box = `rows`
// rows x one chunk of columns. Three dimensions, so that a box that runs
// past `seq` is zero-filled instead of reading the next head's rows.
// Returns 0 or a FLASH_ERR_ code.
template <typename T, int D>
static int make_map(CUtensorMap* map, const void* ptr, int bh, int seq,
                    int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return FLASH_ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)seq * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)chunk_cols<D>(), (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map,
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : FLASH_ERR_TENSOR_MAP;
}

// Dynamic shared memory is rounded up to the 1024-byte swizzle period here.
constexpr int SMEM_ALIGN = 1024;
__device__ __forceinline__ uint8_t* aligned_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((SMEM_ALIGN - (a % SMEM_ALIGN)) % SMEM_ALIGN);
}

}  // namespace sm90
}  // namespace flash

// --------------------------------------------------------------------------
// The wide bodies: head dims above 256 that are a multiple of 64.
// --------------------------------------------------------------------------
//
// One instance per type and kernel serves every such head dim: d is a
// run-time argument. A block of 4 warps owns ROWS = 16 rows (queries; keys
// for dK/dV) and streams tiles of *_STREAM rows past them. The D-wide
// float32 accumulators (O; dQ; dK and dV) and the tile products (P, dS)
// live in dynamic shared memory, not in registers, so the block's shared
// memory grows with d (fwd_smem, dq_smem, dkv_smem below, mirrored by
// kernel_smem_bytes in ray_tpu_torch/ops/attention.py): it fits the 227 KB
// a block may take up to d 704 in float32 and d 1024 in bf16 and float16.
// Every product runs on the CUDA cores in float32.
namespace flash {
namespace wide {

constexpr int ROWS = 16, THREADS = 128;
constexpr int FWD_STREAM = 16, DQ_STREAM = 16, DKV_STREAM = 8;
constexpr int SMEM_LIMIT = 232448;  // bytes one block may opt in to

__host__ __device__ constexpr bool head_dim(int d) {
  return d > 256 && d % 64 == 0;
}

// Shared-memory row stride in elements: 16 bytes of padding, as ld<T, D>.
template <typename T>
__host__ __device__ inline int ld(int d) {
  return d + 16 / (int)sizeof(T);
}

template <typename T>
size_t fwd_smem(int d) {  // O; P; Q; K and V tiles
  return (size_t)ROWS * d * 4 + ROWS * FWD_STREAM * 4 +
         (size_t)(ROWS + 2 * FWD_STREAM) * ld<T>(d) * sizeof(T);
}
template <typename T>
size_t dq_smem(int d) {  // dQ; dS; Q and dO; K and V tiles
  return (size_t)ROWS * d * 4 + ROWS * DQ_STREAM * 4 +
         (size_t)(2 * ROWS + 2 * DQ_STREAM) * ld<T>(d) * sizeof(T);
}
template <typename T>
size_t dkv_smem(int d) {  // dK, dV; P, dS; lse, delta; K, V; Q and dO tiles
  return (size_t)2 * ROWS * d * 4 + 2 * ROWS * DKV_STREAM * 4 +
         2 * DKV_STREAM * 4 +
         (size_t)(2 * ROWS + 2 * DKV_STREAM) * ld<T>(d) * sizeof(T);
}

// Copy rows [row0, row0 + rows) of a [seq, d] matrix into shared memory
// (row stride ld<T>(d)) with 16-byte vectors; rows at or past `seq` are
// zero-filled.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int rows, int seq, int d) {
  const int per_row = d / (16 / (int)sizeof(T)), lds = ld<T>(d);
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * (16 / (int)sizeof(T));
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(dst + r * lds + c) = val;
  }
}

// Sixteen bytes of a 16-byte aligned row as float32.
template <typename T>
__device__ __forceinline__ void unpack(const T* p, float (&x)[16 / sizeof(T)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) x[i] = to_float(e[i]);
}

// a . b0 and a . b1 over d elements of shared-memory rows.
template <typename T>
__device__ __forceinline__ void dot2(const T* a, const T* b0, const T* b1,
                                     int d, float& s0, float& s1) {
  constexpr int V = 16 / sizeof(T);
  for (int j = 0; j < d; j += V) {
    float x[V], y0[V], y1[V];
    unpack(a + j, x);
    unpack(b0 + j, y0);
    unpack(b1 + j, y1);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s0 = fmaf(x[i], y0[i], s0);
      s1 = fmaf(x[i], y1[i], s1);
    }
  }
}

// a . b over d elements of shared-memory rows.
template <typename T>
__device__ __forceinline__ float dot(const T* a, const T* b, int d) {
  constexpr int V = 16 / sizeof(T);
  float s = 0.f;
  for (int j = 0; j < d; j += V) {
    float x[V], y[V];
    unpack(a + j, x);
    unpack(b + j, y);
#pragma unroll
    for (int i = 0; i < V; ++i) s = fmaf(x[i], y[i], s);
  }
  return s;
}

// Sum (or max) over the 8 lanes that share one row (lanes 8r .. 8r + 7).
__device__ __forceinline__ float oct_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}
__device__ __forceinline__ float oct_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_one(__half* p, float x) {
  *p = __float2half_rn(x);
}

// acc[rr][j] += sum_c w[rr][c] * B[c][j] for the block's ROWS rows and all
// d columns: thread x takes columns x, x + THREADS, ..., and holds the
// column of B in registers. w is [ROWS][S] float32, B [S][ld] in shared
// memory.
template <int S, typename T>
__device__ __forceinline__ void add_wb(float* acc, const float* w,
                                       const T* B, int d) {
  const int lds = ld<T>(d);
  for (int j = threadIdx.x; j < d; j += THREADS) {
    float b[S];
#pragma unroll
    for (int c = 0; c < S; ++c) b[c] = to_float(B[c * lds + j]);
#pragma unroll 4
    for (int rr = 0; rr < ROWS; ++rr) {
      float a = acc[rr * d + j];
#pragma unroll
      for (int c = 0; c < S; ++c) a = fmaf(w[rr * S + c], b[c], a);
      acc[rr * d + j] = a;
    }
  }
}

// Write the block's float32 [ROWS][d] accumulator to rows row0.. of a
// [seq, d] matrix, times `mul` (each row's own, or 1); rows at or past
// `seq` are dropped. Lane c of a row's 8 takes columns c, c + 8, ....
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float* acc, int row0,
                                           int seq, int d, float mul) {
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
  if (row0 + r >= seq) return;
  for (int j = c; j < d; j += 8)
    store_one(dst + (size_t)(row0 + r) * d + j, acc[r * d + j] * mul);
}

}  // namespace wide
}  // namespace flash

// The C entry points take dtype 0 = float32, 1 = bfloat16, 2 = float16,
// and a head dimension of 32, 64, 128, 192 or 256, or a multiple of 64
// above 256 whose wide tiles fit; anything else returns
// FLASH_ERR_UNSUPPORTED or FLASH_ERR_SMEM. Each shared library built from
// a source that includes this header exports its own copy.
extern "C" const char* flash_error_string(int code) {
  if (code == FLASH_ERR_UNSUPPORTED)
    return "unsupported dtype or head dimension";
  if (code == FLASH_ERR_SMEM)
    return "the head dimension's tiles exceed a block's 227 KB of shared "
           "memory";
  if (code == FLASH_ERR_NO_ENCODER)
    return "libcuda has no cuTensorMapEncodeTiled";
  if (code == FLASH_ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

// Expands to the body of a C entry point: calls `fn<T, D>(args...)` for the
// requested dtype and head dimension.
#define FLASH_DISPATCH_D(fn, T, d, ...)                                   \
  do {                                                                     \
    if (d == 32) return fn<T, 32>(__VA_ARGS__);                            \
    if (d == 64) return fn<T, 64>(__VA_ARGS__);                            \
    if (d == 128) return fn<T, 128>(__VA_ARGS__);                          \
    if (d == 192) return fn<T, 192>(__VA_ARGS__);                          \
    if (d == 256) return fn<T, 256>(__VA_ARGS__);                          \
  } while (0)
#define FLASH_DISPATCH(fn, dtype, d, ...)                                  \
  do {                                                                     \
    if (dtype == 0) FLASH_DISPATCH_D(fn, float, d, __VA_ARGS__);           \
    if (dtype == 1) FLASH_DISPATCH_D(fn, __nv_bfloat16, d, __VA_ARGS__);   \
    if (dtype == 2) FLASH_DISPATCH_D(fn, __half, d, __VA_ARGS__);          \
    return FLASH_ERR_UNSUPPORTED;                                          \
  } while (0)
// The same for the wide bodies: calls `fn<T>(args...)`, d among the args.
#define FLASH_DISPATCH_WIDE(fn, dtype, ...)                                \
  do {                                                                     \
    if (dtype == 0) return fn<float>(__VA_ARGS__);                         \
    if (dtype == 1) return fn<__nv_bfloat16>(__VA_ARGS__);                 \
    if (dtype == 2) return fn<__half>(__VA_ARGS__);                        \
    return FLASH_ERR_UNSUPPORTED;                                          \
  } while (0)

namespace flash {
// Whether the instance <T, D> runs a Hopper body (sm90) or a CUDA-core one.
template <typename T, int D>
constexpr bool hopper_body() {
  return sizeof(T) == 2 && D <= 128;
}
}  // namespace flash
