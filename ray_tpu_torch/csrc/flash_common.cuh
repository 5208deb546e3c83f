// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout: q, k, v, o and their gradients are [bh, seq, D] row-major and
// contiguous; lse and delta are [bh, seq] float32. Inputs are bf16, float16
// or float32; every product accumulates in float32.
//
// Every body runs its products on the tensor cores, fed through a ring of
// shared-memory slots by TMA. Two families:
//
// - The Hopper bodies (namespace flash::sm90 below): all three kernels in
//   16 bits (bf16 and float16) at every head dim, at D <= 256 one instance
//   per D and above 256 with d at run time (WideFwdTiles, WideDqTiles,
//   WideDkvTiles). One warp of a producer warpgroup streams tiles into a
//   ring in shared memory with TMA, ordered by mbarriers; two consumer
//   warpgroups run every tile product on wgmma. From D 192 up the dK/dV
//   block's two warpgroups share its keys, one accumulating dV and the
//   other dK, the first handing P^T to the second through shared memory
//   (flash_bwd.cu says why).
// - The float32 bodies (namespace flash::tf32 below: fwd_kernel_tf32 in
//   flash_fwd.cu, bwd_dq_kernel_tf32 and bwd_dkv_kernel_tf32 in
//   flash_bwd.cu): all three kernels at every float32 head dim, d at run
//   time. Their products run in 3xTF32: each float32 operand is split in
//   registers into two TF32 values, x = big + small, and a product is
//   big*big + big*small + small*big, accumulated in float32. The dropped
//   small*small term is about 2^-22 of the product, float32's own
//   accuracy, where a single TF32 pass (three decimal digits) misses the
//   1e-4 and 5e-4 the float32 instances are held to. A producer warpgroup
//   streams tiles into a ring with TMA, as the Hopper bodies' does; two
//   consumer warpgroups run the products that contract over d (S, dP) on
//   wgmma and those that contract over the streamed rows (P V; dS K; P^T
//   dO and dS^T Q) on mma.sync (m16n8k8 .tf32), splitting the operands
//   they hold in registers themselves.
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

constexpr float NEG_INF = -1e30f;  // mask fill, as in the TPU kernels

// One 16-bit element as float32.
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

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

// Sum (or max) over the four lanes that hold one accumulator row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Make the current device's primary context current on the calling thread,
// before the entry points encode tensor maps: cuTensorMapEncodeTiled
// refused every map on a thread that had made no CUDA call yet (autograd's
// backward thread, where the attention backward was its first work).
// Returns 0 or CUDA's error.
inline int bind_device() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  return (int)err;
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
// The 16-bit dQ body above d 256 holds dQ's 128 floats beside S and dP of
// 64 keys (32 each): at 232 registers it spilled and ptxas serialised its
// wgmma. Its producers only count slots and issue copies, so they give up
// more (64,512 in all).
constexpr int WIDE_PRODUCER_REGS = 24, WIDE_CONSUMER_REGS = 240;
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
// The forward at D 192 and 256: Q of 128 rows (48 and 64 KB) stays
// resident, and K and V stream in tiles of 64 keys, 3 slots of each at d
// 192 and 2 at d 256 (24 and 32 KB a tile), as many as fit beside Q; tiles
// of 80 to 112 keys ran no faster on an H100.
template <>
struct FwdTiles<192> {
  static constexpr int ROWS = 128, TILE = 64, STAGES = 3;
};
template <>
struct FwdTiles<256> {
  static constexpr int ROWS = 128, TILE = 64, STAGES = 2;
};
template <int D>
struct DqTiles {  // dQ: owns query rows (Q, dO and O), streams K and V
  static constexpr int ROWS = 128, TILE = D == 128 ? 64 : 128, STAGES = 4;
};
template <int D>
struct DkvTiles {  // dK/dV: owns key rows, streams Q, dO, lse and delta
  static constexpr int ROWS = 128, TILE = D == 128 ? 32 : 64, STAGES = 3;
};
// The backward pair at D 192 and 256 (flash_bwd.cu). dQ: Q, dO and O of
// 128 rows would take 144 and 192 KB, so O stays in device memory (the
// prologue reads it for delta) and K and V stream in tiles of 32 keys
// through as many slots as the rest of the 227 KB holds. dK/dV: one
// warpgroup cannot hold dK and dV (D floats a thread), so both consumer
// warpgroups own the same 64 keys, one accumulating dV and the other dK,
// and Q and dO stream in tiles of 64 queries: through 2 slots at d 256,
// which ran faster on an H100 than 4 slots of 32 queries (m64n32 products
// read as many bytes of shared memory as they compute).
template <>
struct DqTiles<192> {
  static constexpr int ROWS = 128, TILE = 32, STAGES = 5;
};
template <>
struct DqTiles<256> {
  static constexpr int ROWS = 128, TILE = 32, STAGES = 3;
};
template <>
struct DkvTiles<192> {
  static constexpr int ROWS = 64, TILE = 64, STAGES = 3;
};
template <>
struct DkvTiles<256> {
  static constexpr int ROWS = 64, TILE = 64, STAGES = 2;
};
// The 16-bit forward above d 256 (fwd_kernel_sm90_wide in flash_fwd.cu),
// d at run time. Neither Q of 128 rows (80 to 256 KB) nor a K tile of 64
// keys (40 to 128 KB) fits beside the rest, and a warpgroup's O of d / 2
// floats a thread does not fit in registers. So O's columns are split over
// the grid: a block owns 128 query rows and one chunk of at most 256 of
// O's columns (COLS: 192 or 256 wide, the chunks of one head dim alike),
// computes S over all d columns from 64-column chunks of Q and K that
// stream through a ring of STAGES slots (one chunk of each a slot), and
// P V for its chunk from V tiles of TILE keys x COLS columns through
// V_STAGES slots. Its shared memory does not grow with d.
struct WideFwdTiles {
  static constexpr int ROWS = 128, TILE = 64, STAGES = 6, V_STAGES = 2;
};
// The 16-bit backward pair above d 256 (flash_bwd.cu), d at run time, on
// the forward's answer: a block owns one chunk of COLS (192 or 256) of the
// gradients' columns, computes S and dP over all d columns from 64-column
// chunks that stream through ring A (STAGES slots, one chunk of each
// operand a slot), and takes the operand of its chunk's product, TILE rows
// x COLS columns, from ring B (B_STAGES slots), which a second producer
// warp fills as soon as a slot is free: one slot is enough, since the next
// tile's chunks of S take longer than its load. dQ: 128 query rows, a slot
// of A holds a chunk of Q, dO, K and V, B holds K's columns of the chunk.
// dK/dV: 64 keys that both warpgroups share as at d 256, a slot of A holds
// a chunk of K, V, Q and dO, B holds Q's and dO's columns of the chunk
// with the tile's lse and delta. Neither block's shared memory grows with
// d.
struct WideDqTiles {
  static constexpr int ROWS = 128, TILE = 64, STAGES = 4, B_STAGES = 1;
};
struct WideDkvTiles {
  static constexpr int ROWS = 64, TILE = 64, STAGES = 4, B_STAGES = 1;
};
// Column chunks of O (dQ; dK and dV) at head dim d: as few as 256 columns
// each allow, of equal width, a multiple of 64 (the last one may run past
// d).
__host__ __device__ constexpr int wide_chunks(int d) {
  return (d / 64 + 3) / 4;
}
__host__ __device__ constexpr int wide_cols(int d) {
  return (d / 64 + wide_chunks(d) - 1) / wide_chunks(d) * 64;
}

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

// k_major<R, D>(tile, kk) from desc0 = k_major<R, D>(tile, 0): kk's offset
// added to the start address field (tiles lie below 256 KB, so the field
// never carries into the next).
template <int R, int D>
__device__ __forceinline__ uint64_t k_major_at(uint64_t desc0, int kk) {
  constexpr int C = chunk_cols<D>();
  return desc0 + (uint64_t)(((kk * 16 / C) * (R * row_bytes<D>()) +
                             (kk * 16 % C) * 2) >> 4);
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

// One TMA box of a one-dimensional map (make_map_1d): elements x0.., x0 a
// multiple of 16 bytes, into dst, a multiple of 128. Elements past the end
// are zero-filled.
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x0)
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
// x, as a value the compiler cannot see through: the operand descriptors
// built from it inside a loop are rebuilt at each use instead of being
// hoisted out of the loop and held in registers (at d 256, 32 descriptors
// of 64 bits beside the accumulators spill).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
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

// d[64 x N] (+)= A[64 x 16] B[16 x N] at N = 192 or 256, B MN-major in
// shared memory, issued as a product of 128 columns and one of N - 128:
// B's 64-column chunk c lies c LBO past its descriptor's start (LBO is the
// descriptor's field, in the same 16-byte units as its address), and the
// accumulator of columns 128.. follows that of columns 0..127 in d, which
// is the layout of one m64nNk16 accumulator. A in registers.
template <int N, typename T>
struct WgmmaCols {
  static_assert(N == 192 || N == 256, "column chunks of 128 and 64 or 128");
  using Rest = Wgmma<N - 128, T>;
  static __device__ __forceinline__ uint64_t past128(uint64_t b) {
    return b + 2 * ((b >> 16) & 0x3FFF);
  }
  static __device__ __forceinline__ float (&lo(float (&d)[N / 2]))[64] {
    return *reinterpret_cast<float(*)[64]>(&d[0]);
  }
  static __device__ __forceinline__ float (&hi(float (&d)[N / 2]))[N / 2 - 64] {
    return *reinterpret_cast<float(*)[N / 2 - 64]>(&d[64]);
  }
  static __device__ __forceinline__ void rs(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    Wgmma<128, T>::rs(lo(d), a, b, accumulate);
    Rest::rs(hi(d), a, past128(b), accumulate);
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

// Write a warp's 16 rows of a [64 x N] accumulator as rows of T of a
// row-major matrix with row stride ldd, whose element 0 is the warp's
// first row at the accumulator's first column; rows at or past `rows` and
// columns at or past `cols` (a multiple of 8) are dropped.
template <int N, typename T>
__device__ __forceinline__ void store_cols(T* dst, int ldd,
                                           const float (&c)[N / 2], int rows,
                                           int cols) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (8 * j < cols && g < rows)
      store_pair(dst + (size_t)g * ldd + col, c[4 * j], c[4 * j + 1]);
    if (8 * j < cols && g + 8 < rows)
      store_pair(dst + (size_t)(g + 8) * ldd + col, c[4 * j + 2],
                 c[4 * j + 3]);
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

// The TMA map of a contiguous [bh, seq, d] tensor of T (bf16, float16 or
// float32), one box = `rows` rows x `cols` columns: 128 bytes of columns
// with the 128B swizzle (64 16-bit or 32 float32 ones), or fewer, d itself
// below that, with the 64B swizzle. Three dimensions, so that a box that
// runs past `seq` is zero-filled instead of reading the next head's rows.
// Returns 0 or a FLASH_ERR_ code.
template <typename T>
static int make_map_cols(CUtensorMap* map, const void* ptr, int bh, int seq,
                         int d, int rows, int cols) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return FLASH_ERR_NO_ENCODER;
  constexpr cuuint64_t SIZE = sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * SIZE,
                                 (cuuint64_t)seq * d * SIZE};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map,
      std::is_same<T, float>::value    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols * SIZE < 128 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : FLASH_ERR_TENSOR_MAP;
}
// The map of a contiguous float32 vector of n elements (lse or delta,
// [bh, seq] read as one row), one box = `box` elements (a multiple of 4),
// unswizzled: a two-dimensional map's rows would need seq to be a multiple
// of 4. Returns 0 or a FLASH_ERR_ code.
static int make_map_1d(CUtensorMap* map, const void* ptr, long n, int box) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return FLASH_ERR_NO_ENCODER;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};  // unread at rank 1
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t elem[1] = {1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims,
      strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : FLASH_ERR_TENSOR_MAP;
}
// The same at a compile-time head dim D, one chunk of columns a box.
template <typename T, int D>
static int make_map(CUtensorMap* map, const void* ptr, int bh, int seq,
                    int rows) {
  return make_map_cols<T>(map, ptr, bh, seq, D, rows, chunk_cols<D>());
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
// The float32 bodies' pieces: 3xTF32 products on wgmma and mma.sync.
// --------------------------------------------------------------------------
//
// Tiles of fwd_kernel_tf32 (flash_fwd.cu), mirrored by TILES in
// ray_tpu_torch/ops/attention.py. A block owns ROWS query rows, 16 a warp
// (the M of mma.sync), 64 a warpgroup (the M of wgmma), and one chunk of
// COLS of O's columns; it streams key tiles of TILE rows. S is built over
// all d from 32-column chunks (one 128-byte TMA box, 128B swizzle) of Q's
// rows and of the tile's keys, one chunk of each and the keys' small parts
// a slot of ring A (STAGES slots, one fewer beside V's widest tiles); P V
// takes V's [TILE x COLS] tile from ring B (V_STAGES slots). No block
// grows with d: Q of 128 rows at d 256 would take 128 KB by itself.
namespace flash {
namespace tf32 {

constexpr int ROWS = 128, TILE = 64, STAGES = 4, V_STAGES = 2;
// Consumer warps, then a producer warpgroup whose first warp issues the
// copies and whose other three (CONVERTERS) write K's small parts: a
// whole warpgroup, so that setmaxnreg can hand its registers to the
// consumers (9 warps alone get 168 a thread, since one of the SM's four
// register partitions holds 3 of them, and O's 128 floats a thread at
// COLS 256 spilled there). The producers only count slots, issue copies
// and convert, so they keep the fewest, as the wide 16-bit dQ body's do.
constexpr int WARPS = ROWS / 16;
constexpr int THREADS = (WARPS + 4) * 32;
constexpr int CONVERTERS = 3;
constexpr int PRODUCER_REGS = sm90::WIDE_PRODUCER_REGS;  // 24
constexpr int CONSUMER_REGS = sm90::WIDE_CONSUMER_REGS;  // 240
constexpr int CHUNK = 32;                   // columns of a box, 128 bytes
// The blocks an H100 runs at once (132 SMs, one block each): a grid with
// fewer splits O's columns further (see cols).
constexpr int FILL = 132;

// O's columns a block owns at head dim d when the grid has `blocks` row
// blocks (bh x q-blocks): the power of two from 32 to `widest` (256) that
// covers d, so that a block owns all of d up to 256 and above that as few
// chunks as 256 columns each allow (a thread holds COLS / 2 floats of O);
// the last chunk may run past d. The backward pair's blocks take the same
// chunks of their gradients' columns (dK/dV's at most DKV_WIDEST). Where
// that leaves fewer blocks than FILL, half as many columns, down to 64:
// each block still builds all of S for its rows, so c chunks cost (c + 1)
// / 2 of the minimum FLOPs, but c blocks share the P V products of a row
// block, and the card, which the row blocks alone leave idle (bh 4, seq
// 256: 8 blocks on 132 SMs), fills. (Chunks of 192 columns, which d 192,
// 320, 384 and 576 would take at one width, spilled 16 bytes of registers
// in ptxas, so the widths are powers of two.)
__host__ __device__ constexpr int cols(int d, long blocks,
                                       int widest = 256) {
  int w = CHUNK;
  while (w < d && w < widest) w *= 2;
  while (w > 64 && blocks * ((d + w - 1) / w) < FILL) w /= 2;
  return w;
}

// Ring A's slots at COLS of O's columns: as many as fit beside ring B.
__host__ __device__ constexpr int stages(int cols) {
  return cols > 128 ? STAGES - 1 : STAGES;
}
// Shared memory of a block owning COLS of O's columns: ring A's slots (a
// chunk of Q's rows, one of the tile's keys and its small parts), ring B's
// (V's [TILE x COLS] tiles), a full, a ready and an empty mbarrier a slot
// of A, a full and an empty one a slot of B, and the swizzle's alignment.
// (ray_tpu_torch/ops/attention.py's kernel_smem_bytes mirrors it.)
__host__ __device__ constexpr int smem(int cols) {
  return stages(cols) * (ROWS + 2 * TILE) * CHUNK * 4 +
         V_STAGES * TILE * cols * 4 + (3 * stages(cols) + 2 * V_STAGES) * 8 +
         sm90::SMEM_ALIGN;
}

// x = big + small for mma's TF32 operands, which read the 19 high bits of
// a register (sign, exponent, 10 mantissa bits) and drop the 13 low ones:
// big is x itself, read as x truncated, and small = x - that truncation
// (exact in float32), read truncated in turn. big + small then misses x by
// at most 2^-20 of it, and the three products miss x y by about 2^-21
// where one TF32 pass misses it by 2^-10; with big and small rounded to
// nearest (cvt.rna.tf32.f32 before each), K1's first version (every
// product on mma.sync) took 1.13-1.23x as long on an H100 at the same
// accuracy (PERF.md). Two instructions an operand.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x);
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// d[16 x 8] += A[16 x 8] B[8 x 8] on the tensor cores in TF32, lane =
// 4 g + t: a = A(g, t), A(g + 8, t), A(g, t + 4), A(g + 8, t + 4); b0 =
// B(t, g), b1 = B(t + 4, g); d in the accumulator layout above.
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The same in 3xTF32, from the split operands: the two correction products
// first, then big * big, so that the small terms are summed before the
// large one joins them (small * small, under 2^-20 of the product, is
// dropped).
__device__ __forceinline__ void mma3(float* d, const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma(d, as, bb[0], bb[1]);
  mma(d, ab, bs[0], bs[1]);
  mma(d, ab, bb[0], bb[1]);
}

// x - x truncated to TF32: the small part of split(x), as a float.
__device__ __forceinline__ float small_part(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// x rounded to nearest TF32 (cvt.rna.tf32.f32), as a float.
__device__ __forceinline__ float round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}
// x = big + small with both parts rounded to nearest, where split truncates
// them: big + small misses x by at most 2^-23 of it (2^-20 for split), for
// one more instruction an operand. dQ's dP takes it (score_chunk says
// why).
__device__ __forceinline__ void split_rn(float x, uint32_t& big,
                                         uint32_t& small) {
  const float b = round_tf32(x);
  big = __float_as_uint(b);
  small = __float_as_uint(round_tf32(x - b));
}

// Make this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x 64] += A[64 x 8] B[8 x 64] on wgmma in TF32: A in registers (each
// warp's 16 rows as mma's A fragment above), B K-major in shared memory
// (the tile's 64 rows, a 128-byte swizzled row of 32 floats each), read
// truncated to TF32 as mma reads its operands.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The float32 backward pair (bwd_dq_kernel_tf32 and bwd_dkv_kernel_tf32 in
// flash_bwd.cu), d at run time at every float32 head dim, on the forward's
// pieces. A block owns ROWS rows (queries for dQ, keys for dK/dV), 16 a
// warp and 64 a consumer warpgroup, and one chunk of COLS of its
// gradients' columns; it streams tiles of TILE rows (keys; queries). Each
// warpgroup builds both score tiles of its own rows: dP (dP^T for dK/dV)
// over all d in a first pass through ring A, then S (S^T) in a second,
// one 32-column chunk of the owned rows (dO, then Q; V, then K) and one of
// the streamed rows (V, then K; dO, then Q) with the latter's small parts
// a slot, as the forward's ring A holds Q and K. dP waits for S in the
// thread's share of a shared-memory buffer (PBUF_BYTES), P and dS form in
// registers, and the products that contract over the streamed rows (dS K;
// P^T dO and dS^T Q) take the tile's columns of the block's chunk from
// ring B: K's for dQ, Q's and dO's (with the tile's lse and delta) for
// dK/dV. Why this shape:
// - registers: a consumer thread holds its gradient chunk (dQ's COLS / 2
//   floats; dK's and dV's COLS / 2 each), 32 floats of a score tile and
//   the split A fragments of a chunk (32), as the forward holds O, S and
//   Q's fragments; S and dP both in registers at once would add 32 more,
//   so dP waits in shared memory, and so do dQ's rows' lse and delta. A
//   chunk of a score tile's products sums on the tensor cores from 0 into
//   32 more floats (score_chunk). dQ's chunks go up to DQ_WIDEST = 128
//   columns (64 floats; at 256, with dP's operands split to nearest,
//   ptxas spilled 24 bytes) and dK/dV's up to DKV_WIDEST = 128 (64 + 64).
// - dK/dV's warpgroups own 64 keys each, as dQ's own 64 queries, rather
//   than sharing 64 keys (one on dK, one on dV, as the 16-bit bodies from
//   d 192 up): each streamed tile then serves 128 keys, so ring A and B
//   carry half the bytes a key, the two kernels share one pass structure,
//   and ring B's [64 x 2 COLS] tile of Q's and dO's columns fits beside
//   ring A (at COLS 256 two slots of 64 KB each would not).
// - shared memory: 4 slots of ring A (32 KB each), ring B's slots (one
//   where a slot holds more than 128 columns, else two), the P buffer (32
//   KB), the lse and delta, and the barriers: at most 232,064 bytes
//   (dK/dV at COLS 64), and no block grows with d.
// - the sums: no sum runs over all d or all the streamed rows on the
//   tensor cores, whose accumulator truncates as it adds (the forward's
//   pv): a chunk's share of S or dP, and a streamed tile's share of a
//   gradient, are summed there from 0 and added in float32 (score_chunk,
//   col_product).
// - accuracy: where dS = P (dP - delta) is 0 in exact arithmetic (a causal
//   row's first key), dQ holds dP's error whole, so dQ's dP splits its
//   operands to nearest and delta is summed in double (score_chunk).
// With c chunks S and dP are built c times: dQ does (2c + 1) / 3 of the
// minimum FLOPs and dK/dV (c + 1) / 2.
constexpr int BWD_STAGES = 4;
constexpr int DQ_WIDEST = 128, DKV_WIDEST = 128;
constexpr int PBUF_BYTES = WARPS * 32 * (TILE / 2) * 4;  // 32 floats a thread
// dK/dV's lse and delta of a streamed tile come by TMA from a one-
// dimensional map. A box must start on a 16-byte boundary of the vector
// and land on a 128-byte boundary of shared memory (either fault stops the
// kernel on an H100): STAT = TILE + 4 elements from the aligned element at
// or before the tile's first cover the tile, and each lies STAT_LD floats
// (384 bytes) after the last.
constexpr int STAT = TILE + 4, STAT_LD = 96;
constexpr int SMEM_LIMIT = 232448;  // bytes one block may opt in to
// Ring B's slots when a slot holds b_cols columns of the streamed rows
// (dQ: COLS of K; dK/dV: COLS of Q and COLS of dO).
__host__ __device__ constexpr int bwd_b_stages(int b_cols) {
  return b_cols > 128 ? 1 : 2;
}
// Shared memory of a backward block whose ring B holds b_cols columns a
// slot: ring A's slots (a chunk of the owned rows, one of the streamed rows
// and its small parts each), ring B's, the P buffer, the rows' lse and
// delta (dQ: the owned rows', once; dK/dV: the tile's, in each slot of B),
// a full, a ready and an empty mbarrier a slot of A, a full and an empty
// one a slot of B, and the swizzle's alignment. (ray_tpu_torch/ops/
// attention.py's kernel_smem_bytes mirrors it.)
__host__ __device__ constexpr int bwd_smem(int b_cols, bool dkv) {
  return BWD_STAGES * (ROWS + 2 * TILE) * CHUNK * 4 +
         bwd_b_stages(b_cols) * TILE * b_cols * 4 + PBUF_BYTES +
         (dkv ? bwd_b_stages(b_cols) * STAT_LD : ROWS) * 2 * 4 +
         (3 * BWD_STAGES + 2 * bwd_b_stages(b_cols)) * 8 + sm90::SMEM_ALIGN;
}
static_assert(bwd_smem(DQ_WIDEST, false) <= SMEM_LIMIT &&
                  bwd_smem(DQ_WIDEST / 2, false) <= SMEM_LIMIT,
              "dQ's blocks fit");
static_assert(bwd_smem(2 * DKV_WIDEST, true) <= SMEM_LIMIT &&
                  bwd_smem(DKV_WIDEST, true) <= SMEM_LIMIT,
              "dK/dV's blocks fit");

// The converters' share of one slot of the backward pair's ring A (thread
// ct of the three warps): the small part of each element of the slot's
// chunk of streamed rows, written beside it in the same swizzled layout,
// for the correction product big(A) small(B); with `nearest`, the element
// rounded to nearest TF32 in place and the small part of that (split_rn).
__device__ __forceinline__ void write_small_parts(uint8_t* slot, int ct,
                                                  bool nearest) {
  float* br = reinterpret_cast<float*>(slot + ROWS * CHUNK * 4);
  for (int e = ct; e < TILE * CHUNK; e += CONVERTERS * 32) {
    const float x = br[e];
    if (nearest) {
      const float big = round_tf32(x);
      br[e] = big;
      br[TILE * CHUNK + e] = round_tf32(x - big);
    } else {
      br[TILE * CHUNK + e] = small_part(x);
    }
  }
  fence_async_smem();
}

// sc += A B^T from one slot of the backward pair's ring A, on wgmma: A is
// this warp's 16 rows (warp 16 ..) of the slot's [ROWS x 32] chunk, split
// in registers; B is the slot's [TILE x 32] chunk as TMA wrote it (read
// truncated: its big part) and its small parts beside it, both K-major.
// The chunk's 12 products sum from 0 on the tensor cores, the 8 correction
// products before the 4 big * big ones, and are then added to sc in
// float32: the accumulator truncates as it adds, by up to an ulp of what
// it holds, so no sum over all d stays on it (the forward's pv says the
// same of O), and small terms added after a big one would each cost such
// an ulp. NEAREST splits A to nearest (split_rn; the converters wrote B
// so), for dQ's dP: where dS = P (dP - delta) is 0 in exact arithmetic, at
// a causal row's first key, dQ holds dP's error whole, and with both
// operands truncated (2^-20 of each) that row of dQ broke the 5e-4 limit
// at d 704, seq 2048, on an H100.
// This lane's columns of its rows lie at (g << 2) | t in the swizzled rows
// (the forward's s_chunk says how); that offset is made opaque here, so
// that the offsets built from it are not hoisted into registers of their
// own.
template <bool NEAREST>
__device__ __forceinline__ void score_chunk(float (&sc)[TILE / 2],
                                            const uint8_t* slot, int warp,
                                            int g, int t) {
  const float* as_rows =
      reinterpret_cast<const float*>(slot) + warp * 16 * CHUNK;
  const int x = sm90::opaque((g << 2) | t);
  uint32_t ab[CHUNK / 8][4], as[CHUNK / 8][4];
  auto split_a = [](float v, uint32_t& big, uint32_t& small) {
    if constexpr (NEAREST)
      split_rn(v, big, small);
    else
      split(v, big, small);
  };
#pragma unroll
  for (int kk = 0; kk < CHUNK / 8; ++kk) {  // columns 8 kk .. 8 kk + 7
    const int c0 = (8 * kk) ^ x, c1 = (8 * kk + 4) ^ x;  // 8 kk + t, + 4
    split_a(as_rows[g * CHUNK + c0], ab[kk][0], as[kk][0]);
    split_a(as_rows[(g + 8) * CHUNK + c0], ab[kk][1], as[kk][1]);
    split_a(as_rows[g * CHUNK + c1], ab[kk][2], as[kk][2]);
    split_a(as_rows[(g + 8) * CHUNK + c1], ab[kk][3], as[kk][3]);
  }
  const uint64_t bd =
      sm90::k_major<TILE, 64>(sm90::smem_u32(slot + ROWS * CHUNK * 4), 0);
  const uint64_t bsd = bd + ((TILE * CHUNK * 4) >> 4);  // the small parts
  float part[TILE / 2];
#pragma unroll
  for (int i = 0; i < TILE / 2; ++i) part[i] = 0.f;
  sm90::fence_regs(part);
  sm90::wg_fence();
#pragma unroll
  for (int kk = 0; kk < CHUNK / 8; ++kk) {
    wgmma_rs(part, as[kk], sm90::k_major_at<TILE, 64>(bd, kk));
    wgmma_rs(part, ab[kk], sm90::k_major_at<TILE, 64>(bsd, kk));
  }
#pragma unroll
  for (int kk = 0; kk < CHUNK / 8; ++kk)
    wgmma_rs(part, ab[kk], sm90::k_major_at<TILE, 64>(bd, kk));
  sm90::wg_commit();
  sm90::wg_wait<0>();
  sm90::fence_regs(part);
#pragma unroll
  for (int i = 0; i < TILE / 2; ++i) sc[i] += part[i];
}

// acc += X B for this warp's 16 rows, on mma.sync: X is a [16 x TILE] tile
// in the accumulator layout (P, dS; P^T, dS^T), whose columns are the
// streamed rows, and B ring B's [TILE x COLS] tile of the block's
// columns, 32-column boxes of 128-byte swizzled rows as TMA wrote them;
// boxes from `nbox` on were not loaded (they feed only columns past d) and
// are skipped. A lane holds X's columns 2t and 2t + 1 where the A fragment
// wants t and t + 4, so each 8 streamed rows are taken in that order (row
// 2t as k = t, 2t + 1 as k = t + 4) and this lane's B fragment is B's rows
// 2t and 2t + 1: no shuffle (the forward's pv says where a column lies in
// a swizzled row). Each box's products sum from 0 over the tile, 24
// products, and are then added to acc in float32.
template <int COLS>
__device__ __forceinline__ void col_product(float (&acc)[COLS / 2],
                                            const float (&x)[TILE / 2],
                                            const uint8_t* tile, int nbox,
                                            int g, int t) {
  const float* bs_rows = reinterpret_cast<const float*>(tile) + 2 * t * CHUNK;
  const int tg = sm90::opaque((t << 3) | g);
#pragma unroll
  for (int box = 0; box < COLS / CHUNK; ++box) {
    if (box >= nbox) break;
    float part[CHUNK / 2];
#pragma unroll
    for (int e = 0; e < CHUNK / 2; ++e) part[e] = 0.f;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {  // streamed rows 8 j .. 8 j + 7
      uint32_t ab[4], as[4];
      split(x[4 * j], ab[0], as[0]);      // row g,     streamed row 2t
      split(x[4 * j + 2], ab[1], as[1]);  // row g + 8, streamed row 2t
      split(x[4 * j + 1], ab[2], as[2]);  // row g,     streamed row 2t + 1
      split(x[4 * j + 3], ab[3], as[3]);  // row g + 8, streamed row 2t + 1
      const float* b0 = bs_rows + (box * TILE + 8 * j) * CHUNK;  // row 8 j + 2t
#pragma unroll
      for (int n = 0; n < CHUNK / 8; ++n) {  // the box's columns 8 n ..
        const int e = (n << 3) ^ tg;
        uint32_t bb[2], bs[2];
        split(b0[e], bb[0], bs[0]);
        split(b0[CHUNK + (e ^ 4)], bb[1], bs[1]);
        mma3(&part[4 * n], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int e = 0; e < CHUNK / 2; ++e) acc[box * (CHUNK / 2) + e] += part[e];
  }
}

}  // namespace tf32
}  // namespace flash

// The C entry points take dtype 0 = float32, 1 = bfloat16, 2 = float16,
// and a head dimension of 32, 64, 128, 192 or 256, or a multiple of 64
// above 256 (ray_tpu_torch/ops/attention.py caps it: WIDE_MAX_D); anything
// else returns FLASH_ERR_UNSUPPORTED. Each shared library built from a
// source that includes this header exports its own copy.
extern "C" const char* flash_error_string(int code) {
  if (code == FLASH_ERR_UNSUPPORTED)
    return "unsupported dtype or head dimension";
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
// The same above 256 (wide_head_dim): calls `fn<T>(args...)`, d among the
// args.
#define FLASH_DISPATCH_WIDE(fn, dtype, ...)                                \
  do {                                                                     \
    if (dtype == 0) return fn<float>(__VA_ARGS__);                         \
    if (dtype == 1) return fn<__nv_bfloat16>(__VA_ARGS__);                 \
    if (dtype == 2) return fn<__half>(__VA_ARGS__);                        \
    return FLASH_ERR_UNSUPPORTED;                                          \
  } while (0)

namespace flash {
// Whether the instance <T, D> of a kernel runs a Hopper body (sm90) or a
// float32 one (tf32): every kernel takes the 16-bit types up to D 256 on a
// body of its own (above, the 16-bit kernels run the *_sm90_wide bodies,
// d at run time); in float32 each runs its 3xTF32 body, d at run time, at
// every head dim.
template <typename T, int D>
constexpr bool hopper_body() {
  return sizeof(T) == 2 && D <= 256;
}
// The head dims above 256 (multiples of 64) that the entry points pass on
// with d at run time: the 16-bit *_sm90_wide bodies and the float32 ones.
__host__ __device__ constexpr bool wide_head_dim(int d) {
  return d > 256 && d % 64 == 0;
}
}  // namespace flash
