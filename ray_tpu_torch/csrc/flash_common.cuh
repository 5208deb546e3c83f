// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout: q, k, v, o and their gradients are [bh, seq, D] row-major and
// contiguous; lse and delta are [bh, seq] float32. Inputs are bf16 or
// float32; every product accumulates in float32.
//
// Tiles are BLOCK x D with BLOCK = 64 rows. A block runs 4 warps and each
// warp owns 16 rows of the tile it produces. Every operand of a tile product
// is read from shared memory by `warp_gemm`: for bf16 it feeds
// mma.sync.m16n8k16 (tensor cores, float32 accumulate); for float32 it runs
// the same 16x8 accumulator layout on the CUDA cores in full float32, so one
// kernel body serves both types and the float32 instance stays exact enough
// to hold against the plain PyTorch version at 1e-4.
//
// Accumulator layout (the mma.sync C fragment), lane = 4 * g + t:
//   c[0], c[1] -> row g,     cols 2t, 2t+1 of the 8-wide tile
//   c[2], c[3] -> row g + 8, cols 2t, 2t+1

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr int BLOCK = 64;          // rows of every tile (queries or keys)
constexpr int WARPS = 4;           // 16 rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;  // mask fill, as in the TPU kernels

// Shared-memory row stride in elements: 16 bytes of padding per row keeps
// the fragment loads below free of bank conflicts.
template <typename T, int D>
__host__ __device__ constexpr int ld() { return D + 16 / (int)sizeof(T); }

// Copy rows [row0, row0 + BLOCK) of a [seq, D] matrix into shared memory
// with 16-byte vectors; rows at or past `seq` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int seq) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < BLOCK * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld<T, D>() + c) = val;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: C[16 x 8*NT] += A[16 x K] * B[K x 8*NT].
// A is row-major in shared memory (A(m, k) = A[m * lda + k]).
// B_NK: B(k, n) = B[n * ldb + k] (B stored as N x K, e.g. K for Q.K^T);
// otherwise B(k, n) = B[k * ldb + n] (stored as K x N, e.g. V for P.V).
template <typename T, bool B_NK, int NT, int K>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4], const T* A,
                                          int lda, const T* B, int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      a[0] = ld_u32(A + g * lda + k0 + 2 * t);
      a[1] = ld_u32(A + (g + 8) * lda + k0 + 2 * t);
      a[2] = ld_u32(A + g * lda + k0 + 8 + 2 * t);
      a[3] = ld_u32(A + (g + 8) * lda + k0 + 8 + 2 * t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + g;
        uint32_t b0, b1;
        if constexpr (B_NK) {
          b0 = ld_u32(B + n * ldb + k0 + 2 * t);
          b1 = ld_u32(B + n * ldb + k0 + 8 + 2 * t);
        } else {
          b0 = pack_bf16(B[(k0 + 2 * t) * ldb + n], B[(k0 + 2 * t + 1) * ldb + n]);
          b1 = pack_bf16(B[(k0 + 8 + 2 * t) * ldb + n],
                         B[(k0 + 9 + 2 * t) * ldb + n]);
        }
        mma_bf16(c[nt], a, b0, b1);
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + 2 * t;
        const float b0 = B_NK ? B[n * ldb + k] : B[k * ldb + n];
        const float b1 = B_NK ? B[(n + 1) * ldb + k] : B[k * ldb + n + 1];
        c[nt][0] = fmaf(a0, b0, c[nt][0]);
        c[nt][1] = fmaf(a0, b1, c[nt][1]);
        c[nt][2] = fmaf(a1, b0, c[nt][2]);
        c[nt][3] = fmaf(a1, b1, c[nt][3]);
      }
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
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace flash

// The C entry points take dtype 0 = float32, 1 = bfloat16, and a head
// dimension of 32, 64 or 128; anything else returns this code.
#define FLASH_ERR_UNSUPPORTED 1000

// Each shared library built from a source that includes this header exports
// its own copy.
extern "C" const char* flash_error_string(int code) {
  if (code == FLASH_ERR_UNSUPPORTED)
    return "unsupported dtype or head dimension";
  return cudaGetErrorString((cudaError_t)code);
}

// Expands to the body of a C entry point: calls `fn<T, D>(args...)` for the
// requested dtype and head dimension.
#define FLASH_DISPATCH(fn, dtype, d, ...)                                  \
  do {                                                                     \
    if (dtype == 1) {                                                      \
      if (d == 32) return fn<__nv_bfloat16, 32>(__VA_ARGS__);              \
      if (d == 64) return fn<__nv_bfloat16, 64>(__VA_ARGS__);              \
      if (d == 128) return fn<__nv_bfloat16, 128>(__VA_ARGS__);            \
    } else if (dtype == 0) {                                               \
      if (d == 32) return fn<float, 32>(__VA_ARGS__);                      \
      if (d == 64) return fn<float, 64>(__VA_ARGS__);                      \
      if (d == 128) return fn<float, 128>(__VA_ARGS__);                    \
    }                                                                      \
    return FLASH_ERR_UNSUPPORTED;                                          \
  } while (0)
