// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel.
//
// Replace the TPU kernels ray_tpu/ops/attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (launched by _flash_backward). Both recompute the
// probabilities p = exp(s - lse) from the forward's row logsumexp, so
// neither the scores nor the probabilities are ever written to device
// memory; delta = rowsum(dO * O) is an input, computed before the launch.
//
// Bounds on an H100 at GPT-2-small's shape (bh = 288, seq = 1024, d = 64,
// bf16, causal), with one causal product costing 2 * bh * d * seq*(seq+1)/2
// FLOPs (about 19 GFLOP):
//   dQ:    3 products, about 58 GFLOP (59 us at 989 TFLOP/s); reads q, k, v,
//          dO, lse, delta and writes dQ once, about 191 MB (57 us at
//          3.35 TB/s): bound by operations.
//   dK/dV: 4 products, about 77 GFLOP (78 us); about 229 MB (68 us): bound
//          by operations.
//
// Design: the TPU grid's sequential dimension becomes a loop inside the
// block, so nothing is carried between blocks and no atomics are needed.
// The dQ kernel holds 64 query rows (4 warps of 16) and streams K/V tiles
// up to the diagonal; the dK/dV kernel holds 64 key rows and streams Q/dO
// tiles from the diagonal down, computing the transposed products
// (S^T = K Q^T, dP^T = V dO^T) so that each warp's rows are its own keys and
// dK, dV accumulate in registers. Every tile is read from device memory
// once per block into shared memory and shared by four warps; the bf16
// products run on the tensor cores through mma.sync with float32
// accumulation, and dS goes through shared memory in the input type to
// feed the next product. Not yet used: wgmma, TMA, pipelining, and a single
// fused kernel that would share the recomputed probabilities between dQ and
// dK/dV.

#include "flash_common.cuh"

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int sq, int sk, int causal, float scale) {
  constexpr int LD = ld<T, D>();
  constexpr int LDP = ld<T, BLOCK>();
  constexpr int NTD = D / 8;
  constexpr int NTK = BLOCK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BLOCK * LD;
  T* Ks = dOs + BLOCK * LD;
  T* Vs = Ks + BLOCK * LD;
  T* Ss = Vs + BLOCK * LD;  // [BLOCK][LDP]: dS, each warp its own 16 rows

  const int nqb = (sq + BLOCK - 1) / BLOCK;  // grid as in flash_fwd.cu
  const int bh = blockIdx.x / nqb;
  const int q0 = (nqb - 1 - blockIdx.x % nqb) * BLOCK;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  dq += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;

  load_tile<T, D>(Qs, q, q0, sq);
  load_tile<T, D>(dOs, dout, q0, sq);
  const int w0 = q0 + warp * 16;
  const int rows[2] = {w0 + g, w0 + g + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_lse[i] = rows[i] < sq ? lse[rows[i]] : 0.f;
    row_delta[i] = rows[i] < sq ? delta[rows[i]] : 0.f;
  }
  const T* Qw = Qs + warp * 16 * LD;
  const T* dOw = dOs + warp * 16 * LD;
  T* Sw = Ss + warp * 16 * LDP;

  float acc[NTD][4];
  zero(acc);
  int nkb = (sk + BLOCK - 1) / BLOCK;
  if (causal) nkb = min(nkb, (q0 + BLOCK - 1) / BLOCK + 1);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BLOCK;
    __syncthreads();
    load_tile<T, D>(Ks, k, k0, sk);
    load_tile<T, D>(Vs, v, k0, sk);
    __syncthreads();

    float s[NTK][4], dp[NTK][4];
    zero(s);
    zero(dp);
    warp_gemm<T, true, NTK, D>(s, Qw, LD, Ks, LD);    // S = Q K^T
    warp_gemm<T, true, NTK, D>(dp, dOw, LD, Vs, LD);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1), i = e >> 1;
        const bool ok =
            rows[i] < sq && col < sk && (!causal || col <= rows[i]);
        const float p = ok ? expf(s[nt][e] * scale - row_lse[i]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - row_delta[i]) * scale;  // dS
      }
    store_acc<T>(Sw, LDP, s, 16);
    __syncwarp();
    warp_gemm<T, false, NTD, BLOCK>(acc, Sw, LDP, Ks, LD);  // dQ += dS K
    __syncwarp();
  }
  store_acc<T>(dq + (size_t)w0 * D, D, acc, sq - w0);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
               int causal, float scale) {
  constexpr int LD = ld<T, D>();
  constexpr int LDP = ld<T, BLOCK>();
  constexpr int NTD = D / 8;
  constexpr int NTQ = BLOCK / 8;  // accumulator tiles across a query block
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BLOCK * LD;
  T* Qs = Vs + BLOCK * LD;
  T* dOs = Qs + BLOCK * LD;
  T* Ps = dOs + BLOCK * LD;  // [BLOCK][LDP]: P^T then dS^T, per warp
  float* lse_s = reinterpret_cast<float*>(Ps + BLOCK * LDP);
  float* delta_s = lse_s + BLOCK;

  const int nkb = (sk + BLOCK - 1) / BLOCK;
  const int bh = blockIdx.x / nkb;
  const int k0 = (blockIdx.x % nkb) * BLOCK;  // low k-blocks: most work
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  dk += (size_t)bh * sk * D;
  dv += (size_t)bh * sk * D;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;

  load_tile<T, D>(Ks, k, k0, sk);
  load_tile<T, D>(Vs, v, k0, sk);
  const int w0 = k0 + warp * 16;  // this warp's first key row
  const int keys[2] = {w0 + g, w0 + g + 8};
  const T* Kw = Ks + warp * 16 * LD;
  const T* Vw = Vs + warp * 16 * LD;
  T* Pw = Ps + warp * 16 * LDP;

  float dk_acc[NTD][4], dv_acc[NTD][4];
  zero(dk_acc);
  zero(dv_acc);
  const int nqb = (sq + BLOCK - 1) / BLOCK;
  // Causal: q-blocks that end before this block's first key add nothing.
  for (int qb = causal ? k0 / BLOCK : 0; qb < nqb; ++qb) {
    const int q0 = qb * BLOCK;
    __syncthreads();
    load_tile<T, D>(Qs, q, q0, sq);
    load_tile<T, D>(dOs, dout, q0, sq);
    for (int i = threadIdx.x; i < BLOCK; i += THREADS) {
      lse_s[i] = q0 + i < sq ? lse[q0 + i] : 0.f;
      delta_s[i] = q0 + i < sq ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    float s[NTQ][4], dp[NTQ][4];
    zero(s);
    zero(dp);
    warp_gemm<T, true, NTQ, D>(s, Kw, LD, Qs, LD);    // S^T = K Q^T
    warp_gemm<T, true, NTQ, D>(dp, Vw, LD, dOs, LD);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < NTQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1), col = q0 + c;
        const int key = keys[e >> 1];
        const bool ok = col < sq && key < sk && (!causal || key <= col);
        s[nt][e] = ok ? expf(s[nt][e] * scale - lse_s[c]) : 0.f;  // P^T
        dp[nt][e] = s[nt][e] * (dp[nt][e] - delta_s[c]) * scale;   // dS^T
      }
    store_acc<T>(Pw, LDP, s, 16);
    __syncwarp();
    warp_gemm<T, false, NTD, BLOCK>(dv_acc, Pw, LDP, dOs, LD);  // dV += P^T dO
    __syncwarp();
    store_acc<T>(Pw, LDP, dp, 16);
    __syncwarp();
    warp_gemm<T, false, NTD, BLOCK>(dk_acc, Pw, LDP, Qs, LD);  // dK += dS^T Q
    __syncwarp();
  }
  store_acc<T>(dk + (size_t)w0 * D, D, dk_acc, sk - w0);
  store_acc<T>(dv + (size_t)w0 * D, D, dv_acc, sk - w0);
}

template <typename T, int D>
static int bwd_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int bh, int sq, int sk, int causal, float scale,
                  cudaStream_t stream) {
  const size_t smem =
      (4 * BLOCK * ld<T, D>() + BLOCK * ld<T, BLOCK>()) * sizeof(T);
  const dim3 grid(bh * ((sq + BLOCK - 1) / BLOCK));
  return launch(bwd_dq_kernel<T, D>, grid, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), sq, sk,
                causal, scale);
}

template <typename T, int D>
static int bwd_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int bh, int sq, int sk, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      (4 * BLOCK * ld<T, D>() + BLOCK * ld<T, BLOCK>()) * sizeof(T) +
      2 * BLOCK * sizeof(float);
  const dim3 grid(bh * ((sk + BLOCK - 1) / BLOCK));
  return launch(bwd_dkv_kernel<T, D>, grid, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk),
                static_cast<T*>(dv), sq, sk, causal, scale);
}

// q, dout [bh, sq, d]; k, v [bh, sk, d]; lse, delta [bh, sq] float32
// -> dq [bh, sq, d].
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int sq,
                            int sk, int d, int causal, float scale, int dtype,
                            void* stream) {
  FLASH_DISPATCH(bwd_dq, dtype, d, q, k, v, dout, lse, delta, dq, bh, sq, sk,
                 causal, scale, static_cast<cudaStream_t>(stream));
}

// Same inputs -> dk, dv [bh, sk, d].
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int sq, int sk, int d, int causal, float scale,
                             int dtype, void* stream) {
  FLASH_DISPATCH(bwd_dkv, dtype, d, q, k, v, dout, lse, delta, dk, dv, bh, sq,
                 sk, causal, scale, static_cast<cudaStream_t>(stream));
}
