// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_fwd_kernel (launched by
// _flash_forward): blocked online-softmax attention that never writes the
// seq x seq score matrix to device memory and saves the row logsumexp for
// the backward kernels.
//
// Bound on an H100: at GPT-2-small's shape (bh = 288, seq = 1024, d = 64,
// bf16, causal) the kernel must read q, k, v and write o and lse once,
// about 151 MB (45 us at 3.35 TB/s), and do 4 * bh * d * seq * (seq + 1) / 2
// FLOPs, about 39 GFLOP (39 us at 989 TFLOP/s bf16 dense): it sits near the
// ridge, bound by bytes at d = 64.
//
// Design: one block of 4 warps per 64 query rows; the TPU grid's sequential
// k dimension is the loop inside the block. Each 64-row K and V tile is
// read from device memory once per q-block into shared memory and used by
// all four warps; scores, probabilities and the running max, sum and
// output accumulator never leave the SM (registers, plus one copy of the
// warp's probabilities in shared memory, in the input type, to feed the P.V
// product). The bf16 products run on the tensor cores through mma.sync with
// float32 accumulation. Causal blocks above the diagonal are skipped, and
// q-blocks are issued heaviest first. Not yet used: wgmma, TMA, a pipelined
// ring of tiles and warp specialisation.

#include "flash_common.cuh"

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int sq, int sk, int causal, float scale) {
  constexpr int LD = ld<T, D>();
  constexpr int LDP = ld<T, BLOCK>();
  constexpr int NTD = D / 8;      // accumulator tiles across the head dim
  constexpr int NTK = BLOCK / 8;  // accumulator tiles across a key block
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BLOCK * LD;
  T* Vs = Ks + BLOCK * LD;
  T* Ps = Vs + BLOCK * LD;  // [BLOCK][LDP]: each warp its own 16 rows

  // One block per (bh, q-block); the q-blocks of one bh are neighbours, so
  // they share its K/V tiles in L2, and the last one, with the most causal
  // work, is issued first.
  const int nqb = (sq + BLOCK - 1) / BLOCK;
  const int bh = blockIdx.x / nqb;
  const int q0 = (nqb - 1 - blockIdx.x % nqb) * BLOCK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  o += (size_t)bh * sq * D;
  lse += (size_t)bh * sq;

  load_tile<T, D>(Qs, q, q0, sq);
  const int w0 = q0 + warp * 16;  // this warp's first query row
  const int rows[2] = {w0 + g, w0 + g + 8};
  const T* Qw = Qs + warp * 16 * LD;
  T* Pw = Ps + warp * 16 * LDP;

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NTD][4];
  zero(acc);

  int nkb = (sk + BLOCK - 1) / BLOCK;
  if (causal) nkb = min(nkb, (q0 + BLOCK - 1) / BLOCK + 1);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BLOCK;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<T, D>(Ks, k, k0, sk);
    load_tile<T, D>(Vs, v, k0, sk);
    __syncthreads();

    float s[NTK][4];
    zero(s);
    warp_gemm<T, true, NTK, D>(s, Qw, LD, Ks, LD);  // S = Q K^T

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1), r = rows[e >> 1];
        const bool ok = col < sk && (!causal || col <= r);
        s[nt][e] = ok ? s[nt][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = corr[i] * l[i] + quad_sum(sum[i]);
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }
    store_acc<T>(Pw, LDP, s, 16);
    __syncwarp();
    warp_gemm<T, false, NTD, BLOCK>(acc, Pw, LDP, Vs, LD);  // O += P V
    __syncwarp();  // P is read by all lanes before the next write
  }

  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) den[i] = fmaxf(l[i], 1e-30f);
#pragma unroll
  for (int nt = 0; nt < NTD; ++nt) {
    acc[nt][0] /= den[0];
    acc[nt][1] /= den[0];
    acc[nt][2] /= den[1];
    acc[nt][3] /= den[1];
  }
  store_acc<T>(o + (size_t)w0 * D, D, acc, sq - w0);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < sq) lse[rows[i]] = m[i] + logf(den[i]);
  }
}

template <typename T, int D>
static int fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int sq, int sk, int causal, float scale,
               cudaStream_t stream) {
  const size_t smem =
      (3 * BLOCK * ld<T, D>() + BLOCK * ld<T, BLOCK>()) * sizeof(T);
  const dim3 grid(bh * ((sq + BLOCK - 1) / BLOCK));
  return launch(fwd_kernel<T, D>, grid, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o),
                static_cast<float*>(lse), sq, sk, causal, scale);
}

// q [bh, sq, d], k and v [bh, sk, d] -> o [bh, sq, d], lse [bh, sq] float32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int sq, int sk, int d,
                         int causal, float scale, int dtype, void* stream) {
  FLASH_DISPATCH(fwd, dtype, d, q, k, v, o, lse, bh, sq, sk, causal, scale,
                 static_cast<cudaStream_t>(stream));
}
