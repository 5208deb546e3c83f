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
// Two bodies, chosen by type and head dim:
//
// bf16 and float16 at d <= 128 (fwd_kernel_sm90): one block per 128 query
// rows, two consumer
// warpgroups of 64 rows and a producer warpgroup. Its first warp loads the Q
// tile once and streams K and V tiles through a ring of shared-memory slots
// with TMA, ordered by full/empty mbarriers, so the next tiles are in flight
// while the current ones are multiplied. Each warpgroup computes S = Q K^T
// on wgmma from shared memory, runs the online softmax on the accumulator in
// base 2 (scale * log2 e folded into one multiply-add before ex2), converts
// P to 16-bit A fragments in registers and adds P V with a register-A wgmma
// that reads V MN-major (transposed) from shared memory: P never leaves the
// registers. At d = 64 the ex2 unit is as busy as the tensor cores (one
// exponential per 4 d flops), so the two warpgroups take turns: one runs its
// products while the other runs its softmax. lse is written in natural-log
// units, as the dQ kernel reads it.
//
// float32, and 16-bit at d 192 and 256 (fwd_kernel): on the CUDA cores, in
// float32 arithmetic (flash_common.cuh says why): 64 query rows, 4 warps of
// 16 rows, K and V tiles of PlainTiles<D>::STREAM rows copied into shared
// memory between two barriers, P through shared memory in the input type.
//
// Every type at d > 256, a multiple of 64 (fwd_kernel_wide): on the CUDA
// cores in float32, d a run-time argument. 16 query rows a block, K and V
// tiles of 16 rows; the 8 lanes of each query row compute two scores each
// and run that row's online softmax with shuffles, P (float32) and the
// D-wide O accumulator stay in shared memory, and each thread adds P V
// into its own columns of O with V's column in registers.
//
// All skip causal tiles above the diagonal, mask only the tiles that cross
// it or the end of the sequence, and issue the heaviest q-blocks first.

#include "flash_common.cuh"

using namespace flash;

// The CUDA-core body.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int sq, int sk, int causal, float scale) {
  constexpr int BS = PlainTiles<D>::STREAM;  // keys a streamed tile
  constexpr int LD = ld<T, D>();
  constexpr int LDP = ld<T, BS>();
  constexpr int NTD = D / 8;   // accumulator tiles across the head dim
  constexpr int NTK = BS / 8;  // accumulator tiles across a key tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BLOCK * LD;
  T* Vs = Ks + BS * LD;
  T* Ps = Vs + BS * LD;  // [BLOCK][LDP]: each warp its own 16 rows

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

  int nkb = (sk + BS - 1) / BS;
  if (causal) nkb = min(nkb, (q0 + BLOCK - 1) / BS + 1);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BS;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<T, D, BS>(Ks, k, k0, sk);
    load_tile<T, D, BS>(Vs, v, k0, sk);
    __syncthreads();

    float s[NTK][4];
    zero(s);
    warp_gemm<true, NTK, D>(s, Qw, LD, Ks, LD);  // S = Q K^T

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
    warp_gemm<false, NTD, BS>(acc, Pw, LDP, Vs, LD);  // O += P V
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
__global__ void __launch_bounds__(sm90::THREADS, 1)
fwd_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                T* __restrict__ o, float* __restrict__ lse,
                int sq, int sk, int causal, float scale) {
  using namespace sm90;
  constexpr int BQ = FwdTiles<D>::ROWS, BK = FwdTiles<D>::TILE;
  constexpr int STAGES = FwdTiles<D>::STAGES;
  constexpr uint32_t Q_BYTES = tile_bytes<BQ, D>();
  constexpr uint32_t KV_BYTES = tile_bytes<BK, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* sq_tile = aligned_smem(smem_raw);
  uint8_t* ring = sq_tile + Q_BYTES;  // slot s: K at 2s, V at 2s + 1
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // One block per (bh, q-block); the q-blocks of one bh are neighbours, so
  // they share its K/V tiles in L2, and the last one, with the most causal
  // work, is issued first.
  const int nqb = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqb;
  const int q0 = (nqb - 1 - blockIdx.x % nqb) * BQ;
  int nkb = (sk + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + BQ - 1) / BK + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= PRODUCER_WARP) {
    reg_dealloc<PRODUCER_REGS>();
    if (warp == PRODUCER_WARP && lane == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      tma_tile<BQ, D>(sq_tile, &map_q, q_full, q0, bh);
      for (int i = 0; i < nkb; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        uint8_t* slot = ring + s * 2 * KV_BYTES;
        mbar_expect_tx(&full[s], 2 * KV_BYTES);
        tma_tile<BK, D>(slot, &map_k, &full[s], i * BK, bh);
        tma_tile<BK, D>(slot + KV_BYTES, &map_v, &full[s], i * BK, bh);
      }
    }
    return;
  }

  // Consumer warpgroup wg owns rows q0 + 64 wg ..; each warp 16 of them.
  reg_alloc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = q0 + wg * 64;
  const int w0 = wg_row0 + (warp % 4) * 16;  // this warp's first query row
  const int rows[2] = {w0 + g, w0 + g + 8};
  const uint32_t q_addr = smem_u32(sq_tile) + wg * 64 * row_bytes<D>();
  const float c2 = scale * LOG2E;  // raw scores to base-2 exponents

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2];         // S_i = Q K_i^T, [64 x BK] across the warpgroup
  uint32_t pa[BK / 16][4];  // P of the previous tile, as A fragments
  float corr[2];

  auto slot = [&](int i) {
    return smem_u32(ring + (i % STAGES) * 2 * KV_BYTES);
  };
  auto issue_s = [&](int i) {  // S_i = Q K_i^T, both K-major in shared memory
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BK, T>::ss(sc, k_major<BQ, D>(q_addr, kk),
                    k_major<BK, D>(slot(i), kk), kk > 0);
    wg_commit();
  };
  auto issue_pv = [&](int i) {  // O += P_i V_i, V read MN-major
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<D, T>::rs(acc, pa[kk], mn_major<BK, D>(slot(i) + KV_BYTES, kk), 1);
    wg_commit();
  };
  auto release = [&](int i) {  // this warp is done with tile i's slot
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % STAGES]);
  };
  // Online softmax on the raw scores of tile i, in base 2: the row max m is
  // kept unscaled, and p = 2^(s c2 - m c2) is one multiply-add and one ex2.
  // Only tiles that cross the diagonal or the end of the keys are masked,
  // in a branch of their own.
  auto softmax = [&](int i) {
    const int k0 = i * BK;
    if (k0 + BK > sk || (causal && k0 + BK - 1 > wg_row0)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1), r = rows[e >> 1];
          if (!(col < sk && (!causal || col <= r))) sc[4 * j + e] = NEG_INF;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    float mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      corr[h] = fast_exp2((m[h] - mx[h]) * c2);
      m[h] = mx[h];
      mc[h] = mx[h] * c2;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = fast_exp2(fmaf(sc[4 * j + e], c2, -mc[e >> 1]));
        sum[e >> 1] += sc[4 * j + e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = corr[h] * l[h] + quad_sum(sum[h]);
  };

  // The warpgroups take turns on the tensor cores (named barriers 1 and 2).
  // Turn i issues S_i and the previous tile's P V, then the softmax of S_i
  // runs while the other warpgroup's turn runs; turn 0 issues S_0 alone and
  // the last turn the last P V alone. Warpgroup 0 goes first; warpgroup 1
  // does not release it after the last turn, so every bar.sync meets one
  // bar.arrive.
  if (wg == 1) named_arrive(1);
  mbar_wait(q_full, 0);
  mbar_wait(&full[0], 0);
  named_sync(1 + wg);
  wg_fence();
  issue_s(0);
  named_arrive(2 - wg);
  wg_wait<0>();
  fence_regs(sc);
  softmax(0);
  to_a_frags<BK, T>(pa, sc);
  for (int i = 1; i < nkb; ++i) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    named_sync(1 + wg);
    fence_regs(acc);
    wg_fence();
    issue_s(i);
    issue_pv(i - 1);
    named_arrive(2 - wg);
    wg_wait<1>();  // S_i is in sc
    fence_regs(sc);
    softmax(i);
    wg_wait<0>();  // P_{i-1} V_{i-1} is in acc
    fence_regs(acc);
    release(i - 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
    to_a_frags<BK, T>(pa, sc);
  }
  named_sync(1 + wg);
  fence_regs(acc);
  wg_fence();
  issue_pv(nkb - 1);
  if (wg == 0) named_arrive(2);
  wg_wait<0>();
  fence_regs(acc);
  release(nkb - 1);

  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) den[h] = fmaxf(l[h], 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] /= den[0];
    acc[4 * j + 1] /= den[0];
    acc[4 * j + 2] /= den[1];
    acc[4 * j + 3] /= den[1];
  }
  store_rows<D, T>(o + ((size_t)bh * sq + w0) * D, acc, sq - w0);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rows[h] < sq)
        lse[(size_t)bh * sq + rows[h]] = m[h] * scale + logf(den[h]);
  }
}
// The wide body (flash_common.cuh, namespace wide).
template <typename T>
__global__ void __launch_bounds__(wide::THREADS)
fwd_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int sq, int sk, int d, int causal,
                float scale) {
  constexpr int R = wide::ROWS, BS = wide::FWD_STREAM;
  const int LD = wide::ld<T>(d);
  extern __shared__ __align__(16) unsigned char smem[];
  float* Os = reinterpret_cast<float*>(smem);  // [R][d]
  float* Ps = Os + R * d;                       // [R][BS]
  T* Qs = reinterpret_cast<T*>(Ps + R * BS);    // [R][LD]
  T* Ks = Qs + R * LD;                          // [BS][LD]
  T* Vs = Ks + BS * LD;                         // [BS][LD]

  const int nqb = (sq + R - 1) / R;
  const int bh = blockIdx.x / nqb;
  const int q0 = (nqb - 1 - blockIdx.x % nqb) * R;
  q += (size_t)bh * sq * d;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;
  o += (size_t)bh * sq * d;
  lse += (size_t)bh * sq;

  wide::load_rows(Qs, q, q0, R, sq, d);
  for (int i = threadIdx.x; i < R * d; i += wide::THREADS) Os[i] = 0.f;
  // This thread's query row and its two key columns of each tile.
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, row = q0 + r;
  float m = NEG_INF, l = 0.f;

  int nkb = (sk + BS - 1) / BS;
  if (causal) nkb = min(nkb, (q0 + R - 1) / BS + 1);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BS;
    __syncthreads();  // every thread is done with the previous tiles and P
    wide::load_rows(Ks, k, k0, BS, sk, d);
    wide::load_rows(Vs, v, k0, BS, sk, d);
    __syncthreads();

    float s0 = 0.f, s1 = 0.f;
    wide::dot2(Qs + r * LD, Ks + c * LD, Ks + (c + 8) * LD, d, s0, s1);
    const int c0 = k0 + c, c1 = k0 + c + 8;
    s0 = c0 < sk && (!causal || c0 <= row) ? s0 * scale : NEG_INF;
    s1 = c1 < sk && (!causal || c1 <= row) ? s1 * scale : NEG_INF;
    const float mx = wide::oct_max(fmaxf(m, fmaxf(s0, s1)));
    const float corr = expf(m - mx);
    s0 = expf(s0 - mx);
    s1 = expf(s1 - mx);
    l = corr * l + wide::oct_sum(s0 + s1);
    m = mx;
    Ps[r * BS + c] = s0;
    Ps[r * BS + c + 8] = s1;
    for (int j = c; j < d; j += 8) Os[r * d + j] *= corr;
    __syncthreads();
    wide::add_wb<BS>(Os, Ps, Vs, d);  // O += P V
  }
  __syncthreads();
  const float den = fmaxf(l, 1e-30f);
  wide::store_rows(o, Os, q0, sq, d, 1.f / den);
  if (c == 0 && row < sq) lse[row] = m + logf(den);
}

// Shared memory of each body (ray_tpu_torch/ops/attention.py's
// kernel_smem_bytes mirrors these).
template <typename T, int D>
static size_t fwd_smem() {
  if constexpr (hopper_body<T, D>()) {
    using Tl = sm90::FwdTiles<D>;
    return sm90::tile_bytes<Tl::ROWS, D>() +
           Tl::STAGES * 2 * sm90::tile_bytes<Tl::TILE, D>() +
           (1 + 2 * Tl::STAGES) * sizeof(uint64_t) + sm90::SMEM_ALIGN;
  } else {
    constexpr int BS = PlainTiles<D>::STREAM;
    return ((BLOCK + 2 * BS) * ld<T, D>() + BLOCK * ld<T, BS>()) * sizeof(T);
  }
}

template <typename T, int D>
static int fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int sq, int sk, int causal, float scale,
               cudaStream_t stream) {
  if constexpr (hopper_body<T, D>()) {
    using Tl = sm90::FwdTiles<D>;
    CUtensorMap mq, mk, mv;
    int err = sm90::make_map<T, D>(&mq, q, bh, sq, Tl::ROWS);
    if (!err) err = sm90::make_map<T, D>(&mk, k, bh, sk, Tl::TILE);
    if (!err) err = sm90::make_map<T, D>(&mv, v, bh, sk, Tl::TILE);
    if (err) return err;
    const dim3 grid(bh * ((sq + Tl::ROWS - 1) / Tl::ROWS));
    return launch(fwd_kernel_sm90<T, D>, grid, sm90::THREADS,
                  fwd_smem<T, D>(), stream, mq, mk, mv, static_cast<T*>(o),
                  static_cast<float*>(lse), sq, sk, causal, scale);
  } else {
    const dim3 grid(bh * ((sq + BLOCK - 1) / BLOCK));
    return launch(fwd_kernel<T, D>, grid, THREADS, fwd_smem<T, D>(), stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(o),
                  static_cast<float*>(lse), sq, sk, causal, scale);
  }
}

template <typename T>
static int fwd_wide(const void* q, const void* k, const void* v, void* o,
                    void* lse, int bh, int sq, int sk, int d, int causal,
                    float scale, cudaStream_t stream) {
  const size_t smem = wide::fwd_smem<T>(d);
  if (smem > wide::SMEM_LIMIT) return FLASH_ERR_SMEM;
  const dim3 grid(bh * ((sq + wide::ROWS - 1) / wide::ROWS));
  return launch(fwd_kernel_wide<T>, grid, wide::THREADS, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o),
                static_cast<float*>(lse), sq, sk, d, causal, scale);
}

template <typename T>
static int fwd_wide_smem(int d) {
  return (int)wide::fwd_smem<T>(d);
}

// q [bh, sq, d], k and v [bh, sk, d] -> o [bh, sq, d], lse [bh, sq] float32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int sq, int sk, int d,
                         int causal, float scale, int dtype, void* stream) {
  if (wide::head_dim(d))
    FLASH_DISPATCH_WIDE(fwd_wide, dtype, q, k, v, o, lse, bh, sq, sk, d,
                        causal, scale, static_cast<cudaStream_t>(stream));
  FLASH_DISPATCH(fwd, dtype, d, q, k, v, o, lse, bh, sq, sk, causal, scale,
                 static_cast<cudaStream_t>(stream));
}

// Shared memory one block of flash_fwd takes at this head dim and dtype.
extern "C" int flash_fwd_smem(int d, int dtype) {
  if (wide::head_dim(d)) FLASH_DISPATCH_WIDE(fwd_wide_smem, dtype, d);
  FLASH_DISPATCH(fwd_smem, dtype, d, );
}
