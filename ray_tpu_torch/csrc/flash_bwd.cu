// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel.
//
// Replace the TPU kernels ray_tpu/ops/attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (launched by _flash_backward). Both recompute the
// probabilities p = exp(s - lse) from the forward's row logsumexp, so
// neither the scores nor the probabilities are ever written to device
// memory. delta = rowsum(dO * O), the softmax-jacobian term both need, is
// computed by the dQ kernel, which runs first: each of its blocks owns the
// query rows whose delta it needs, sums them in its prologue and writes
// them for the dK/dV kernel (the JAX package computes it outside its
// kernels; the result is the same).
//
// Bounds on an H100 at GPT-2-small's shape (bh = 288, seq = 1024, d = 64,
// bf16, causal), with one causal product costing 2 * bh * d * seq*(seq+1)/2
// FLOPs (about 19 GFLOP):
//   dQ:    3 products, about 58 GFLOP (59 us at 989 TFLOP/s); reads q, k, v,
//          dO, O, lse and writes dQ and delta once, about 229 MB (68 us at
//          3.35 TB/s): bound by bytes.
//   dK/dV: 4 products, about 77 GFLOP (78 us); about 229 MB (68 us): bound
//          by operations.
//
// The TPU grid's sequential dimension becomes a loop inside the block, so
// nothing is carried between blocks and no atomics are needed.
//
// dQ, bf16 and float16 at d <= 128 (bwd_dq_kernel_sm90): the dK/dV design
// below with the roles of queries and keys swapped back. One block per 128
// queries, two consumer warpgroups of 64 and a producer warpgroup, whose
// first warp loads Q, dO and O once by TMA and streams K and V tiles
// through a ring of slots from key 0 up to the diagonal. Each warp first
// sums delta for its 16 rows from the resident dO and O tiles (the same
// swizzle permutes both tiles' rows alike, so the sum needs no
// unswizzling). Each warpgroup then computes
// S = Q K^T and dP = dO V^T on wgmma from shared memory, forms P = exp2(S
// scale log2 e - lse log2 e) and dS = P (dP - delta) in registers, and adds
// dQ += dS K with a register-A wgmma that reads K MN-major from its slot;
// dS never leaves the registers, and scale is applied once to dQ.
//
// dK/dV, bf16 and float16 at d <= 128 (bwd_dkv_kernel_sm90): one block per
// 128 keys, two consumer warpgroups of 64 keys and a producer warpgroup,
// whose first warp loads K and V once by TMA (they stay in shared memory)
// and streams Q and dO tiles, with their lse and delta slices, through a
// ring of slots from the diagonal down, ordered by full/empty mbarriers.
// Each warpgroup computes the transposed products S^T = K Q^T and
// dP^T = V dO^T on wgmma from shared memory (both K-major as stored),
// forms P^T = exp2(S^T scale log2 e - lse log2 e) and
// dS^T = P^T (dP^T - delta) scale in registers, and adds
// dV += P^T dO and dK += dS^T Q with register-A wgmma that read dO and Q
// MN-major from shared memory. P^T and dS^T never leave the registers; dK
// and dV accumulate in registers across the q loop and are written once.
// The two warpgroups take turns on the tensor cores, so that one's
// elementwise step overlaps the other's products.
//
// float32, and 16-bit at d 192 and 256 (bwd_dq_kernel, bwd_dkv_kernel): 64
// rows and 4 warps of 16 per block; dQ streams K/V tiles up to the diagonal
// (and sums delta first, as the Hopper body does), dK/dV streams Q/dO tiles
// from the diagonal down with the same transposed products. Each tile of
// PlainTiles<D>::STREAM rows is copied into shared memory between two
// barriers and shared by the block's warps; the products run on the CUDA
// cores in float32 (flash_common.cuh says why), and dS goes through shared
// memory, in the input type, to feed the next product. Above d = 128 the
// dK/dV block runs two warps per 16 keys, each accumulating half of dK's
// and dV's columns (PlainTiles::SPLIT).
//
// Every type at d > 256, a multiple of 64 (bwd_dq_kernel_wide,
// bwd_dkv_kernel_wide): on the CUDA cores in float32, d a run-time
// argument, 16 owned rows a block. dQ streams K/V tiles of 16 keys (delta
// summed first by the 8 lanes of each query row); dK/dV streams Q/dO tiles
// of 8 queries with their lse and delta. Each thread computes its entries
// of S and dP, P and dS go through shared memory in float32, and the D-wide
// accumulators (dQ; dK and dV) stay in shared memory, each thread adding
// into its own columns with the streamed tile's column in registers.

#include "flash_common.cuh"

using namespace flash;

// The CUDA-core body.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const T* __restrict__ o, const float* __restrict__ lse,
              float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
              int causal, float scale) {
  constexpr int BS = PlainTiles<D>::STREAM;  // keys a streamed tile
  constexpr int LD = ld<T, D>();
  constexpr int LDP = ld<T, BS>();
  constexpr int NTD = D / 8;
  constexpr int NTK = BS / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BLOCK * LD;
  T* Ks = dOs + BLOCK * LD;
  T* Vs = Ks + BS * LD;
  T* Ss = Vs + BS * LD;  // [BLOCK][LDP]: dS, each warp its own 16 rows

  const int nqb = (sq + BLOCK - 1) / BLOCK;  // grid as in flash_fwd.cu
  const int bh = blockIdx.x / nqb;
  const int q0 = (nqb - 1 - blockIdx.x % nqb) * BLOCK;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  o += (size_t)bh * sq * D;
  dq += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;

  load_tile<T, D>(Qs, q, q0, sq);
  load_tile<T, D>(dOs, dout, q0, sq);
  __syncthreads();  // dOs is read below
  const int w0 = q0 + warp * 16;
  const int rows[2] = {w0 + g, w0 + g + 8};
  const T* Qw = Qs + warp * 16 * LD;
  const T* dOw = dOs + warp * 16 * LD;
  T* Sw = Ss + warp * 16 * LDP;
  // delta = rowsum(dO * O) of this warp's rows: the four lanes of a row
  // each sum every fourth column, then combine; one lane writes it for the
  // dK/dV kernel.
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = 0.f;
    if (rows[i] < sq)
      for (int c = t; c < D; c += 4)
        sum = fmaf(to_float(dOw[(g + 8 * i) * LD + c]),
                   to_float(o[(size_t)rows[i] * D + c]), sum);
    row_delta[i] = quad_sum(sum);
    row_lse[i] = rows[i] < sq ? lse[rows[i]] : 0.f;
    if (t == 0 && rows[i] < sq) delta[rows[i]] = row_delta[i];
  }

  float acc[NTD][4];
  zero(acc);
  int nkb = (sk + BS - 1) / BS;
  if (causal) nkb = min(nkb, (q0 + BLOCK - 1) / BS + 1);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BS;
    __syncthreads();
    load_tile<T, D, BS>(Ks, k, k0, sk);
    load_tile<T, D, BS>(Vs, v, k0, sk);
    __syncthreads();

    float s[NTK][4], dp[NTK][4];
    zero(s);
    zero(dp);
    warp_gemm<true, NTK, D>(s, Qw, LD, Ks, LD);    // S = Q K^T
    warp_gemm<true, NTK, D>(dp, dOw, LD, Vs, LD);  // dP = dO V^T
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
    warp_gemm<false, NTD, BS>(acc, Sw, LDP, Ks, LD);  // dQ += dS K
    __syncwarp();
  }
  store_acc<T>(dq + (size_t)w0 * D, D, acc, sq - w0);
}

template <typename T, int D>
__global__ void __launch_bounds__(sm90::THREADS, 1)
bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_o,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   T* __restrict__ dq, int sq, int sk, int causal,
                   float scale) {
  using namespace sm90;
  constexpr int BQ = DqTiles<D>::ROWS, BK = DqTiles<D>::TILE;
  constexpr int STAGES = DqTiles<D>::STAGES;
  constexpr uint32_t Q_BYTES = tile_bytes<BQ, D>();
  constexpr uint32_t KV_BYTES = tile_bytes<BK, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* sq_tile = aligned_smem(smem_raw);
  uint8_t* sdo_tile = sq_tile + Q_BYTES;
  uint8_t* so_tile = sdo_tile + Q_BYTES;
  uint8_t* ring = so_tile + Q_BYTES;  // slot s: K at 2s, V at 2s + 1
  uint64_t* own_full =
      reinterpret_cast<uint64_t*>(ring + STAGES * 2 * KV_BYTES);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + STAGES;

  // One block per (bh, q-block), the last q-block of each bh (the most
  // causal work) first, as in flash_fwd.cu.
  const int nqb = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqb;
  const int q0 = (nqb - 1 - blockIdx.x % nqb) * BQ;
  int nkb = (sk + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + BQ - 1) / BK + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
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
      mbar_expect_tx(own_full, 3 * Q_BYTES);
      tma_tile<BQ, D>(sdo_tile, &map_do, own_full, q0, bh);
      tma_tile<BQ, D>(so_tile, &map_o, own_full, q0, bh);
      tma_tile<BQ, D>(sq_tile, &map_q, own_full, q0, bh);
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
  const int r0 = wg * 64 + (warp % 4) * 16;  // this warp's first tile row
  const int w0 = q0 + r0;
  const int rows[2] = {w0 + g, w0 + g + 8};
  const uint32_t q_addr = smem_u32(sq_tile) + wg * 64 * row_bytes<D>();
  const uint32_t do_addr = smem_u32(sdo_tile) + wg * 64 * row_bytes<D>();
  const float c2 = scale * LOG2E;  // raw scores to base-2 exponents
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;

  // Each thread's two rows: lse in base 2, and delta.
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    lse2[h] = rows[h] < sq ? lse[rows[h]] * LOG2E : 0.f;

  // Prologue: delta = rowsum(dO * O). The four lanes of a row (t) each sum
  // a quarter of each of its chunks, at the same offsets in both tiles:
  // TMA's swizzle permutes 16-byte pieces only within a row, and both tiles
  // are stored alike, so the pair at an offset is the same (row, column) in
  // both. Rows past the end were zero-filled and are not written.
  mbar_wait(own_full, 0);
  {
    constexpr int RB = row_bytes<D>(), PART = RB / 4;  // bytes of a lane
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < D / chunk_cols<D>(); ++c) {
        const int off = c * BQ * RB + (r0 + g + 8 * h) * RB + t * PART;
#pragma unroll
        for (int b = 0; b < PART; b += 16)
          sum = dot8<T>(*reinterpret_cast<const uint4*>(sdo_tile + off + b),
                     *reinterpret_cast<const uint4*>(so_tile + off + b), sum);
      }
      dlt[h] = quad_sum(sum);
      if (t == 0 && rows[h] < sq) delta[rows[h]] = dlt[h];
    }
  }

  float acc[D / 2];  // dQ / scale, [64 x D] across the warpgroup
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BK / 2], dp[BK / 2];  // S_i and dP_i, then dS_i in s
  uint32_t dsa[BK / 16][4];     // dS of the previous tile, as A fragments

  auto slot = [&](int i) {
    return smem_u32(ring + (i % STAGES) * 2 * KV_BYTES);
  };
  auto issue_s = [&](int i) {  // S = Q K^T, dP = dO V^T, all K-major
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BK, T>::ss(s, k_major<BQ, D>(q_addr, kk),
                       k_major<BK, D>(slot(i), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BK, T>::ss(dp, k_major<BQ, D>(do_addr, kk),
                       k_major<BK, D>(slot(i) + KV_BYTES, kk), kk > 0);
    wg_commit();
  };
  auto issue_dq = [&](int i) {  // dQ += dS K, K read MN-major
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<D, T>::rs(acc, dsa[kk], mn_major<BK, D>(slot(i), kk), 1);
    wg_commit();
  };
  auto release = [&](int i) {  // this warp is done with tile i's slot
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % STAGES]);
  };
  // P = 2^(S c2 - lse log2 e) and dS = P (dP - delta), in registers. Only
  // tiles that cross the diagonal or the end of the keys are masked, in a
  // branch of their own: a masked score becomes -1e30, whose probability
  // is 0.
  auto grads = [&](int i) {
    const int k0 = i * BK;
    if (k0 + BK > sk || (causal && k0 + BK - 1 > wg_row0)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1), r = rows[e >> 1];
          if (!(col < sk && (!causal || col <= r))) s[4 * j + e] = NEG_INF;
        }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[4 * j + e], c2, -lse2[e >> 1]));
        s[4 * j + e] = p * (dp[4 * j + e] - dlt[e >> 1]);
      }
  };

  // The warpgroups take turns on the tensor cores, as in flash_fwd.cu: turn
  // i issues S_i and dP_i and the previous tile's dS K, then forms dS_i
  // while the other warpgroup's turn runs. Causal: the last tiles, whose
  // every key follows this warpgroup's rows, add nothing; their turns issue
  // no product. Both warpgroups take nkb + 1 turns; warpgroup 1 does not
  // release warpgroup 0 after the last.
  const int n_wg = causal ? min(nkb, (wg_row0 + 63) / BK + 1) : nkb;
  if (wg == 1) named_arrive(1);
  mbar_wait(&full[0], 0);
  named_sync(1 + wg);
  wg_fence();
  issue_s(0);
  named_arrive(2 - wg);
  wg_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  grads(0);
  to_a_frags<BK, T>(dsa, s);
  for (int i = 1; i < n_wg; ++i) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    named_sync(1 + wg);
    fence_regs(acc);
    wg_fence();
    issue_s(i);
    issue_dq(i - 1);
    named_arrive(2 - wg);
    wg_wait<1>();  // S_i and dP_i are in registers
    fence_regs(s);
    fence_regs(dp);
    grads(i);
    wg_wait<0>();  // tile i - 1's dS K is done
    fence_regs(acc);
    release(i - 1);
    to_a_frags<BK, T>(dsa, s);
  }
  named_sync(1 + wg);
  fence_regs(acc);
  wg_fence();
  issue_dq(n_wg - 1);
  if (wg == 0 || n_wg < nkb) named_arrive(2 - wg);
  wg_wait<0>();
  fence_regs(acc);
  release(n_wg - 1);
  for (int i = n_wg; i < nkb; ++i) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    named_sync(1 + wg);
    if (wg == 0 || i + 1 < nkb) named_arrive(2 - wg);
    release(i);
  }

#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= scale;
  store_rows<D, T>(dq + ((size_t)bh * sq + w0) * D, acc, sq - w0);
}

// The CUDA-core body: warp w holds keys 16 (w % WARPS).. and, of dK and dV,
// the columns of group w / WARPS.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS * PlainTiles<D>::SPLIT)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
               int causal, float scale) {
  constexpr int BS = PlainTiles<D>::STREAM;  // queries a streamed tile
  constexpr int SPLIT = PlainTiles<D>::SPLIT;
  constexpr int NT = THREADS * SPLIT;
  constexpr int DC = D / SPLIT;  // dK and dV columns of one warp
  constexpr int LD = ld<T, D>();
  constexpr int LDP = ld<T, BS>();
  constexpr int NTD = DC / 8;
  constexpr int NTQ = BS / 8;  // accumulator tiles across a query tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BLOCK * LD;
  T* Qs = Vs + BLOCK * LD;
  T* dOs = Qs + BS * LD;
  T* Ps = dOs + BS * LD;  // [SPLIT * BLOCK][LDP]: P^T then dS^T, per warp
  float* lse_s = reinterpret_cast<float*>(Ps + SPLIT * BLOCK * LDP);
  float* delta_s = lse_s + BS;

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

  load_tile<T, D, BLOCK, NT>(Ks, k, k0, sk);
  load_tile<T, D, BLOCK, NT>(Vs, v, k0, sk);
  const int rw = warp % WARPS, c0 = (warp / WARPS) * DC;
  const int w0 = k0 + rw * 16;  // this warp's first key row
  const int keys[2] = {w0 + g, w0 + g + 8};
  const T* Kw = Ks + rw * 16 * LD;
  const T* Vw = Vs + rw * 16 * LD;
  T* Pw = Ps + warp * 16 * LDP;

  float dk_acc[NTD][4], dv_acc[NTD][4];
  zero(dk_acc);
  zero(dv_acc);
  const int nqb = (sq + BS - 1) / BS;
  // Causal: q-tiles that end before this block's first key add nothing.
  for (int qb = causal ? k0 / BS : 0; qb < nqb; ++qb) {
    const int q0 = qb * BS;
    __syncthreads();
    load_tile<T, D, BS, NT>(Qs, q, q0, sq);
    load_tile<T, D, BS, NT>(dOs, dout, q0, sq);
    for (int i = threadIdx.x; i < BS; i += NT) {
      lse_s[i] = q0 + i < sq ? lse[q0 + i] : 0.f;
      delta_s[i] = q0 + i < sq ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    float s[NTQ][4], dp[NTQ][4];
    zero(s);
    zero(dp);
    warp_gemm<true, NTQ, D>(s, Kw, LD, Qs, LD);    // S^T = K Q^T
    warp_gemm<true, NTQ, D>(dp, Vw, LD, dOs, LD);  // dP^T = V dO^T
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
    // dV += P^T dO and dK += dS^T Q, this warp's columns c0..
    warp_gemm<false, NTD, BS>(dv_acc, Pw, LDP, dOs + c0, LD);
    __syncwarp();
    store_acc<T>(Pw, LDP, dp, 16);
    __syncwarp();
    warp_gemm<false, NTD, BS>(dk_acc, Pw, LDP, Qs + c0, LD);
    __syncwarp();
  }
  store_acc<T>(dk + (size_t)w0 * D + c0, D, dk_acc, sk - w0);
  store_acc<T>(dv + (size_t)w0 * D + c0, D, dv_acc, sk - w0);
}

template <typename T, int D>
__global__ void __launch_bounds__(sm90::THREADS, 1)
bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
                    int causal, float scale) {
  using namespace sm90;
  constexpr int BKEY = DkvTiles<D>::ROWS, BQ = DkvTiles<D>::TILE;
  constexpr int STAGES = DkvTiles<D>::STAGES;
  constexpr uint32_t KV_BYTES = tile_bytes<BKEY, D>();
  constexpr uint32_t Q_BYTES = tile_bytes<BQ, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* sk_tile = aligned_smem(smem_raw);
  uint8_t* sv_tile = sk_tile + KV_BYTES;
  uint8_t* ring = sv_tile + KV_BYTES;  // slot s: Q at 2s, dO at 2s + 1
  float* lse_s = reinterpret_cast<float*>(ring + STAGES * 2 * Q_BYTES);
  float* delta_s = lse_s + STAGES * BQ;  // [STAGES][BQ] each
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + STAGES * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int nkb = (sk + BKEY - 1) / BKEY;
  const int bh = blockIdx.x / nkb;
  const int k0 = (blockIdx.x % nkb) * BKEY;  // low k-blocks: most work
  // Causal: q-tiles that end before this block's first key add nothing.
  const int qb0 = causal ? k0 / BQ : 0;
  const int n_iter = max(0, (sq + BQ - 1) / BQ - qb0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);              // every producer lane arrives
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= PRODUCER_WARP) {
    reg_dealloc<PRODUCER_REGS>();
    if (warp > PRODUCER_WARP) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * KV_BYTES);
      tma_tile<BKEY, D>(sk_tile, &map_k, kv_full, k0, bh);
      tma_tile<BKEY, D>(sv_tile, &map_v, kv_full, k0, bh);
    }
    for (int i = 0; i < n_iter; ++i) {
      const int s = i % STAGES, q0 = (qb0 + i) * BQ;
      if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
      // lse (pre-multiplied by log2 e) and delta of the tile's queries;
      // rows past the end are masked by the consumers.
      for (int c = lane; c < BQ; c += 32) {
        const bool in = q0 + c < sq;
        lse_s[s * BQ + c] = in ? lse[q0 + c] * LOG2E : 0.f;
        delta_s[s * BQ + c] = in ? delta[q0 + c] : 0.f;
      }
      if (lane == 0) {
        uint8_t* slot = ring + s * 2 * Q_BYTES;
        mbar_expect_tx(&full[s], 2 * Q_BYTES);
        tma_tile<BQ, D>(slot, &map_q, &full[s], q0, bh);
        tma_tile<BQ, D>(slot + Q_BYTES, &map_do, &full[s], q0, bh);
      } else {
        mbar_arrive(&full[s]);  // after this lane's lse and delta stores
      }
    }
    return;
  }

  // Consumer warpgroup wg owns keys k0 + 64 wg ..; each warp 16 of them.
  reg_alloc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  const int wg_key0 = k0 + wg * 64;
  const int w0 = wg_key0 + (warp % 4) * 16;  // this warp's first key row
  const int keys[2] = {w0 + g, w0 + g + 8};
  const uint32_t k_addr = smem_u32(sk_tile) + wg * 64 * row_bytes<D>();
  const uint32_t v_addr = smem_u32(sv_tile) + wg * 64 * row_bytes<D>();
  const float c2 = scale * LOG2E;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float st[BQ / 2], dpt[BQ / 2];  // S^T and dP^T, [64 keys x BQ queries]
  // P^T and dS^T of the previous tile, as A fragments.
  uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];

  auto slot = [&](int i) {
    return smem_u32(ring + (i % STAGES) * 2 * Q_BYTES);
  };
  auto issue_s = [&](int i) {  // S^T = K Q^T, dP^T = V dO^T, all K-major
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ, T>::ss(st, k_major<BKEY, D>(k_addr, kk),
                    k_major<BQ, D>(slot(i), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ, T>::ss(dpt, k_major<BKEY, D>(v_addr, kk),
                    k_major<BQ, D>(slot(i) + Q_BYTES, kk), kk > 0);
    wg_commit();
  };
  auto issue_grads = [&](int i) {  // dV += P^T dO, dK += dS^T Q, MN-major B
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      Wgmma<D, T>::rs(dv_acc, pa[kk], mn_major<BQ, D>(slot(i) + Q_BYTES, kk),
                   1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      Wgmma<D, T>::rs(dk_acc, dsa[kk], mn_major<BQ, D>(slot(i), kk), 1);
    wg_commit();
  };
  auto release = [&](int i) {  // this warp is done with tile i's slot
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % STAGES]);
  };
  // P^T = 2^(S^T c2 - lse log2 e) and dS^T = P^T (dP^T - delta) scale, in
  // registers. Only tiles that cross the diagonal or either sequence's end
  // are masked, in a branch of their own: a masked score becomes -1e30,
  // whose probability is 0.
  auto grads_in = [&](int i) {
    const int q0 = (qb0 + i) * BQ;
    const float* lse2 = lse_s + (i % STAGES) * BQ;
    const float* dlt = delta_s + (i % STAGES) * BQ;
    if (q0 + BQ > sq || k0 + BKEY > sk || (causal && q0 < wg_key0 + 63)) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + 8 * j + 2 * t + (e & 1), key = keys[e >> 1];
          if (!(q < sq && key < sk && (!causal || key <= q)))
            st[4 * j + e] = NEG_INF;
        }
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const float p = fast_exp2(fmaf(st[4 * j + e], c2, -lse2[c]));
        st[4 * j + e] = p;                                       // P^T
        dpt[4 * j + e] = p * (dpt[4 * j + e] - dlt[c]) * scale;  // dS^T
      }
  };

  // The warpgroups take turns on the tensor cores, as in flash_fwd.cu: turn
  // i issues S^T_i and dP^T_i and the previous tile's dV and dK products,
  // then forms P^T_i and dS^T_i while the other warpgroup's turn runs.
  // Causal: the first tiles, whose every query precedes this warpgroup's
  // keys, add nothing; their turns issue no product.
  const int first = min(n_iter, causal ? max(0, wg_key0 / BQ - qb0) : 0);
  if (wg == 1) named_arrive(1);
  mbar_wait(kv_full, 0);
  for (int i = 0; i < first; ++i) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    named_sync(1 + wg);
    named_arrive(2 - wg);
    release(i);
  }
  if (first < n_iter) {
    mbar_wait(&full[first % STAGES], (first / STAGES) & 1);
    named_sync(1 + wg);
    wg_fence();
    issue_s(first);
    named_arrive(2 - wg);
    wg_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    grads_in(first);
    to_a_frags<BQ, T>(pa, st);
    to_a_frags<BQ, T>(dsa, dpt);
    for (int i = first + 1; i < n_iter; ++i) {
      mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      named_sync(1 + wg);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wg_fence();
      issue_s(i);
      issue_grads(i - 1);
      named_arrive(2 - wg);
      wg_wait<1>();  // S^T_i and dP^T_i are in registers
      fence_regs(st);
      fence_regs(dpt);
      grads_in(i);
      wg_wait<0>();  // tile i - 1's products are done
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      release(i - 1);
      to_a_frags<BQ, T>(pa, st);
      to_a_frags<BQ, T>(dsa, dpt);
    }
    named_sync(1 + wg);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wg_fence();
    issue_grads(n_iter - 1);
    if (wg == 0) named_arrive(2);
    wg_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    release(n_iter - 1);
  } else {
    named_sync(1 + wg);
    if (wg == 0) named_arrive(2);
  }
  store_rows<D, T>(dk + ((size_t)bh * sk + w0) * D, dk_acc, sk - w0);
  store_rows<D, T>(dv + ((size_t)bh * sk + w0) * D, dv_acc, sk - w0);
}

// The wide bodies (flash_common.cuh, namespace wide).
template <typename T>
__global__ void __launch_bounds__(wide::THREADS)
bwd_dq_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const T* __restrict__ o, const float* __restrict__ lse,
                   float* __restrict__ delta, T* __restrict__ dq, int sq,
                   int sk, int d, int causal, float scale) {
  constexpr int R = wide::ROWS, BS = wide::DQ_STREAM;
  const int LD = wide::ld<T>(d);
  extern __shared__ __align__(16) unsigned char smem[];
  float* dQs = reinterpret_cast<float*>(smem);  // [R][d]
  float* dSs = dQs + R * d;                      // [R][BS]
  T* Qs = reinterpret_cast<T*>(dSs + R * BS);    // [R][LD]
  T* dOs = Qs + R * LD;                          // [R][LD]
  T* Ks = dOs + R * LD;                          // [BS][LD]
  T* Vs = Ks + BS * LD;                          // [BS][LD]

  const int nqb = (sq + R - 1) / R;
  const int bh = blockIdx.x / nqb;
  const int q0 = (nqb - 1 - blockIdx.x % nqb) * R;
  q += (size_t)bh * sq * d;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;
  dout += (size_t)bh * sq * d;
  o += (size_t)bh * sq * d;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  dq += (size_t)bh * sq * d;

  wide::load_rows(Qs, q, q0, R, sq, d);
  wide::load_rows(dOs, dout, q0, R, sq, d);
  for (int i = threadIdx.x; i < R * d; i += wide::THREADS) dQs[i] = 0.f;
  __syncthreads();
  // This thread's query row and its two key columns of each tile; the 8
  // lanes of the row sum its delta = rowsum(dO * O) first.
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, row = q0 + r;
  float dl = 0.f, lr = 0.f;
  if (row < sq) {
    for (int j = c; j < d; j += 8)
      dl = fmaf(to_float(dOs[r * LD + j]), to_float(o[(size_t)row * d + j]),
                dl);
    lr = lse[row];
  }
  dl = wide::oct_sum(dl);
  if (c == 0 && row < sq) delta[row] = dl;

  int nkb = (sk + BS - 1) / BS;
  if (causal) nkb = min(nkb, (q0 + R - 1) / BS + 1);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BS;
    __syncthreads();  // every thread is done with the previous tiles and dS
    wide::load_rows(Ks, k, k0, BS, sk, d);
    wide::load_rows(Vs, v, k0, BS, sk, d);
    __syncthreads();

    float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
    wide::dot2(Qs + r * LD, Ks + c * LD, Ks + (c + 8) * LD, d, s0, s1);
    wide::dot2(dOs + r * LD, Vs + c * LD, Vs + (c + 8) * LD, d, dp0, dp1);
    const int c0 = k0 + c, c1 = k0 + c + 8;
    const float p0 =
        c0 < sk && (!causal || c0 <= row) ? expf(s0 * scale - lr) : 0.f;
    const float p1 =
        c1 < sk && (!causal || c1 <= row) ? expf(s1 * scale - lr) : 0.f;
    dSs[r * BS + c] = p0 * (dp0 - dl) * scale;
    dSs[r * BS + c + 8] = p1 * (dp1 - dl) * scale;
    __syncthreads();
    wide::add_wb<BS>(dQs, dSs, Ks, d);  // dQ += dS K
  }
  __syncthreads();
  wide::store_rows(dq, dQs, q0, sq, d, 1.f);
}

template <typename T>
__global__ void __launch_bounds__(wide::THREADS)
bwd_dkv_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int sq, int sk, int d, int causal,
                    float scale) {
  constexpr int R = wide::ROWS, BS = wide::DKV_STREAM;
  const int LD = wide::ld<T>(d);
  extern __shared__ __align__(16) unsigned char smem[];
  float* dKs = reinterpret_cast<float*>(smem);  // [R][d]
  float* dVs = dKs + R * d;                      // [R][d]
  float* Ps = dVs + R * d;                       // [R][BS], keys x queries
  float* dSs = Ps + R * BS;                      // [R][BS]
  float* lse_s = dSs + R * BS;                   // [BS]
  float* delta_s = lse_s + BS;                   // [BS]
  T* Ks = reinterpret_cast<T*>(delta_s + BS);    // [R][LD]
  T* Vs = Ks + R * LD;                           // [R][LD]
  T* Qs = Vs + R * LD;                           // [BS][LD]
  T* dOs = Qs + BS * LD;                         // [BS][LD]

  // The first key blocks see the most causal queries: issued first.
  const int nkb = (sk + R - 1) / R;
  const int bh = blockIdx.x / nkb;
  const int k0 = (blockIdx.x % nkb) * R;
  q += (size_t)bh * sq * d;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;
  dout += (size_t)bh * sq * d;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  dk += (size_t)bh * sk * d;
  dv += (size_t)bh * sk * d;

  wide::load_rows(Ks, k, k0, R, sk, d);
  wide::load_rows(Vs, v, k0, R, sk, d);
  for (int i = threadIdx.x; i < 2 * R * d; i += wide::THREADS) dKs[i] = 0.f;
  // This thread's key row and its one query column of each tile.
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, key = k0 + r;

  const int nqb = (sq + BS - 1) / BS;
  for (int qb = causal ? k0 / BS : 0; qb < nqb; ++qb) {
    const int q0 = qb * BS;
    __syncthreads();  // every thread is done with the previous tiles, P, dS
    wide::load_rows(Qs, q, q0, BS, sq, d);
    wide::load_rows(dOs, dout, q0, BS, sq, d);
    if (threadIdx.x < BS) {
      const bool in = q0 + threadIdx.x < sq;
      lse_s[threadIdx.x] = in ? lse[q0 + threadIdx.x] : 0.f;
      delta_s[threadIdx.x] = in ? delta[q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    const float s = wide::dot(Ks + r * LD, Qs + c * LD, d);
    const float dp = wide::dot(Vs + r * LD, dOs + c * LD, d);
    const int qrow = q0 + c;
    const float p = qrow < sq && key < sk && (!causal || key <= qrow)
                        ? expf(s * scale - lse_s[c])
                        : 0.f;
    Ps[r * BS + c] = p;
    dSs[r * BS + c] = p * (dp - delta_s[c]) * scale;
    __syncthreads();
    wide::add_wb<BS>(dVs, Ps, dOs, d);  // dV += P^T dO
    wide::add_wb<BS>(dKs, dSs, Qs, d);  // dK += dS^T Q
  }
  __syncthreads();
  wide::store_rows(dk, dKs, k0, sk, d, 1.f);
  wide::store_rows(dv, dVs, k0, sk, d, 1.f);
}

// Shared memory of each body (ray_tpu_torch/ops/attention.py's
// kernel_smem_bytes mirrors these).
template <typename T, int D>
static size_t dq_smem() {
  if constexpr (hopper_body<T, D>()) {
    using Tl = sm90::DqTiles<D>;
    return 3 * sm90::tile_bytes<Tl::ROWS, D>() +
           Tl::STAGES * 2 * sm90::tile_bytes<Tl::TILE, D>() +
           (1 + 2 * Tl::STAGES) * sizeof(uint64_t) + sm90::SMEM_ALIGN;
  } else {
    constexpr int BS = PlainTiles<D>::STREAM;
    return ((2 * BLOCK + 2 * BS) * ld<T, D>() + BLOCK * ld<T, BS>()) *
           sizeof(T);
  }
}

template <typename T, int D>
static size_t dkv_smem() {
  if constexpr (hopper_body<T, D>()) {
    using Tl = sm90::DkvTiles<D>;
    return 2 * sm90::tile_bytes<Tl::ROWS, D>() +
           Tl::STAGES * (2 * sm90::tile_bytes<Tl::TILE, D>() +
                         2 * Tl::TILE * sizeof(float)) +
           (1 + 2 * Tl::STAGES) * sizeof(uint64_t) + sm90::SMEM_ALIGN;
  } else {
    using Tl = PlainTiles<D>;
    return ((2 * BLOCK + 2 * Tl::STREAM) * ld<T, D>() +
            Tl::SPLIT * BLOCK * ld<T, Tl::STREAM>()) * sizeof(T) +
           2 * Tl::STREAM * sizeof(float);
  }
}

template <typename T, int D>
static int bwd_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* out, const void* lse,
                  void* delta, void* dq, int bh, int sq, int sk, int causal,
                  float scale, cudaStream_t stream) {
  if constexpr (hopper_body<T, D>()) {
    using Tl = sm90::DqTiles<D>;
    CUtensorMap mq, mk, mv, mdo, mo;
    int err = sm90::make_map<T, D>(&mq, q, bh, sq, Tl::ROWS);
    if (!err) err = sm90::make_map<T, D>(&mk, k, bh, sk, Tl::TILE);
    if (!err) err = sm90::make_map<T, D>(&mv, v, bh, sk, Tl::TILE);
    if (!err) err = sm90::make_map<T, D>(&mdo, dout, bh, sq, Tl::ROWS);
    if (!err) err = sm90::make_map<T, D>(&mo, out, bh, sq, Tl::ROWS);
    if (err) return err;
    const dim3 grid(bh * ((sq + Tl::ROWS - 1) / Tl::ROWS));
    return launch(bwd_dq_kernel_sm90<T, D>, grid, sm90::THREADS,
                  dq_smem<T, D>(), stream, mq, mk, mv, mdo, mo,
                  static_cast<const float*>(lse), static_cast<float*>(delta),
                  static_cast<T*>(dq), sq, sk, causal, scale);
  } else {
    const dim3 grid(bh * ((sq + BLOCK - 1) / BLOCK));
    return launch(bwd_dq_kernel<T, D>, grid, THREADS, dq_smem<T, D>(), stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const T*>(out), static_cast<const float*>(lse),
                  static_cast<float*>(delta), static_cast<T*>(dq), sq, sk,
                  causal, scale);
  }
}

template <typename T, int D>
static int bwd_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int bh, int sq, int sk, int causal,
                   float scale, cudaStream_t stream) {
  if constexpr (hopper_body<T, D>()) {
    using Tl = sm90::DkvTiles<D>;
    CUtensorMap mq, mk, mv, mdo;
    int err = sm90::make_map<T, D>(&mq, q, bh, sq, Tl::TILE);
    if (!err) err = sm90::make_map<T, D>(&mk, k, bh, sk, Tl::ROWS);
    if (!err) err = sm90::make_map<T, D>(&mv, v, bh, sk, Tl::ROWS);
    if (!err) err = sm90::make_map<T, D>(&mdo, dout, bh, sq, Tl::TILE);
    if (err) return err;
    const dim3 grid(bh * ((sk + Tl::ROWS - 1) / Tl::ROWS));
    return launch(bwd_dkv_kernel_sm90<T, D>, grid, sm90::THREADS,
                  dkv_smem<T, D>(), stream, mq, mk, mv, mdo,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dk),
                  static_cast<T*>(dv), sq, sk, causal, scale);
  } else {
    const dim3 grid(bh * ((sk + BLOCK - 1) / BLOCK));
    return launch(bwd_dkv_kernel<T, D>, grid,
                  THREADS * PlainTiles<D>::SPLIT, dkv_smem<T, D>(),
                  stream, static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dk),
                  static_cast<T*>(dv), sq, sk, causal, scale);
  }
}

template <typename T>
static int bwd_dq_wide(const void* q, const void* k, const void* v,
                       const void* dout, const void* out, const void* lse,
                       void* delta, void* dq, int bh, int sq, int sk, int d,
                       int causal, float scale, cudaStream_t stream) {
  const size_t smem = wide::dq_smem<T>(d);
  if (smem > wide::SMEM_LIMIT) return FLASH_ERR_SMEM;
  const dim3 grid(bh * ((sq + wide::ROWS - 1) / wide::ROWS));
  return launch(bwd_dq_kernel_wide<T>, grid, wide::THREADS, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const T*>(out), static_cast<const float*>(lse),
                static_cast<float*>(delta), static_cast<T*>(dq), sq, sk, d,
                causal, scale);
}

template <typename T>
static int bwd_dkv_wide(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int bh, int sq, int sk, int d,
                        int causal, float scale, cudaStream_t stream) {
  const size_t smem = wide::dkv_smem<T>(d);
  if (smem > wide::SMEM_LIMIT) return FLASH_ERR_SMEM;
  const dim3 grid(bh * ((sk + wide::ROWS - 1) / wide::ROWS));
  return launch(bwd_dkv_kernel_wide<T>, grid, wide::THREADS, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk),
                static_cast<T*>(dv), sq, sk, d, causal, scale);
}

template <typename T>
static int dq_wide_smem(int d) {
  return (int)wide::dq_smem<T>(d);
}

template <typename T>
static int dkv_wide_smem(int d) {
  return (int)wide::dkv_smem<T>(d);
}

// q, dout, out [bh, sq, d]; k, v [bh, sk, d]; lse [bh, sq] float32
// -> delta [bh, sq] float32, dq [bh, sq, d].
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* out,
                            const void* lse, void* delta, void* dq, int bh,
                            int sq, int sk, int d, int causal, float scale,
                            int dtype, void* stream) {
  if (wide::head_dim(d))
    FLASH_DISPATCH_WIDE(bwd_dq_wide, dtype, q, k, v, dout, out, lse, delta,
                        dq, bh, sq, sk, d, causal, scale,
                        static_cast<cudaStream_t>(stream));
  FLASH_DISPATCH(bwd_dq, dtype, d, q, k, v, dout, out, lse, delta, dq, bh, sq,
                 sk, causal, scale, static_cast<cudaStream_t>(stream));
}

// q, dout [bh, sq, d]; k, v [bh, sk, d]; lse, delta [bh, sq] float32 (delta
// as flash_bwd_dq wrote it) -> dk, dv [bh, sk, d].
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int sq, int sk, int d, int causal, float scale,
                             int dtype, void* stream) {
  if (wide::head_dim(d))
    FLASH_DISPATCH_WIDE(bwd_dkv_wide, dtype, q, k, v, dout, lse, delta, dk,
                        dv, bh, sq, sk, d, causal, scale,
                        static_cast<cudaStream_t>(stream));
  FLASH_DISPATCH(bwd_dkv, dtype, d, q, k, v, dout, lse, delta, dk, dv, bh, sq,
                 sk, causal, scale, static_cast<cudaStream_t>(stream));
}

// Shared memory one block of flash_bwd_dq (kernel 0) or flash_bwd_dkv
// (kernel 1) takes at this head dim and dtype.
extern "C" int flash_bwd_smem(int kernel, int d, int dtype) {
  if (wide::head_dim(d)) {
    if (kernel == 0) FLASH_DISPATCH_WIDE(dq_wide_smem, dtype, d);
    FLASH_DISPATCH_WIDE(dkv_wide_smem, dtype, d);
  }
  if (kernel == 0) FLASH_DISPATCH(dq_smem, dtype, d, );
  FLASH_DISPATCH(dkv_smem, dtype, d, );
}
