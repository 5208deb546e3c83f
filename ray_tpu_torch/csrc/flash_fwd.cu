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
// Bound at d 192 and 256 (bh = 24, seq = 2048, bf16, causal): 38.7 and
// 51.6 GFLOP, 0.039 and 0.052 ms at 989 TFLOP/s, against 76 and 101 MB of
// q, k, v, o and lse (0.023 and 0.030 ms at 3.35 TB/s): bound by
// operations.
//
// Three bodies, chosen by type and head dim:
//
// bf16 and float16 at d <= 256 (fwd_kernel_sm90): one block per 128 query
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
// At d 192 and 256 the same body streams tiles of 64 keys, 3 and 2 slots
// each of K and V beside Q (FwdTiles: Q of 128 rows takes 48 and 64 KB, a
// tile 24 and 32 KB). What is tight there:
// - registers: a consumer thread holds D / 2 floats of O (128 at d 256)
//   beside S (32) and P's A fragments (16). Q's descriptors are
//   rebuilt each turn from an opaque base so that they are not hoisted into
//   registers (0 spills), and P V is issued as products of 128 columns (and
//   one of 64 at d 192), since the Wgmma shapes stop at N = 128;
// - the ring: released together, K_i and V_i would free their slot only
//   after P_i V_i, a turn after S_i, and with 2 slots the next tile's load
//   would start just as it is needed. K_i is released as soon as S_i is
//   done and V_i after P_i V_i, each with its own mbarriers;
// - the causal tail: a q-block's work grows with its position, and one
//   head's blocks issued in a row (heaviest first) left the heavy blocks of
//   the last heads to run alone at the end at bh 24. The grid runs through
//   groups of 12 heads, and within a group through the q-blocks, heaviest
//   first, for all its heads at each.
// The softmax is a small share there (one exponential per 4 d = 1,024
// flops at d 256), but the turns still let one warpgroup's softmax and
// rescale of O run under the other's products.
//
// bf16 and float16 at d > 256, a multiple of 64 (fwd_kernel_sm90_wide):
// the Hopper machinery with d at run time. At those widths neither Q of
// 128 rows nor a K tile of 64 keys fits in shared memory beside the rest,
// and a warpgroup's O (d / 2 floats a thread) does not fit in registers.
// So O's columns are split over the grid, in chunks of 192 or 256 columns
// (sm90::WideFwdTiles): each block owns 128 query rows and one chunk,
// streams 64-column chunks of Q and K through one ring and V's columns of
// its chunk through another, and computes S over all d itself. With c
// chunks that costs (c + 1) / 2 times the minimum FLOPs (1.5x at d 512,
// 2.5x at d 1024) and multiplies the grid by c: 128 blocks on 132 SMs at
// bh 8, seq 1024, d 320 to 512. Bound at bh 24, seq 2048, causal: 77.3,
// 103.1 and 206.3 GFLOP at d 384, 512 and 1024 (0.078, 0.104 and 0.209 ms
// at 989 TFLOP/s) against 151 to 403 MB (0.045 to 0.120 ms at 3.35 TB/s):
// by operations. Q's chunks are read again from L2 for every key tile,
// twice K's bytes; a variant that kept Q resident up to d 576 ran 3-14%
// faster at d 384 and 512 on an H100 and was not kept (a second layout).
//
// float32 at every head dim (fwd_kernel_tf32), d a run-time argument: the
// wide body's shape in 3xTF32 (flash_common.cuh says why three products),
// S on wgmma and P V on mma.sync. 128 query rows a block, two consumer
// warpgroups and a producer warpgroup; S over all d from 32-column chunks
// of Q and K through a TMA ring of 4 slots (3 at COLS 256), P V from V's
// [64 x COLS] tiles through a 2-slot one,
// O's columns split over the grid in chunks of COLS (tf32::cols: a power
// of two up to 256 that covers d, narrower where the row blocks alone
// leave the card's SMs idle). Bound at bh 24, seq 2048, causal: 12.9, 25.8 and 51.6
// GFLOP at d 64, 128 and 256, 0.078, 0.156 and 0.313 ms at 165 TFLOP/s,
// the tensor cores' TF32 rate over its three products (495 / 3), against
// 50 to 201 MB (0.015 to 0.060 ms at 3.35 TB/s): by operations. At the
// small shapes phase 2 of chip_smoke.py times (bh 2 to 4, seq 256) 4 to 8
// row blocks cannot fill 132 SMs, and latency bounds it instead: there the
// columns are split down to 64 a block.
//
// All skip causal tiles above the diagonal, mask only the tiles that cross
// it or the end of the sequence, and issue the heaviest q-blocks first.

#include "flash_common.cuh"

using namespace flash;

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
  // Above d 128, K_i and V_i are released apart: K_i once S_i is done, V_i
  // once P_i V_i is, a turn later, so the next K tile is loaded while the
  // current P V runs. The STAGES K slots come first in the ring, then the
  // V slots, each with its own full and empty mbarrier (K's at s, V's at
  // STAGES + s). Up to d 128, slot s holds K at 2s and V at 2s + 1, both
  // released after P V.
  constexpr bool SPLIT = D > 128;
  constexpr int NBAR = SPLIT ? 2 * STAGES : STAGES;  // full (and empty) ones
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* sq_tile = aligned_smem(smem_raw);
  uint8_t* ring = sq_tile + Q_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NBAR;

  // One block per (bh, q-block), the q-blocks with the most causal work
  // first. Up to d 128 the q-blocks of one bh are neighbours, the last one
  // first, so they share its K/V tiles in L2. Above, the grid runs through
  // groups of HEADS heads, and within a group through the q-blocks from the
  // last, all heads of the group at each: the heaviest blocks of many heads
  // start in the first wave and the light ones fill the last, where one
  // head's blocks in a row left a long tail of heavy blocks at bh 24.
  const int nqb = (sq + BQ - 1) / BQ;
  int bh, q0;
  if constexpr (SPLIT) {
    constexpr int HEADS = 12;
    const int bhs = gridDim.x / nqb;
    const int g0 = blockIdx.x / (HEADS * nqb) * HEADS;  // the group's first
    const int r = blockIdx.x - g0 * nqb, heads = min(HEADS, bhs - g0);
    bh = g0 + r % heads;
    q0 = (nqb - 1 - r / heads) * BQ;
  } else {
    bh = blockIdx.x / nqb;
    q0 = (nqb - 1 - blockIdx.x % nqb) * BQ;
  }
  int nkb = (sk + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + BQ - 1) / BK + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NBAR; ++s) {
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
        if constexpr (SPLIT) {
          for (int s = i % STAGES; s < NBAR; s += STAGES) {  // K_i, then V_i
            if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
            mbar_expect_tx(&full[s], KV_BYTES);
            tma_tile<BK, D>(ring + s * KV_BYTES, s < STAGES ? &map_k : &map_v,
                            &full[s], i * BK, bh);
          }
        } else {
          const int s = i % STAGES;
          if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
          uint8_t* slot = ring + s * 2 * KV_BYTES;
          mbar_expect_tx(&full[s], 2 * KV_BYTES);
          tma_tile<BK, D>(slot, &map_k, &full[s], i * BK, bh);
          tma_tile<BK, D>(slot + KV_BYTES, &map_v, &full[s], i * BK, bh);
        }
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

  auto k_at = [&](int i) {  // K_i's slot
    if constexpr (SPLIT) return smem_u32(ring + (i % STAGES) * KV_BYTES);
    else return smem_u32(ring + (i % STAGES) * 2 * KV_BYTES);
  };
  auto v_at = [&](int i) {  // V_i's slot
    if constexpr (SPLIT)
      return smem_u32(ring + (STAGES + i % STAGES) * KV_BYTES);
    else return smem_u32(ring + (i % STAGES) * 2 * KV_BYTES) + KV_BYTES;
  };
  auto issue_s = [&](int i) {  // S_i = Q K_i^T, both K-major in shared memory
    if constexpr (D > 128) {
      // Hoisted out of the loop, Q's D / 16 descriptors (64 bits each)
      // would sit beside O's D / 2 floats: rebuilt each turn from an opaque
      // base, by one add each, as dQ's are.
      const uint64_t qd = k_major<BQ, D>(opaque(q_addr), 0);
      const uint64_t kd = k_major<BK, D>(k_at(i), 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BK, T>::ss(sc, k_major_at<BQ, D>(qd, kk),
                         k_major_at<BK, D>(kd, kk), kk > 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BK, T>::ss(sc, k_major<BQ, D>(q_addr, kk),
                      k_major<BK, D>(k_at(i), kk), kk > 0);
    }
    wg_commit();
  };
  auto issue_pv = [&](int i) {  // O += P_i V_i, V read MN-major
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t vd = mn_major<BK, D>(v_at(i), kk);
      if constexpr (D <= 128)
        Wgmma<D, T>::rs(acc, pa[kk], vd, 1);
      else  // products of 128 columns, then one of D - 128
        WgmmaCols<D, T>::rs(acc, pa[kk], vd, 1);
    }
    wg_commit();
  };
  // This warp is done with V_i's slot (and K_i's, unless SPLIT), or with
  // K_i's alone.
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(SPLIT ? STAGES : 0) + i % STAGES]);
  };
  auto release_k = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % STAGES]);
  };
  auto wait_v = [&](int i) {  // SPLIT: V_i is in its slot
    mbar_wait(&full[STAGES + i % STAGES], (i / STAGES) & 1);
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
  if constexpr (SPLIT) release_k(0);
  fence_regs(sc);
  softmax(0);
  to_a_frags<BK, T>(pa, sc);
  for (int i = 1; i < nkb; ++i) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);  // K_i (and V_i)
    if constexpr (SPLIT) wait_v(i - 1);
    named_sync(1 + wg);
    fence_regs(acc);
    wg_fence();
    issue_s(i);
    issue_pv(i - 1);
    named_arrive(2 - wg);
    wg_wait<1>();  // S_i is in sc
    if constexpr (SPLIT) release_k(i);
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
  if constexpr (SPLIT) wait_v(nkb - 1);
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

// The 16-bit body above d 256 (sm90::WideFwdTiles): a block owns 128 query
// rows, two consumer warpgroups of 64, and one chunk of COLS of O's
// columns, from col0 = chunk * COLS. For each key tile i of 64 keys it
// builds S_i = Q K_i^T over all d columns from the 64-column chunks of Q
// and K_i that the producer streams through ring A (one chunk of each a
// slot, released as soon as the next chunk's product is issued), then
// P_i V_i for its columns from V's [64 x COLS] tile in ring B. Step i
// issues P_{i-1} V_{i-1} ahead of S_i's chunks, so the tensor cores run
// the one while the other's operands arrive; the softmax of S_i runs once
// both are done, while the other warpgroup's products run. The warpgroups
// do not take turns as fwd_kernel_sm90's do: there is one exponential per
// 2 (d + COLS) flops, over 1,000. Every block of
// a q-block computes S in the same order, so their m and l agree bit for
// bit; chunk 0's blocks write lse. V's boxes that lie past d are not
// loaded: they feed only O's columns past d, which are not stored.
template <typename T, int COLS>
__global__ void __launch_bounds__(sm90::THREADS, 1)
fwd_kernel_sm90_wide(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     T* __restrict__ o, float* __restrict__ lse, int sq,
                     int sk, int d, int causal, float scale) {
  using namespace sm90;
  using Tl = WideFwdTiles;
  constexpr int BQ = Tl::ROWS, BK = Tl::TILE;
  constexpr int SA = Tl::STAGES, SB = Tl::V_STAGES;
  constexpr uint32_t Q_BYTES = tile_bytes<BQ, 64>();  // a chunk of Q
  constexpr uint32_t A_BYTES = Q_BYTES + tile_bytes<BK, 64>();  // + K's
  constexpr uint32_t BOX = tile_bytes<BK, 64>();  // 64 of V's columns
  constexpr uint32_t B_BYTES = tile_bytes<BK, COLS>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* ring_a = aligned_smem(smem_raw);
  uint8_t* ring_b = ring_a + SA * A_BYTES;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(ring_b + SB * B_BYTES);
  uint64_t* empty_a = full_a + SA;
  uint64_t* full_b = empty_a + SA;
  uint64_t* empty_b = full_b + SB;

  // The grid runs through groups of HEADS heads, within a group through
  // the q-blocks from the last (the most causal work), all heads and
  // chunks of the group at each; the chunks of one q-block are neighbours,
  // so they read its Q and K chunks from L2 at about the same time.
  constexpr int HEADS = 12;
  const int nd = d / 64, nc = wide_chunks(d);
  const int nqb = (sq + BQ - 1) / BQ, per = nqb * nc;
  const int g0 = blockIdx.x / (HEADS * per) * HEADS;
  const int r = blockIdx.x - g0 * per;
  const int heads = min(HEADS, (int)gridDim.x / per - g0);
  const int chunk = r % nc, rq = r / nc;
  const int bh = g0 + rq % heads;
  const int q0 = (nqb - 1 - rq / heads) * BQ;
  const int col0 = chunk * COLS, ncols = min(COLS, d - col0);
  int nkb = (sk + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + BQ - 1) / BK + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(&full_a[s], 1);
      mbar_init(&empty_a[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(&full_b[s], 1);
      mbar_init(&empty_b[s], CONSUMERS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= PRODUCER_WARP) {
    reg_dealloc<PRODUCER_REGS>();
    if (warp == PRODUCER_WARP && lane == 0) {
      const int nbox = ncols / 64;
      int s = 0, ph = 0;  // ring A's next slot, and its use's parity
      for (int i = 0, n = 0; i < nkb; ++i) {
        for (int c = 0; c < nd; ++c, ++n) {  // Q's and K_i's chunk c
          if (n >= SA) mbar_wait(&empty_a[s], ph ^ 1);
          uint8_t* slot = ring_a + s * A_BYTES;
          mbar_expect_tx(&full_a[s], A_BYTES);
          tma_load(slot, &map_q, &full_a[s], 64 * c, q0, bh);
          tma_load(slot + Q_BYTES, &map_k, &full_a[s], 64 * c, i * BK, bh);
          if (++s == SA) s = 0, ph ^= 1;
        }
        const int b = i % SB;  // V_i's columns of this chunk
        if (i >= SB) mbar_wait(&empty_b[b], (i / SB - 1) & 1);
        mbar_expect_tx(&full_b[b], nbox * BOX);
        for (int j = 0; j < nbox; ++j)
          tma_load(ring_b + b * B_BYTES + j * BOX, &map_v, &full_b[b],
                   col0 + 64 * j, i * BK, bh);
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
  const float c2 = scale * LOG2E;  // raw scores to base-2 exponents

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[COLS / 2];
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2];         // S_i, [64 x BK] across the warpgroup
  uint32_t pa[BK / 16][4];  // P of the previous tile, as A fragments
  float corr[2];

  auto release = [&](uint64_t* bar) {  // this warp is done with a slot
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // Ring A's slot in use, the parity of its use and the slot used before
  // it, counted as the producer counts them (dividing a count of chunks
  // by SA instead took ~5% longer at d 1024 on an H100).
  int s = 0, ph = 0, prev = 0;
  // S (+)= Q_c K_c^T from slot s, both K-major (64 columns, one swizzled
  // 128-byte row each).
  auto issue_s = [&](int accumulate) {
    const uint32_t slot = smem_u32(ring_a + s * A_BYTES);
    const uint64_t qd = k_major<64, 64>(slot + wg * 64 * row_bytes<64>(), 0);
    const uint64_t kd = k_major<BK, 64>(slot + Q_BYTES, 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<BK, T>::ss(sc, k_major_at<64, 64>(qd, kk),
                       k_major_at<BK, 64>(kd, kk), accumulate | (kk > 0));
    wg_commit();
  };
  // O += P_i V_i for this chunk's columns, V read MN-major; products of
  // 128 columns, then one of COLS - 128.
  auto issue_pv = [&](int i) {
    const uint32_t vb = smem_u32(ring_b + (i % SB) * B_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaCols<COLS, T>::rs(acc, pa[kk], mn_major<BK, COLS>(vb, kk), 1);
    wg_commit();
  };
  // S_i from the next nd slots of ring A: each chunk's slot is released
  // once the next chunk's product is issued and the older ones are done;
  // V_{i-1}'s (pv, whose product went first) once chunk 0 is done.
  auto s_tile = [&](int i, bool pv) {
    for (int c = 0; c < nd; ++c) {
      mbar_wait(&full_a[s], ph);
      issue_s(c > 0);
      if (c > 0) {
        wg_wait<1>();
        release(&empty_a[prev]);
        if (c == 1 && pv) release(&empty_b[(i - 1) % SB]);
      }
      prev = s;
      if (++s == SA) s = 0, ph ^= 1;
    }
    wg_wait<0>();
    release(&empty_a[prev]);
  };
  // Online softmax on the raw scores of tile i, in base 2, as in
  // fwd_kernel_sm90.
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

  wg_fence();
  s_tile(0, false);
  fence_regs(sc);
  softmax(0);
  to_a_frags<BK, T>(pa, sc);
  for (int i = 1; i < nkb; ++i) {
    mbar_wait(&full_b[(i - 1) % SB], ((i - 1) / SB) & 1);  // V_{i-1}
    fence_regs(acc);
    wg_fence();
    issue_pv(i - 1);
    s_tile(i, true);
    fence_regs(sc);
    fence_regs(acc);
    softmax(i);
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
    to_a_frags<BK, T>(pa, sc);
  }
  mbar_wait(&full_b[(nkb - 1) % SB], ((nkb - 1) / SB) & 1);
  fence_regs(acc);
  wg_fence();
  issue_pv(nkb - 1);
  wg_wait<0>();
  fence_regs(acc);
  release(&empty_b[(nkb - 1) % SB]);

  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) den[h] = fmaxf(l[h], 1e-30f);
#pragma unroll
  for (int j = 0; j < COLS / 8; ++j) {
    acc[4 * j] /= den[0];
    acc[4 * j + 1] /= den[0];
    acc[4 * j + 2] /= den[1];
    acc[4 * j + 3] /= den[1];
  }
  store_cols<COLS, T>(o + ((size_t)bh * sq + w0) * d + col0, d, acc, sq - w0,
                      ncols);
  if (chunk == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rows[h] < sq)
        lse[(size_t)bh * sq + rows[h]] = m[h] * scale + logf(den[h]);
  }
}

// The float32 body (flash_common.cuh, namespace tf32), every head dim, d
// at run time: a block owns 128 query rows, two consumer warpgroups of 64,
// and one chunk of COLS of O's columns from col0 = chunk * COLS. For each
// key tile i of 64 keys it builds S_i = Q K_i^T over all d from the
// 32-column chunks of Q and K_i that the producer streams through ring A
// (one chunk of each a slot), then runs the online softmax of S_i and adds
// P_i V_i for its columns from V's [64 x COLS] tile in ring B. Every
// product is 3xTF32 (tf32::split): two correction products, then big *
// big.
// - S on wgmma (m64n64k8 .tf32): A is the warp's rows of Q's chunk, split
//   in registers; B must lie K-major in shared memory, as Q's and K's rows
//   do, and is read truncated, so K's chunk as TMA wrote it is its big
//   part. Its small parts go beside it in the slot, in the same swizzled
//   layout, written by the producer warpgroup's three idle warps once the
//   chunk lands (ready_a). On mma.sync instead, where every warp loads and
//   splits every K element itself, K1 took 1.15-1.26x as long on an H100
//   (PERF.md).
// - P V on mma.sync (m16n8k8 .tf32): wgmma's TF32 B cannot be MN-major,
//   which V's rows are for this product. P, the softmax of S's
//   accumulator, is the A operand without a shuffle: a lane holds columns
//   2t and 2t + 1 of its rows where the A fragment wants t and t + 4, so
//   P V takes each 8 keys in that order, key 2t as k = t and key 2t + 1 as
//   k = t + 4, and each lane loads V's rows 2t and 2t + 1 as its B
//   fragment, from the 128B-swizzled rows TMA writes (element (r, c) in
//   16-byte unit (c / 4) ^ (r % 8) of row r), which puts the 32 lanes of
//   each load on 32 banks.
// - A warpgroup whose rows all lie above a causal tile, or past the end of
//   the queries, only waits for the tile's slots and releases them.
// The warpgroups do not take turns; each warp keeps a V box's 4 P V
// accumulators in flight, added to O once the tile's keys are done (pv
// below says why the sum leaves the tensor cores there). Every
// block of a row block computes S in the same order, so their m and l
// agree bit for bit; chunk 0's blocks write lse. V's boxes that lie past d
// are not loaded: they feed only O's columns past d, which are not stored.
template <typename T, int COLS>
__global__ void __launch_bounds__(tf32::THREADS, 1)
fwd_kernel_tf32(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                T* __restrict__ o, float* __restrict__ lse, int sq, int sk,
                int d, int causal, float scale) {
  static_assert(std::is_same<T, float>::value, "the float32 body");
  using namespace sm90;
  constexpr int BQ = tf32::ROWS, BK = tf32::TILE, C = tf32::CHUNK;
  constexpr int SA = tf32::stages(COLS), SB = tf32::V_STAGES;
  constexpr uint32_t Q_BYTES = BQ * C * 4;  // a chunk of Q
  constexpr uint32_t K_BYTES = BK * C * 4;  // one of K_i, and its small parts
  constexpr uint32_t A_BYTES = Q_BYTES + 2 * K_BYTES;
  constexpr uint32_t BOX = BK * C * 4;      // 32 of V_i's columns
  constexpr uint32_t B_BYTES = BOX * (COLS / C);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* ring_a = aligned_smem(smem_raw);
  uint8_t* ring_b = ring_a + SA * A_BYTES;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(ring_b + SB * B_BYTES);
  uint64_t* ready_a = full_a + SA;  // K_i's small parts are written
  uint64_t* empty_a = ready_a + SA;
  uint64_t* full_b = empty_a + SA;
  uint64_t* empty_b = full_b + SB;

  // The grid in groups of HEADS heads, as fwd_kernel_sm90_wide's: within a
  // group the q-blocks from the last (the most causal work), all heads and
  // chunks of the group at each.
  constexpr int HEADS = 12;
  const int nd = d / C, nc = (d + COLS - 1) / COLS;
  const int nqb = (sq + BQ - 1) / BQ, per = nqb * nc;
  const int g0 = blockIdx.x / (HEADS * per) * HEADS;
  const int r = blockIdx.x - g0 * per;
  const int heads = min(HEADS, (int)gridDim.x / per - g0);
  const int chunk = r % nc, rq = r / nc;
  const int bh = g0 + rq % heads;
  const int q0 = (nqb - 1 - rq / heads) * BQ;
  const int col0 = chunk * COLS, ncols = min(COLS, d - col0);
  int nkb = (sk + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + BQ - 1) / BK + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(&full_a[s], 1);
      mbar_init(&ready_a[s], tf32::CONVERTERS);
      mbar_init(&empty_a[s], tf32::WARPS);  // one arrival per consumer warp
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(&full_b[s], 1);
      mbar_init(&empty_b[s], tf32::WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= tf32::WARPS) {  // the producer warpgroup
    reg_dealloc<tf32::PRODUCER_REGS>();
    if (warp == tf32::WARPS && lane == 0) {
      const int nbox = ncols / C;
      int s = 0, ph = 0;  // ring A's next slot, and its use's parity
      for (int i = 0, n = 0; i < nkb; ++i) {
        for (int c = 0; c < nd; ++c, ++n) {  // Q's and K_i's chunk c
          if (n >= SA) mbar_wait(&empty_a[s], ph ^ 1);
          uint8_t* slot = ring_a + s * A_BYTES;
          mbar_expect_tx(&full_a[s], Q_BYTES + K_BYTES);
          tma_load(slot, &map_q, &full_a[s], C * c, q0, bh);
          tma_load(slot + Q_BYTES, &map_k, &full_a[s], C * c, i * BK, bh);
          if (++s == SA) s = 0, ph ^= 1;
        }
        const int b = i % SB;  // V_i's columns of this chunk
        if (i >= SB) mbar_wait(&empty_b[b], (i / SB - 1) & 1);
        mbar_expect_tx(&full_b[b], nbox * BOX);
        for (int j = 0; j < nbox; ++j)
          tma_load(ring_b + b * B_BYTES + j * BOX, &map_v, &full_b[b],
                   col0 + C * j, i * BK, bh);
      }
    } else if (warp > tf32::WARPS) {
      // The converters: once a slot's chunk of K_i lands, write the small
      // part of each element beside it, in the same swizzled layout, for
      // S's correction product big(Q) small(K).
      const int ct = threadIdx.x - (tf32::WARPS + 1) * 32;
      int s = 0, ph = 0;
      for (int n = 0; n < nkb * nd; ++n) {
        mbar_wait(&full_a[s], ph);
        float* kr = reinterpret_cast<float*>(ring_a + s * A_BYTES + Q_BYTES);
        for (int e = ct; e < (int)K_BYTES / 4; e += tf32::CONVERTERS * 32)
          kr[K_BYTES / 4 + e] = tf32::small_part(kr[e]);
        tf32::fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(&ready_a[s]);
        if (++s == SA) s = 0, ph ^= 1;
      }
    }
    return;
  }

  // Consumer warp `warp` owns rows w0 .. w0 + 15, its warpgroup rows
  // wg_row0 .. wg_row0 + 63.
  reg_alloc<tf32::CONSUMER_REGS>();
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + warp * 16, wg_row0 = q0 + (warp / 4) * 64;
  const float c2 = scale * LOG2E;  // raw scores to base-2 exponents

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[COLS / 2];
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2];  // S_i, then P_i: [16 x BK] across the warp
  float corr[2];

  auto release = [&](uint64_t* bar) {  // this warp is done with a slot
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // The float offset of column 4u + t in a swizzled row r with r % 8 == g
  // (this lane's rows of Q): unit u lies at u ^ g, so the offset is
  // (u << 2) ^ gt. gt and P V's tg below are made opaque where they are
  // used, so that the offsets built from them are not hoisted out of the
  // key loop into registers of their own (at COLS 256 those spilled).
  const int gt = (g << 2) | t;
  // S += Q_c K_c^T from one slot of ring A, on wgmma: A is this warp's
  // rows of Q's chunk, split in registers; B is K_c's chunk as TMA wrote
  // it (read truncated: its big part) and its small parts beside it. The
  // chunk's 12 products are one group (two groups, each k-step's A
  // fragments reusing one of two register sets, ran 3-5% slower on an
  // H100).
  auto s_chunk = [&](const uint8_t* slot) {
    const float* qs = reinterpret_cast<const float*>(slot) + warp * 16 * C;
    const int x = opaque(gt);
    uint32_t ab[C / 8][4], as[C / 8][4];
#pragma unroll
    for (int kk = 0; kk < C / 8; ++kk) {  // columns 8 kk .. 8 kk + 7
      const int c0 = (8 * kk) ^ x, c1 = (8 * kk + 4) ^ x;  // 8 kk + t, + 4
      tf32::split(qs[g * C + c0], ab[kk][0], as[kk][0]);
      tf32::split(qs[(g + 8) * C + c0], ab[kk][1], as[kk][1]);
      tf32::split(qs[g * C + c1], ab[kk][2], as[kk][2]);
      tf32::split(qs[(g + 8) * C + c1], ab[kk][3], as[kk][3]);
    }
    const uint64_t kd = k_major<BK, 64>(smem_u32(slot + Q_BYTES), 0);
    const uint64_t ksd = kd + (K_BYTES >> 4);  // the small parts
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C / 8; ++kk) {
      tf32::wgmma_rs(sc, as[kk], k_major_at<BK, 64>(kd, kk));
      tf32::wgmma_rs(sc, ab[kk], k_major_at<BK, 64>(ksd, kk));
      tf32::wgmma_rs(sc, ab[kk], k_major_at<BK, 64>(kd, kk));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
  };
  // O += P_i V_i for this chunk's columns, one of V's boxes (32 columns, 4
  // n-tiles) at a time: the box's products accumulate from 0 and are then
  // added to O in float32. The tensor cores' accumulator drops low bits as
  // it adds, so a sum it runs over every key shrinks with the sequence (O
  // accumulated on them directly sat at 0.35 of the 1e-4 limit at seq 2048
  // and broke a float32 GPT-2's gradient check at seq 8192 on an H100);
  // here each run is 24 products long, and the adds into O round to
  // nearest. Column 8 n + g of V's row r lies in unit 2 (n % 4) + g / 4 of
  // its box, at that ^ (r % 8): in this lane's rows 2t and 2t + 1 of each
  // 8, at float ((n % 4) << 3) ^ tg and that ^ 4.
  auto pv = [&](const uint8_t* tile) {
    const float* vs = reinterpret_cast<const float*>(tile) + 2 * t * C;
    const int tg = opaque((t << 3) | g);
#pragma unroll
    for (int box = 0; box < COLS / C; ++box) {
      float part[C / 2];
#pragma unroll
      for (int e = 0; e < C / 2; ++e) part[e] = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {  // keys 8 j .. 8 j + 7
        uint32_t ab[4], as[4];
        tf32::split(sc[4 * j], ab[0], as[0]);      // row g,     key 2t
        tf32::split(sc[4 * j + 2], ab[1], as[1]);  // row g + 8, key 2t
        tf32::split(sc[4 * j + 1], ab[2], as[2]);  // row g,     key 2t + 1
        tf32::split(sc[4 * j + 3], ab[3], as[3]);  // row g + 8, key 2t + 1
        const float* v0 = vs + (box * BK + 8 * j) * C;  // V's row 8 j + 2t
#pragma unroll
        for (int n = 0; n < C / 8; ++n) {  // the box's columns 8 n ..
          const int e = (n << 3) ^ tg;
          uint32_t bb[2], bs[2];
          tf32::split(v0[e], bb[0], bs[0]);
          tf32::split(v0[C + (e ^ 4)], bb[1], bs[1]);
          tf32::mma3(&part[4 * n], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int e = 0; e < C / 2; ++e) acc[box * (C / 2) + e] += part[e];
    }
  };
  // Online softmax on the raw scores of the tile at key k0, in base 2, as
  // in fwd_kernel_sm90, masking only a tile that crosses the diagonal or
  // the end of the keys.
  auto softmax = [&](int k0) {
    if (k0 + BK > sk || (causal && k0 + BK - 1 > w0)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = w0 + g + 8 * (e >> 1);
          if (!(col < sk && (!causal || col <= row))) sc[4 * j + e] = NEG_INF;
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

  int s = 0, ph = 0;  // ring A's slot in use and its use's parity
  for (int i = 0; i < nkb; ++i) {
    const int k0 = i * BK;
    // Some key of the tile is unmasked for some row of this warpgroup.
    const bool live = wg_row0 < sq && !(causal && k0 > wg_row0 + 63);
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    for (int c = 0; c < nd; ++c) {
      mbar_wait(&full_a[s], ph);
      mbar_wait(&ready_a[s], ph);
      if (live) s_chunk(ring_a + s * A_BYTES);
      release(&empty_a[s]);
      if (++s == SA) s = 0, ph ^= 1;
    }
    const int b = i % SB;
    mbar_wait(&full_b[b], (i / SB) & 1);
    if (live) {
      softmax(k0);
#pragma unroll
      for (int j = 0; j < COLS / 8; ++j) {
        acc[4 * j] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }
      pv(ring_b + b * B_BYTES);
    }
    release(&empty_b[b]);
  }

  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) den[h] = fmaxf(l[h], 1e-30f);
#pragma unroll
  for (int j = 0; j < COLS / 8; ++j) {
    acc[4 * j] /= den[0];
    acc[4 * j + 1] /= den[0];
    acc[4 * j + 2] /= den[1];
    acc[4 * j + 3] /= den[1];
  }
  store_cols<COLS, T>(o + ((size_t)bh * sq + w0) * d + col0, d, acc, sq - w0,
                      ncols);
  if (chunk == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (w0 + g + 8 * h < sq)
        lse[(size_t)bh * sq + w0 + g + 8 * h] = m[h] * scale + logf(den[h]);
  }
}

// The float32 forward at head dim d: maps of 32-column boxes (Q's of 128
// rows, K's and V's of 64), the grid one block per (row block, chunk of
// tf32::cols(d, row blocks) of O's columns).
template <int COLS>
static int fwd_tf32_launch(const CUtensorMap& mq, const CUtensorMap& mk,
                           const CUtensorMap& mv, void* o, void* lse, int bh,
                           int sq, int sk, int d, int causal, float scale,
                           cudaStream_t stream) {
  const dim3 grid(bh * ((sq + tf32::ROWS - 1) / tf32::ROWS) *
                  ((d + COLS - 1) / COLS));
  return launch(fwd_kernel_tf32<float, COLS>, grid, tf32::THREADS,
                (size_t)tf32::smem(COLS), stream, mq, mk, mv,
                static_cast<float*>(o), static_cast<float*>(lse), sq, sk, d,
                causal, scale);
}

static int fwd_tf32(const void* q, const void* k, const void* v, void* o,
                    void* lse, int bh, int sq, int sk, int d, int causal,
                    float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = sm90::make_map_cols<float>(&mq, q, bh, sq, d, tf32::ROWS,
                                       tf32::CHUNK);
  if (!err)
    err = sm90::make_map_cols<float>(&mk, k, bh, sk, d, tf32::TILE,
                                     tf32::CHUNK);
  if (!err)
    err = sm90::make_map_cols<float>(&mv, v, bh, sk, d, tf32::TILE,
                                     tf32::CHUNK);
  if (err) return err;
  const long blocks = (long)bh * ((sq + tf32::ROWS - 1) / tf32::ROWS);
  switch (tf32::cols(d, blocks)) {
    case 32:
      return fwd_tf32_launch<32>(mq, mk, mv, o, lse, bh, sq, sk, d, causal,
                                 scale, stream);
    case 64:
      return fwd_tf32_launch<64>(mq, mk, mv, o, lse, bh, sq, sk, d, causal,
                                 scale, stream);
    case 128:
      return fwd_tf32_launch<128>(mq, mk, mv, o, lse, bh, sq, sk, d, causal,
                                  scale, stream);
    case 256:
      return fwd_tf32_launch<256>(mq, mk, mv, o, lse, bh, sq, sk, d, causal,
                                  scale, stream);
  }
  return FLASH_ERR_UNSUPPORTED;
}

// Shared memory of each body (ray_tpu_torch/ops/attention.py's
// kernel_smem_bytes mirrors these).
template <typename T, int D>
static size_t fwd_smem() {
  if constexpr (hopper_body<T, D>()) {
    using Tl = sm90::FwdTiles<D>;
    // Q, the slots and their mbarriers: two per slot pair, four above d
    // 128, where K and V have barriers of their own.
    constexpr int bars = 1 + (D > 128 ? 4 : 2) * Tl::STAGES;
    return sm90::tile_bytes<Tl::ROWS, D>() +
           Tl::STAGES * 2 * sm90::tile_bytes<Tl::TILE, D>() +
           bars * sizeof(uint64_t) + sm90::SMEM_ALIGN;
  } else {
    return tf32::smem(tf32::cols(D, tf32::FILL));
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
    return fwd_tf32(q, k, v, o, lse, bh, sq, sk, D, causal, scale, stream);
  }
}

// Shared memory of the 16-bit body above d 256: ring A's slots (a chunk
// of Q and one of K each), ring B's (V's [64 x COLS] tiles), a full and an
// empty mbarrier a slot, and the swizzle's alignment.
template <int COLS>
static size_t fwd_smem_sm90_wide() {
  using Tl = sm90::WideFwdTiles;
  return Tl::STAGES * sm90::tile_bytes<Tl::ROWS + Tl::TILE, 64>() +
         Tl::V_STAGES * sm90::tile_bytes<Tl::TILE, COLS>() +
         2 * (Tl::STAGES + Tl::V_STAGES) * sizeof(uint64_t) + sm90::SMEM_ALIGN;
}

template <typename T, int COLS>
static int fwd_sm90_wide(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int sq, int sk, int d,
                         int causal, float scale, cudaStream_t stream) {
  using Tl = sm90::WideFwdTiles;
  CUtensorMap mq, mk, mv;
  int err = sm90::make_map_cols<T>(&mq, q, bh, sq, d, Tl::ROWS, 64);
  if (!err) err = sm90::make_map_cols<T>(&mk, k, bh, sk, d, Tl::TILE, 64);
  if (!err) err = sm90::make_map_cols<T>(&mv, v, bh, sk, d, Tl::TILE, 64);
  if (err) return err;
  const dim3 grid(bh * ((sq + Tl::ROWS - 1) / Tl::ROWS) *
                  sm90::wide_chunks(d));
  return launch(fwd_kernel_sm90_wide<T, COLS>, grid, sm90::THREADS,
                fwd_smem_sm90_wide<COLS>(), stream, mq, mk, mv,
                static_cast<T*>(o), static_cast<float*>(lse), sq, sk, d,
                causal, scale);
}

// Above d 256: the Hopper body in 16 bits (O's column chunks 192 or 256
// wide), the 3xTF32 one in float32.
template <typename T>
static int fwd_wide(const void* q, const void* k, const void* v, void* o,
                    void* lse, int bh, int sq, int sk, int d, int causal,
                    float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (sm90::wide_cols(d) == 192)
      return fwd_sm90_wide<T, 192>(q, k, v, o, lse, bh, sq, sk, d, causal,
                                   scale, stream);
    return fwd_sm90_wide<T, 256>(q, k, v, o, lse, bh, sq, sk, d, causal,
                                 scale, stream);
  } else {
    return fwd_tf32(q, k, v, o, lse, bh, sq, sk, d, causal, scale, stream);
  }
}

template <typename T>
static int fwd_wide_smem(int d) {
  if constexpr (sizeof(T) == 2)
    return (int)(sm90::wide_cols(d) == 192 ? fwd_smem_sm90_wide<192>()
                                           : fwd_smem_sm90_wide<256>());
  else
    return tf32::smem(tf32::cols(d, tf32::FILL));
}

// q [bh, sq, d], k and v [bh, sk, d] -> o [bh, sq, d], lse [bh, sq] float32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int sq, int sk, int d,
                         int causal, float scale, int dtype, void* stream) {
  if (int err = bind_device()) return err;
  if (wide_head_dim(d))
    FLASH_DISPATCH_WIDE(fwd_wide, dtype, q, k, v, o, lse, bh, sq, sk, d,
                        causal, scale, static_cast<cudaStream_t>(stream));
  FLASH_DISPATCH(fwd, dtype, d, q, k, v, o, lse, bh, sq, sk, causal, scale,
                 static_cast<cudaStream_t>(stream));
}

// Shared memory one block of flash_fwd takes at this head dim and dtype.
extern "C" int flash_fwd_smem(int d, int dtype) {
  if (wide_head_dim(d)) FLASH_DISPATCH_WIDE(fwd_wide_smem, dtype, d);
  FLASH_DISPATCH(fwd_smem, dtype, d, );
}
