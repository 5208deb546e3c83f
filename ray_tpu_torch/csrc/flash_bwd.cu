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
// dQ, bf16 and float16 at d <= 256 (bwd_dq_kernel_sm90): the dK/dV design
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
// bf16 and float16 at d 192 and 256. Bounds at bh = 24, seq = 2048,
// causal: dQ about 58 (d 192) and 77 GFLOP (d 256), 59 and 78 us at 989
// TFLOP/s; dK/dV 77 and 103 GFLOP, 78 and 104 us: all bound by operations,
// as the d <= 128 instances at long sequences. What changes with the head
// dim is what fits:
// - dQ (bwd_dq_kernel_sm90, the body above): Q, dO and O of 128 rows would
//   take 144 KB at d 192 and 192 KB at d 256, so O stays in device memory
//   and the prologue reads its rows for delta from there, the lanes taking
//   the columns that match dO's swizzled pieces. Q and dO stay resident
//   (96 and 128 KB), and K and V stream in tiles of 32 keys through 5 and 3
//   slots. dQ's accumulator is D / 2 = 96 or 128 floats a thread, beside S
//   and dP (16 each) and dS's A fragments (8); dS K is issued as products
//   of 128 columns (and one of 64 at d 192), since the Wgmma shapes stop at
//   N = 128.
// - dK/dV (bwd_dkv_kernel_sm90_split): one warpgroup holding dK and dV of
//   its 64 keys needs D floats a thread, 192 or 256, before S^T and dP^T:
//   more than the 232 registers a consumer thread gets. Both consumer
//   warpgroups own the same 64 keys instead, and each runs half of every
//   tile's products: warpgroup 0 computes S^T = K Q^T, forms P^T, hands it
//   in float32 to warpgroup 1 through a shared-memory buffer and adds
//   dV += P^T dO; warpgroup 1 computes dP^T = V dO^T, forms dS^T with the
//   P^T it reads and adds dK += dS^T Q. Each holds one D-wide accumulator
//   (D / 2 floats a thread) and one [64 x 64] tile of scores (32), and
//   feeds its second product from registers, as the d <= 128 body does.
//   FlashAttention-3 splits dK's and dV's columns between the warpgroups
//   and each computes S^T and dP^T for half of the queries, exchanging P^T
//   and dS^T; that was written first and ran slower at d 256 on an H100:
//   its m64n32 products read as many bytes of shared memory as they
//   compute, it met at a barrier every tile, and at d 192 the column halves
//   (96) would start inside a 64-column swizzle atom of the MN-major B. The
//   handoff needs one direction only, so warpgroup 0 may run a tile ahead:
//   two buffers, each with a full and an empty mbarrier. K and V stay
//   resident (48 and 64 KB), and Q and dO stream in tiles of 64 queries
//   through 3 slots at d 192 and 2 at d 256.
//
// bf16 and float16 at d > 256, a multiple of 64 (bwd_dq_kernel_sm90_wide,
// bwd_dkv_kernel_sm90_wide): the Hopper machinery with d at run time, on
// the wide forward's answer (flash_fwd.cu). Neither a D-wide accumulator
// nor a resident row block of Q, dO, K or V fits there, so the gradients'
// columns are split over the grid in chunks of 192 or 256 (sm90::
// WideDqTiles, WideDkvTiles): each block owns one chunk, computes S and dP
// over all d from 64-column chunks that stream through ring A, and reads
// its chunk's operand of the last product through ring B. dQ: 128 query
// rows a block, as bwd_dq_kernel_sm90. dK/dV: 64 keys a block, the two
// warpgroups split as in bwd_dkv_kernel_sm90_split. With c chunks, S and
// dP are computed c times: dQ does (2c + 1) / 3 of the minimum FLOPs and
// dK/dV (c + 1) / 2 (1.67x and 1.5x at d 512, 3x and 2.5x at d 1024). Bound
// at bh 24, seq 2048, causal: dQ 116, 155 and 309 GFLOP at d 384, 512 and
// 1024 (0.117, 0.156 and 0.313 ms at 989 TFLOP/s), dK/dV 155, 206 and 413
// GFLOP (0.156, 0.209 and 0.417 ms); by operations.
//
// float32 at every head dim (bwd_dq_kernel_tf32, bwd_dkv_kernel_tf32), d a
// run-time argument: the forward's float32 shape (fwd_kernel_tf32) in 3xTF32, a
// TMA ring of 32-column chunks, the gradients' columns split over the grid
// (flash_common.cuh, namespace tf32, gives the tiles and why). A block owns 128
// rows (queries; keys), 64 a consumer warpgroup, and each warpgroup builds dP
// (dP^T) and then S (S^T) of a streamed tile of 64 rows on wgmma in two passes
// over d, dP waiting in shared memory, and runs the products that contract over
// the streamed rows (dS K; P^T dO and dS^T Q) on mma.sync from ring B's [64 x
// COLS] tiles (COLS up to 128), each tile's share summed from 0 and added to
// the gradient in float32; dQ's dP splits its operands to nearest, and delta is
// summed in double, since dQ holds dP's error whole at a causal row's first
// key. Bounds at bh 24, seq 2048, causal, at 165 TFLOP/s (the tensor cores'
// TF32 rate over its three products): dQ 19.3, 38.7, 58.0 and 77.4 GFLOP at d
// 64, 128, 192 and 256 (0.117, 0.234, 0.352 and 0.469 ms), dK/dV 25.8, 51.6,
// 77.4 and 103.1 GFLOP (0.156, 0.313, 0.469 and 0.625 ms), against 76 to 302 MB
// of inputs and outputs (0.023 to 0.090 ms at 3.35 TB/s): by operations, as
// above 256 (d 704: 1.289 and 1.719 ms).

#include "flash_common.cuh"

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(sm90::THREADS, 1)
bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_o,
                   const T* __restrict__ out, const float* __restrict__ lse,
                   float* __restrict__ delta, T* __restrict__ dq, int sq,
                   int sk, int causal, float scale) {
  using namespace sm90;
  constexpr int BQ = DqTiles<D>::ROWS, BK = DqTiles<D>::TILE;
  constexpr int STAGES = DqTiles<D>::STAGES;
  // O stays in shared memory beside Q and dO up to D 128; above, the
  // prologue reads it from device memory (`out`).
  constexpr bool RESIDENT_O = D <= 128;
  constexpr uint32_t Q_BYTES = tile_bytes<BQ, D>();
  constexpr uint32_t KV_BYTES = tile_bytes<BK, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* sq_tile = aligned_smem(smem_raw);
  uint8_t* sdo_tile = sq_tile + Q_BYTES;
  uint8_t* so_tile = sdo_tile + Q_BYTES;
  // slot s: K at 2s, V at 2s + 1
  uint8_t* ring = RESIDENT_O ? so_tile + Q_BYTES : so_tile;
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
      mbar_expect_tx(own_full, (RESIDENT_O ? 3 : 2) * Q_BYTES);
      tma_tile<BQ, D>(sdo_tile, &map_do, own_full, q0, bh);
      if constexpr (RESIDENT_O)
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
  constexpr int RB = row_bytes<D>(), PART = RB / 4;  // bytes of a lane
  if constexpr (RESIDENT_O) {
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
  } else {
    // O from device memory: the stored 16-byte piece ph of tile row rr
    // holds the row's columns 8 (ph ^ rr % 8).. of its chunk (the 128-byte
    // swizzle), so each lane reads O's matching columns. Rows past the end
    // read nothing.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r0 + g + 8 * h;
      const T* orow = out + ((size_t)bh * sq + rows[h]) * D;
      float sum = 0.f;
      if (rows[h] < sq) {
#pragma unroll
        for (int c = 0; c < D / chunk_cols<D>(); ++c)
#pragma unroll
          for (int b = 0; b < PART; b += 16) {
            const int ph = (t * PART + b) / 16;
            sum = dot8<T>(*reinterpret_cast<const uint4*>(
                              sdo_tile + c * BQ * RB + rr * RB + ph * 16),
                          *reinterpret_cast<const uint4*>(
                              orow + c * 64 + (ph ^ (rr & 7)) * 8),
                          sum);
          }
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
    if constexpr (D == 256) {
      // Hoisted out of the loop, the 32 descriptors of Q and dO spill at
      // d 256: rebuilt each turn from an opaque base, by one add each.
      const uint64_t qd = k_major<BQ, D>(opaque(q_addr), 0);
      const uint64_t dd = k_major<BQ, D>(opaque(do_addr), 0);
      const uint64_t kd = k_major<BK, D>(slot(i), 0);
      const uint64_t vd = k_major<BK, D>(slot(i) + KV_BYTES, 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BK, T>::ss(s, k_major_at<BQ, D>(qd, kk),
                         k_major_at<BK, D>(kd, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BK, T>::ss(dp, k_major_at<BQ, D>(dd, kk),
                         k_major_at<BK, D>(vd, kk), kk > 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BK, T>::ss(s, k_major<BQ, D>(q_addr, kk),
                         k_major<BK, D>(slot(i), kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BK, T>::ss(dp, k_major<BQ, D>(do_addr, kk),
                         k_major<BK, D>(slot(i) + KV_BYTES, kk), kk > 0);
    }
    wg_commit();
  };
  auto issue_dq = [&](int i) {  // dQ += dS K, K read MN-major
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (D <= 128)
        Wgmma<D, T>::rs(acc, dsa[kk], mn_major<BK, D>(slot(i), kk), 1);
      else
        WgmmaCols<D, T>::rs(acc, dsa[kk], mn_major<BK, D>(slot(i), kk), 1);
    }
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

// dK/dV, bf16 and float16 at d 192 and 256 (the file's header says why):
// both consumer warpgroups own the block's 64 keys. Warpgroup 0 computes
// S^T and P^T of each streamed tile, hands P^T in float32 to warpgroup 1
// through a shared-memory buffer and adds dV += P^T dO; warpgroup 1
// computes dP^T, forms dS^T = P^T (dP^T - delta) scale with the P^T it
// reads and adds dK += dS^T Q. P^T and dS^T feed their products from
// registers. The handoff is two buffers, each with a full and an empty
// mbarrier of 128 arrivals (every thread of one warpgroup).
template <typename T, int D>
__global__ void __launch_bounds__(sm90::THREADS, 1)
bwd_dkv_kernel_sm90_split(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int sq,
                          int sk, int causal, float scale) {
  using namespace sm90;
  constexpr int BKEY = DkvTiles<D>::ROWS, BQ = DkvTiles<D>::TILE;
  constexpr int STAGES = DkvTiles<D>::STAGES;
  static_assert(BKEY == 64, "both warpgroups own the block's 64 keys");
  constexpr uint32_t KV_BYTES = tile_bytes<BKEY, D>();
  constexpr uint32_t Q_BYTES = tile_bytes<BQ, D>();
  constexpr int P_VEC = BQ / 8;  // float4 of P^T a thread holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* sk_tile = aligned_smem(smem_raw);
  uint8_t* sv_tile = sk_tile + KV_BYTES;
  uint8_t* ring = sv_tile + KV_BYTES;  // slot s: Q at 2s, dO at 2s + 1
  // P^T handoff, two buffers of [P_VEC][128 threads] float4: each thread of
  // warpgroup 1 reads what the same thread of warpgroup 0 wrote, since both
  // hold [64 x BQ] accumulators in one layout.
  float4* pbuf = reinterpret_cast<float4*>(ring + STAGES * 2 * Q_BYTES);
  float* lse_s = reinterpret_cast<float*>(pbuf + 2 * P_VEC * WG_THREADS);
  float* delta_s = lse_s + STAGES * BQ;  // [STAGES][BQ] each
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + STAGES * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* p_full = empty + STAGES;  // [2] each
  uint64_t* p_empty = p_full + 2;

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
    for (int b = 0; b < 2; ++b) {
      mbar_init(&p_full[b], WG_THREADS);
      mbar_init(&p_empty[b], WG_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= PRODUCER_WARP) {  // as in bwd_dkv_kernel_sm90
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

  // Consumer warpgroup wg: 0 accumulates dV, 1 dK, over the block's keys;
  // each warp holds 16 of them.
  reg_alloc<CONSUMER_REGS>();
  const int wg = warp / 4, tid = threadIdx.x % WG_THREADS;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = k0 + (warp % 4) * 16;  // this warp's first key row
  const int keys[2] = {w0 + g, w0 + g + 8};
  const float c2 = scale * LOG2E;

  float acc[D / 2];  // dV or dK, [64 x D] across the warpgroup
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float x[BQ / 2];          // S^T, then P^T (wg 0); dP^T, then dS^T (wg 1)
  uint32_t xa[BQ / 16][4];  // P^T or dS^T as A fragments

  auto slot = [&](int i) {
    return smem_u32(ring + (i % STAGES) * 2 * Q_BYTES);
  };
  auto release = [&](int i) {  // this warp is done with tile i's slot
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % STAGES]);
  };
  // S^T = K Q^T (wg 0) or dP^T = V dO^T (wg 1), K-major as stored; then,
  // after the previous tile's product, the whole [64 x BQ] tile is in x.
  auto scores = [&](int i) {
    const uint64_t a =
        k_major<BKEY, D>(opaque(smem_u32(wg == 0 ? sk_tile : sv_tile)), 0);
    const uint64_t b = k_major<BQ, D>(slot(i) + wg * Q_BYTES, 0);
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ, T>::ss(x, k_major_at<BKEY, D>(a, kk),
                       k_major_at<BQ, D>(b, kk), kk > 0);
    wg_commit();
    wg_wait<0>();  // the scores, and tile i - 1's dV or dK product
    fence_regs(x);
    fence_regs(acc);
    if (i > 0) release(i - 1);
  };
  // dV += P^T dO (wg 0) or dK += dS^T Q (wg 1), B MN-major from the slot.
  auto product = [&](int i) {
    to_a_frags<BQ, T>(xa, x);
    const uint32_t b = slot(i) + (wg == 0 ? Q_BYTES : 0);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      WgmmaCols<D, T>::rs(acc, xa[kk], mn_major<BQ, D>(b, kk), 1);
    wg_commit();
  };

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int q0 = (qb0 + i) * BQ, s = i % STAGES, b = i & 1;
    float4* buf = pbuf + b * P_VEC * WG_THREADS + tid;
    scores(i);
    if (wg == 0) {
      // P^T = 2^(S^T c2 - lse log2 e). Only tiles that cross the diagonal
      // or either sequence's end are masked, in a branch of their own: a
      // masked score becomes -1e30, whose probability is 0.
      if (q0 + BQ > sq || k0 + BKEY > sk || (causal && q0 < k0 + BKEY - 1)) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q0 + 8 * j + 2 * t + (e & 1), key = keys[e >> 1];
            if (!(q < sq && key < sk && (!causal || key <= q)))
              x[4 * j + e] = NEG_INF;
          }
      }
      const float* lse2 = lse_s + s * BQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[4 * j + e] = fast_exp2(
              fmaf(x[4 * j + e], c2, -lse2[8 * j + 2 * t + (e & 1)]));
      if (i >= 2) mbar_wait(&p_empty[b], ((i >> 1) - 1) & 1);
#pragma unroll
      for (int j = 0; j < P_VEC; ++j)
        buf[j * WG_THREADS] =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      mbar_arrive(&p_full[b]);
    } else {
      // dS^T = P^T (dP^T - delta) scale, P^T from warpgroup 0.
      const float* dlt = delta_s + s * BQ;
      mbar_wait(&p_full[b], (i >> 1) & 1);
#pragma unroll
      for (int j = 0; j < P_VEC; ++j) {
        const float4 p = buf[j * WG_THREADS];
        const float d0 = dlt[8 * j + 2 * t], d1 = dlt[8 * j + 2 * t + 1];
        x[4 * j] = p.x * (x[4 * j] - d0) * scale;
        x[4 * j + 1] = p.y * (x[4 * j + 1] - d1) * scale;
        x[4 * j + 2] = p.z * (x[4 * j + 2] - d0) * scale;
        x[4 * j + 3] = p.w * (x[4 * j + 3] - d1) * scale;
      }
      if (i + 2 < n_iter) mbar_arrive(&p_empty[b]);
    }
    product(i);
  }
  if (n_iter > 0) {
    wg_wait<0>();
    fence_regs(acc);
    release(n_iter - 1);
  }
  store_rows<D, T>((wg == 0 ? dv : dk) + ((size_t)bh * sk + w0) * D, acc,
                   sk - w0);
}

// Shared by the two 16-bit bodies above d 256: the grid runs through
// groups of HEADS heads, within a group through the row blocks (the most
// causal work first: the last q-block for dQ, the first key block for
// dK/dV), all heads and column chunks of the group at each; the chunks of
// one row block are neighbours, so they read the same chunks of Q, K, V
// and dO from L2 at about the same time, as in fwd_kernel_sm90_wide.
struct WideBlock {
  int bh, row0, chunk;
};
__device__ __forceinline__ WideBlock wide_block(int n_rows, int nc,
                                                bool last_first) {
  constexpr int HEADS = 12;
  const int per = n_rows * nc;
  const int g0 = blockIdx.x / (HEADS * per) * HEADS;  // the group's first
  const int r = blockIdx.x - g0 * per;
  const int heads = min(HEADS, (int)gridDim.x / per - g0);
  const int rb = r / nc / heads;
  return {g0 + r / nc % heads, last_first ? n_rows - 1 - rb : rb, r % nc};
}

// dQ, bf16 and float16 above d 256 (sm90::WideDqTiles): a block owns 128
// query rows, two consumer warpgroups of 64, and one chunk of COLS of dQ's
// columns, from col0 = chunk * COLS. For each key tile i of 64 keys it
// builds S_i = Q K_i^T and dP_i = dO V_i^T over all d columns from the
// 64-column chunks of Q, dO, K_i and V_i in ring A (a slot released as
// soon as the next chunk's products are issued), forms P and dS in
// registers as bwd_dq_kernel_sm90 does, and adds dQ += dS_i K_i for its
// columns from K_i's [64 x COLS] tile in ring B. A warpgroup holds dQ's
// COLS / 2 floats beside S and dP of 64 keys (32 each): 192 at COLS 256,
// within the 240 registers a consumer thread gets here (sm90::
// WIDE_CONSUMER_REGS), so the dQ product is waited for before the next
// tile's S and dP start (dS's A fragments would add 16); the other
// warpgroup's products keep the tensor cores busy meanwhile. delta = rowsum(dO O) is summed in the
// prologue from device memory by every chunk's block in one order, so all
// agree bit for bit; chunk 0's blocks write it for the dK/dV kernel. K's
// boxes that lie past d are not loaded: they feed only dQ's columns past
// d, which are not stored.
template <typename T, int COLS>
__global__ void __launch_bounds__(sm90::THREADS, 1)
bwd_dq_kernel_sm90_wide(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const T* __restrict__ dout, const T* __restrict__ out,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq, int sq,
                        int sk, int d, int causal, float scale) {
  using namespace sm90;
  using Tl = WideDqTiles;
  constexpr int BQ = Tl::ROWS, BK = Tl::TILE;
  constexpr int SA = Tl::STAGES, SB = Tl::B_STAGES;
  constexpr uint32_t Q_BYTES = tile_bytes<BQ, 64>();  // a chunk of Q or dO
  constexpr uint32_t BOX = tile_bytes<BK, 64>();      // of K or V
  constexpr uint32_t A_BYTES = 2 * Q_BYTES + 2 * BOX;  // Q, dO, K, V
  constexpr uint32_t B_BYTES = tile_bytes<BK, COLS>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* ring_a = aligned_smem(smem_raw);
  uint8_t* ring_b = ring_a + SA * A_BYTES;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(ring_b + SB * B_BYTES);
  uint64_t* empty_a = full_a + SA;
  uint64_t* full_b = empty_a + SA;
  uint64_t* empty_b = full_b + SB;

  const int nd = d / 64, nc = wide_chunks(d);
  const WideBlock blk = wide_block((sq + BQ - 1) / BQ, nc, true);
  const int bh = blk.bh, q0 = blk.row0 * BQ, chunk = blk.chunk;
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
    reg_dealloc<WIDE_PRODUCER_REGS>();
    if (lane != 0) return;
    if (warp == PRODUCER_WARP) {  // ring A: chunk c of Q, dO, K_i and V_i
      int s = 0, ph = 0;
      for (int i = 0, n = 0; i < nkb; ++i)
        for (int c = 0; c < nd; ++c, ++n) {
          if (n >= SA) mbar_wait(&empty_a[s], ph ^ 1);
          uint8_t* slot = ring_a + s * A_BYTES;
          mbar_expect_tx(&full_a[s], A_BYTES);
          tma_load(slot, &map_q, &full_a[s], 64 * c, q0, bh);
          tma_load(slot + Q_BYTES, &map_do, &full_a[s], 64 * c, q0, bh);
          tma_load(slot + 2 * Q_BYTES, &map_k, &full_a[s], 64 * c, i * BK, bh);
          tma_load(slot + 2 * Q_BYTES + BOX, &map_v, &full_a[s], 64 * c,
                   i * BK, bh);
          if (++s == SA) s = 0, ph ^= 1;
        }
    } else if (warp == PRODUCER_WARP + 1) {  // ring B: K_i's chunk columns
      const int nbox = ncols / 64;
      for (int i = 0; i < nkb; ++i) {
        const int b = i % SB;
        if (i >= SB) mbar_wait(&empty_b[b], (i / SB - 1) & 1);
        mbar_expect_tx(&full_b[b], nbox * BOX);
        for (int j = 0; j < nbox; ++j)
          tma_load(ring_b + b * B_BYTES + j * BOX, &map_k, &full_b[b],
                   col0 + 64 * j, i * BK, bh);
      }
    }
    return;
  }

  // Consumer warpgroup wg owns rows q0 + 64 wg ..; each warp 16 of them.
  reg_alloc<WIDE_CONSUMER_REGS>();
  const int wg = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = q0 + wg * 64;
  const int w0 = wg_row0 + (warp % 4) * 16;  // this warp's first query row
  const int rows[2] = {w0 + g, w0 + g + 8};
  const float c2 = scale * LOG2E;  // raw scores to base-2 exponents

  // Each thread's two rows: lse in base 2, and delta = rowsum(dO * O), the
  // four lanes of a row each summing every fourth 16-byte piece of both
  // rows. Rows past the end read nothing.
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = 0.f;
    lse2[h] = 0.f;
    if (rows[h] < sq) {
      const size_t row = (size_t)bh * sq + rows[h];
      const uint4* a = reinterpret_cast<const uint4*>(dout + row * d);
      const uint4* b = reinterpret_cast<const uint4*>(out + row * d);
      for (int j = t; j < d / 8; j += 4) sum = dot8<T>(a[j], b[j], sum);
      lse2[h] = lse[row] * LOG2E;
    }
    dlt[h] = quad_sum(sum);
    if (chunk == 0 && t == 0 && rows[h] < sq)
      delta[(size_t)bh * sq + rows[h]] = dlt[h];
  }

  float acc[COLS / 2];  // dQ / scale, [64 x COLS] across the warpgroup
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) acc[i] = 0.f;
  float s[BK / 2], dp[BK / 2];  // S_i and dP_i, then dS_i in s
  uint32_t dsa[BK / 16][4];     // dS_i as A fragments

  auto release = [&](uint64_t* bar) {  // this warp is done with a slot
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // Ring A's slot in use, the parity of its use and the slot used before
  // it, counted as the producer counts them.
  int sa = 0, ph = 0, prev = 0;
  // S (+)= Q_c K_c^T and dP (+)= dO_c V_c^T from slot sa, all K-major (64
  // columns, one swizzled 128-byte row each).
  auto issue_sdp = [&](int accumulate) {
    const uint32_t slot = smem_u32(ring_a + sa * A_BYTES);
    const uint32_t own = wg * 64 * row_bytes<64>();  // this warpgroup's rows
    const uint64_t qd = k_major<64, 64>(slot + own, 0);
    const uint64_t dd = k_major<64, 64>(slot + Q_BYTES + own, 0);
    const uint64_t kd = k_major<BK, 64>(slot + 2 * Q_BYTES, 0);
    const uint64_t vd = k_major<BK, 64>(slot + 2 * Q_BYTES + BOX, 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<BK, T>::ss(s, k_major_at<64, 64>(qd, kk),
                       k_major_at<BK, 64>(kd, kk), accumulate | (kk > 0));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<BK, T>::ss(dp, k_major_at<64, 64>(dd, kk),
                       k_major_at<BK, 64>(vd, kk), accumulate | (kk > 0));
    wg_commit();
  };
  // P = 2^(S c2 - lse log2 e) and dS = P (dP - delta), in registers, as in
  // bwd_dq_kernel_sm90: only tiles that cross the diagonal or the end of
  // the keys are masked.
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

  for (int i = 0; i < nkb; ++i) {
    wg_fence();
    for (int c = 0; c < nd; ++c) {
      mbar_wait(&full_a[sa], ph);
      issue_sdp(c > 0);
      if (c > 0) {
        wg_wait<1>();
        release(&empty_a[prev]);
      }
      prev = sa;
      if (++sa == SA) sa = 0, ph ^= 1;
    }
    wg_wait<0>();
    release(&empty_a[prev]);
    fence_regs(s);
    fence_regs(dp);
    grads(i);
    to_a_frags<BK, T>(dsa, s);
    // dQ += dS_i K_i for this chunk's columns, K read MN-major; products
    // of 128 columns, then one of COLS - 128.
    const int b = i % SB;
    mbar_wait(&full_b[b], (i / SB) & 1);
    const uint32_t kb = smem_u32(ring_b + b * B_BYTES);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaCols<COLS, T>::rs(acc, dsa[kk], mn_major<BK, COLS>(kb, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    release(&empty_b[b]);
  }

#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) acc[i] *= scale;
  store_cols<COLS, T>(dq + ((size_t)bh * sq + w0) * d + col0, d, acc,
                      sq - w0, ncols);
}

// dK/dV, bf16 and float16 above d 256 (sm90::WideDkvTiles): a block owns
// 64 keys and one chunk of COLS of dK's and dV's columns; both consumer
// warpgroups share the keys, as in bwd_dkv_kernel_sm90_split. For each
// tile i of 64 queries, warpgroup 0 builds S^T_i = K Q_i^T and warpgroup 1
// dP^T_i = V dO_i^T over all d columns from the 64-column chunks of K, V,
// Q_i and dO_i in ring A; warpgroup 0 forms P^T and hands it in float32 to
// warpgroup 1 through a shared-memory buffer, then adds dV += P^T dO_i for
// its columns; warpgroup 1 forms dS^T = P^T (dP^T - delta) scale and adds
// dK += dS^T Q_i. The columns of Q_i and dO_i that the two products read,
// and the tile's lse and delta, come through ring B. Each warpgroup holds
// one accumulator of COLS / 2 floats, its [64 x 64] scores (32) and their
// A fragments (16), as at d 256. One handoff buffer is enough: warpgroup 0
// writes P^T_{i+1} only after a whole tile of chunks, and ring A keeps the
// warpgroups within STAGES chunks of each other.
template <typename T, int COLS>
__global__ void __launch_bounds__(sm90::THREADS, 1)
bwd_dkv_kernel_sm90_wide(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int sq,
                         int sk, int d, int causal, float scale) {
  using namespace sm90;
  using Tl = WideDkvTiles;
  constexpr int BKEY = Tl::ROWS, BQ = Tl::TILE;
  constexpr int SA = Tl::STAGES, SB = Tl::B_STAGES;
  static_assert(BKEY == 64 && BQ == 64, "one box of 64 rows a chunk");
  constexpr uint32_t BOX = tile_bytes<64, 64>();
  constexpr uint32_t A_BYTES = 4 * BOX;  // K, V, Q, dO
  constexpr uint32_t TB = tile_bytes<BQ, COLS>();  // Q's or dO's columns
  constexpr uint32_t B_BYTES = 2 * TB;
  constexpr int P_VEC = BQ / 8;  // float4 of P^T a thread holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* ring_a = aligned_smem(smem_raw);
  uint8_t* ring_b = ring_a + SA * A_BYTES;
  // P^T handoff, [P_VEC][128 threads] float4: each thread of warpgroup 1
  // reads what the same thread of warpgroup 0 wrote.
  float4* pbuf = reinterpret_cast<float4*>(ring_b + SB * B_BYTES);
  float* lse_s = reinterpret_cast<float*>(pbuf + P_VEC * WG_THREADS);
  float* delta_s = lse_s + SB * BQ;  // [SB][BQ] each
  uint64_t* full_a = reinterpret_cast<uint64_t*>(delta_s + SB * BQ);
  uint64_t* empty_a = full_a + SA;
  uint64_t* full_b = empty_a + SA;
  uint64_t* empty_b = full_b + SB;
  uint64_t* p_full = empty_b + SB;
  uint64_t* p_empty = p_full + 1;

  const int nd = d / 64, nc = wide_chunks(d);
  const WideBlock blk = wide_block((sk + BKEY - 1) / BKEY, nc, false);
  const int bh = blk.bh, k0 = blk.row0 * BKEY, chunk = blk.chunk;
  const int col0 = chunk * COLS, ncols = min(COLS, d - col0);
  // Causal: q-tiles that end before this block's first key add nothing.
  const int qb0 = causal ? k0 / BQ : 0;
  const int n_iter = max(0, (sq + BQ - 1) / BQ - qb0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(&full_a[s], 1);
      mbar_init(&empty_a[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(&full_b[s], 32);  // every lane of ring B's producer arrives
      mbar_init(&empty_b[s], CONSUMERS * 4);
    }
    mbar_init(p_full, WG_THREADS);
    mbar_init(p_empty, WG_THREADS);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= PRODUCER_WARP) {
    reg_dealloc<PRODUCER_REGS>();
    if (warp == PRODUCER_WARP && lane == 0) {  // ring A: chunk c of each
      int s = 0, ph = 0;
      for (int i = 0, n = 0; i < n_iter; ++i)
        for (int c = 0; c < nd; ++c, ++n) {
          if (n >= SA) mbar_wait(&empty_a[s], ph ^ 1);
          uint8_t* slot = ring_a + s * A_BYTES;
          const int q0 = (qb0 + i) * BQ;
          mbar_expect_tx(&full_a[s], A_BYTES);
          tma_load(slot, &map_k, &full_a[s], 64 * c, k0, bh);
          tma_load(slot + BOX, &map_v, &full_a[s], 64 * c, k0, bh);
          tma_load(slot + 2 * BOX, &map_q, &full_a[s], 64 * c, q0, bh);
          tma_load(slot + 3 * BOX, &map_do, &full_a[s], 64 * c, q0, bh);
          if (++s == SA) s = 0, ph ^= 1;
        }
    } else if (warp == PRODUCER_WARP + 1) {
      // Ring B: Q_i's and dO_i's chunk columns, and the tile's lse
      // (pre-multiplied by log2 e) and delta; rows past the end are masked
      // by the consumers.
      const int nbox = ncols / 64;
      for (int i = 0; i < n_iter; ++i) {
        const int b = i % SB, q0 = (qb0 + i) * BQ;
        if (i >= SB) mbar_wait(&empty_b[b], (i / SB - 1) & 1);
        for (int c = lane; c < BQ; c += 32) {
          const bool in = q0 + c < sq;
          lse_s[b * BQ + c] = in ? lse[q0 + c] * LOG2E : 0.f;
          delta_s[b * BQ + c] = in ? delta[q0 + c] : 0.f;
        }
        if (lane == 0) {
          uint8_t* slot = ring_b + b * B_BYTES;
          mbar_expect_tx(&full_b[b], 2 * nbox * BOX);
          for (int j = 0; j < nbox; ++j) {
            tma_load(slot + j * BOX, &map_q, &full_b[b], col0 + 64 * j, q0,
                     bh);
            tma_load(slot + TB + j * BOX, &map_do, &full_b[b], col0 + 64 * j,
                     q0, bh);
          }
        } else {
          mbar_arrive(&full_b[b]);  // after this lane's lse and delta stores
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: 0 accumulates dV, 1 dK, over the block's keys;
  // each warp holds 16 of them.
  reg_alloc<CONSUMER_REGS>();
  const int wg = warp / 4, tid = threadIdx.x % WG_THREADS;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = k0 + (warp % 4) * 16;  // this warp's first key row
  const int keys[2] = {w0 + g, w0 + g + 8};
  const float c2 = scale * LOG2E;

  float acc[COLS / 2];  // dV or dK, [64 x COLS] across the warpgroup
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) acc[i] = 0.f;
  float x[BQ / 2];          // S^T, then P^T (wg 0); dP^T, then dS^T (wg 1)
  uint32_t xa[BQ / 16][4];  // P^T or dS^T as A fragments

  auto release = [&](uint64_t* bar) {  // this warp is done with a slot
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  int sa = 0, ph = 0, prev = 0;  // ring A, counted as the producer counts
  // S^T (+)= K_c Q_c^T (wg 0) or dP^T (+)= V_c dO_c^T (wg 1) from slot sa,
  // K-major as stored.
  auto issue_x = [&](int accumulate) {
    const uint32_t slot = smem_u32(ring_a + sa * A_BYTES);
    const uint64_t a = k_major<BKEY, 64>(slot + wg * BOX, 0);
    const uint64_t b = k_major<BQ, 64>(slot + (2 + wg) * BOX, 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<BQ, T>::ss(x, k_major_at<BKEY, 64>(a, kk),
                       k_major_at<BQ, 64>(b, kk), accumulate | (kk > 0));
    wg_commit();
  };

  for (int i = 0; i < n_iter; ++i) {
    const int q0 = (qb0 + i) * BQ, b = i % SB;
    wg_fence();
    for (int c = 0; c < nd; ++c) {
      mbar_wait(&full_a[sa], ph);
      issue_x(c > 0);
      if (c > 0) {
        wg_wait<1>();
        release(&empty_a[prev]);
      }
      prev = sa;
      if (++sa == SA) sa = 0, ph ^= 1;
    }
    wg_wait<0>();
    release(&empty_a[prev]);
    fence_regs(x);
    mbar_wait(&full_b[b], (i / SB) & 1);
    if (wg == 0) {
      // P^T = 2^(S^T c2 - lse log2 e). Only tiles that cross the diagonal
      // or either sequence's end are masked: a masked score becomes -1e30,
      // whose probability is 0.
      if (q0 + BQ > sq || k0 + BKEY > sk || (causal && q0 < k0 + BKEY - 1)) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q0 + 8 * j + 2 * t + (e & 1), key = keys[e >> 1];
            if (!(q < sq && key < sk && (!causal || key <= q)))
              x[4 * j + e] = NEG_INF;
          }
      }
      const float* lse2 = lse_s + b * BQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[4 * j + e] = fast_exp2(
              fmaf(x[4 * j + e], c2, -lse2[8 * j + 2 * t + (e & 1)]));
      if (i > 0) mbar_wait(p_empty, (i - 1) & 1);
#pragma unroll
      for (int j = 0; j < P_VEC; ++j)
        pbuf[j * WG_THREADS + tid] =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      mbar_arrive(p_full);
    } else {
      // dS^T = P^T (dP^T - delta) scale, P^T from warpgroup 0.
      const float* dlt = delta_s + b * BQ;
      mbar_wait(p_full, i & 1);
#pragma unroll
      for (int j = 0; j < P_VEC; ++j) {
        const float4 p = pbuf[j * WG_THREADS + tid];
        const float d0 = dlt[8 * j + 2 * t], d1 = dlt[8 * j + 2 * t + 1];
        x[4 * j] = p.x * (x[4 * j] - d0) * scale;
        x[4 * j + 1] = p.y * (x[4 * j + 1] - d1) * scale;
        x[4 * j + 2] = p.z * (x[4 * j + 2] - d0) * scale;
        x[4 * j + 3] = p.w * (x[4 * j + 3] - d1) * scale;
      }
      if (i + 1 < n_iter) mbar_arrive(p_empty);
    }
    // dV += P^T dO_i (wg 0) or dK += dS^T Q_i (wg 1) for this chunk's
    // columns, B MN-major from ring B.
    to_a_frags<BQ, T>(xa, x);
    const uint32_t bt = smem_u32(ring_b + b * B_BYTES) + (wg == 0 ? TB : 0);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      WgmmaCols<COLS, T>::rs(acc, xa[kk], mn_major<BQ, COLS>(bt, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    release(&empty_b[b]);
  }
  store_cols<COLS, T>((wg == 0 ? dv : dk) + ((size_t)bh * sk + w0) * d + col0,
                      d, acc, sk - w0, ncols);
}

// dQ in float32 (flash_common.cuh, namespace tf32, says why this shape),
// every head dim, d at run time: a block owns 128 query rows, two consumer
// warpgroups of 64, and one chunk of COLS of dQ's columns from col0 =
// chunk * COLS. For each key tile i of 64 keys it builds dP_i = dO V_i^T
// over all d from the 32-column chunks of dO and V_i that the producer
// streams through ring A (one chunk of each a slot, V_i's small parts
// written beside it by the converters) and parks it in this thread's share
// of the P buffer; then S_i = Q K_i^T from the chunks of Q and K_i; forms
// P = 2^(S c2 - lse log2 e) and dS = P (dP - delta) in registers, masking
// only a tile that crosses the diagonal or the end of the keys; and adds
// dQ += dS_i K_i for its columns from K_i's [64 x COLS] tile in ring B.
// delta = rowsum(dO O) is summed in the prologue from device memory by
// every chunk's block in one order, so all agree bit for bit; chunk 0's
// blocks write it for the dK/dV kernel. A warpgroup whose rows all lie
// above a causal tile, or past the end of the queries, only waits for the
// tile's slots and releases them.
template <typename T, int COLS>
__global__ void __launch_bounds__(tf32::THREADS, 1)
bwd_dq_kernel_tf32(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const T* __restrict__ dout, const T* __restrict__ out,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   T* __restrict__ dq, int sq, int sk, int d, int causal,
                   float scale) {
  static_assert(std::is_same<T, float>::value, "the float32 body");
  static_assert(COLS <= tf32::DQ_WIDEST, "dQ fits in registers");
  using namespace sm90;
  constexpr int BQ = tf32::ROWS, BK = tf32::TILE, C = tf32::CHUNK;
  constexpr int SA = tf32::BWD_STAGES, SB = tf32::bwd_b_stages(COLS);
  constexpr uint32_t OWN = BQ * C * 4;     // a chunk of dO or Q
  constexpr uint32_t STR = BK * C * 4;     // one of V_i or K_i, or its
                                           // small parts
  constexpr uint32_t A_BYTES = OWN + 2 * STR;
  constexpr uint32_t B_BYTES = STR * (COLS / C);  // K_i's columns, in boxes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* ring_a = aligned_smem(smem_raw);
  uint8_t* ring_b = ring_a + SA * A_BYTES;
  float4* pbuf = reinterpret_cast<float4*>(ring_b + SB * B_BYTES);
  // Each owned row's lse (times log2 e) and delta, [BQ][2].
  float* rowstat = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(pbuf) + tf32::PBUF_BYTES);
  uint64_t* full_a = reinterpret_cast<uint64_t*>(rowstat + BQ * 2);
  uint64_t* ready_a = full_a + SA;  // the streamed chunk's small parts are in
  uint64_t* empty_a = ready_a + SA;
  uint64_t* full_b = empty_a + SA;
  uint64_t* empty_b = full_b + SB;

  const int nd = d / C, nc = (d + COLS - 1) / COLS;
  const WideBlock blk = wide_block((sq + BQ - 1) / BQ, nc, true);
  const int bh = blk.bh, q0 = blk.row0 * BQ, chunk = blk.chunk;
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
      int s = 0, ph = 0;  // ring A's next slot, and its use's parity
      for (int i = 0, n = 0; i < nkb; ++i) {
        for (int pass = 0; pass < 2; ++pass)  // dO, V_i; then Q, K_i
          for (int c = 0; c < nd; ++c, ++n) {
            if (n >= SA) mbar_wait(&empty_a[s], ph ^ 1);
            uint8_t* slot = ring_a + s * A_BYTES;
            mbar_expect_tx(&full_a[s], OWN + STR);
            tma_load(slot, pass ? &map_q : &map_do, &full_a[s], C * c, q0, bh);
            tma_load(slot + OWN, pass ? &map_k : &map_v, &full_a[s], C * c,
                     i * BK, bh);
            if (++s == SA) s = 0, ph ^= 1;
          }
        const int b = i % SB;  // K_i's columns of this chunk
        if (i >= SB) mbar_wait(&empty_b[b], (i / SB - 1) & 1);
        mbar_expect_tx(&full_b[b], ncols / C * STR);
        for (int j = 0; j < ncols / C; ++j)
          tma_load(ring_b + b * B_BYTES + j * STR, &map_k, &full_b[b],
                   col0 + C * j, i * BK, bh);
      }
    } else if (warp > tf32::WARPS) {  // the converters
      const int ct = threadIdx.x - (tf32::WARPS + 1) * 32;
      int s = 0, ph = 0;
      for (int n = 0; n < nkb * 2 * nd; ++n) {  // dP's V_i to nearest
        mbar_wait(&full_a[s], ph);
        tf32::write_small_parts(ring_a + s * A_BYTES, ct, n % (2 * nd) < nd);
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

  // Each thread's two rows: lse in base 2, and delta = rowsum(dO * O), the
  // four lanes of a row each summing every fourth float4 of both rows,
  // kept in rowstat, beside the registers' dQ. delta is summed in double:
  // where dS = P (dP - delta) is 0 in exact arithmetic (a causal row's
  // first key), dQ then holds dP's rounding alone (score_chunk says how
  // that is kept small). Rows past the end read nothing.
  float2* mystat = reinterpret_cast<float2*>(rowstat) + warp * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    double sum = 0.0;
    float lse2 = 0.f;
    if (w0 + g + 8 * h < sq) {
      const size_t row = (size_t)bh * sq + w0 + g + 8 * h;
      const float4* a = reinterpret_cast<const float4*>(dout + row * d);
      const float4* b = reinterpret_cast<const float4*>(out + row * d);
      for (int j = t; j < d / 4; j += 4) {
        const float4 x = a[j], y = b[j];
        sum += (double)x.x * y.x + (double)x.y * y.y + (double)x.z * y.z +
               (double)x.w * y.w;
      }
      lse2 = lse[row] * LOG2E;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (t == 0) mystat[8 * h] = make_float2(lse2, (float)sum);
    if (chunk == 0 && t == 0 && w0 + g + 8 * h < sq)
      delta[(size_t)bh * sq + w0 + g + 8 * h] = (float)sum;
  }
  __syncwarp();

  float acc[COLS / 2];  // dQ / scale, [16 x COLS] across the warp
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2];  // dP_i, then S_i, P_i and dS_i
  // This thread's dP_i: 8 float4, a consumer thread's stride apart.
  float4* mine = pbuf + threadIdx.x;

  auto release = [&](uint64_t* bar) {  // this warp is done with a slot
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  int s = 0, ph = 0;  // ring A's slot in use and its use's parity
  for (int i = 0; i < nkb; ++i) {
    const int k0 = i * BK;
    // Some key of the tile is unmasked for some row of this warpgroup.
    const bool live = wg_row0 < sq && !(causal && k0 > wg_row0 + 63);
    for (int pass = 0; pass < 2; ++pass) {  // dP_i, then S_i
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      for (int c = 0; c < nd; ++c) {
        mbar_wait(&full_a[s], ph);
        mbar_wait(&ready_a[s], ph);
        if (live && pass == 0)  // dP: split to nearest (see score_chunk)
          tf32::score_chunk<true>(sc, ring_a + s * A_BYTES, warp, g, t);
        else if (live)
          tf32::score_chunk<false>(sc, ring_a + s * A_BYTES, warp, g, t);
        release(&empty_a[s]);
        if (++s == SA) s = 0, ph ^= 1;
      }
      if (pass == 0 && live) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mine[j * tf32::WARPS * 32] =
              make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2],
                          sc[4 * j + 3]);
      }
    }
    if (live) {
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
      const float2 st[2] = {mystat[0], mystat[8]};  // (lse2, delta)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float4 dp = mine[j * tf32::WARPS * 32];
        const float p[4] = {dp.x, dp.y, dp.z, dp.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] =
              fast_exp2(fmaf(sc[4 * j + e], c2, -st[e >> 1].x)) *
              (p[e] - st[e >> 1].y);
      }
    }
    const int b = i % SB;
    mbar_wait(&full_b[b], (i / SB) & 1);
    if (live)
      tf32::col_product<COLS>(acc, sc, ring_b + b * B_BYTES, ncols / C, g, t);
    release(&empty_b[b]);
  }

#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) acc[i] *= scale;
  store_cols<COLS, T>(dq + ((size_t)bh * sq + w0) * d + col0, d, acc,
                      sq - w0, ncols);
}

// dK/dV in float32 (flash_common.cuh, namespace tf32, says why this
// shape), every head dim, d at run time: a block owns 128 keys, two
// consumer warpgroups of 64, and one chunk of COLS of dK's and dV's
// columns. For each tile i of 64 queries, from the diagonal down, each
// warpgroup builds dP^T_i = V dO_i^T over all d from ring A's chunks of V
// and dO_i and parks it in the P buffer, then S^T_i = K Q_i^T from the
// chunks of K and Q_i; forms P^T = 2^(S^T c2 - lse log2 e) in registers,
// masking only a tile that crosses the diagonal or either sequence's end,
// and adds dV += P^T dO_i for its columns; then forms dS^T = P^T (dP^T -
// delta) and adds dK += dS^T Q_i. Ring B holds the tile's columns of Q_i
// and dO_i of the chunk, and its lse and delta, copied by TMA from one-
// dimensional maps of the [bh, seq] vectors. scale is applied to dK once,
// at the end.
template <typename T, int COLS>
__global__ void __launch_bounds__(tf32::THREADS, 1)
bwd_dkv_kernel_tf32(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_lse,
                    const __grid_constant__ CUtensorMap map_delta,
                    T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
                    int d, int causal, float scale) {
  static_assert(std::is_same<T, float>::value, "the float32 body");
  static_assert(COLS <= tf32::DKV_WIDEST, "dK and dV fit in registers");
  using namespace sm90;
  constexpr int BKEY = tf32::ROWS, BQ = tf32::TILE, C = tf32::CHUNK;
  constexpr int SA = tf32::BWD_STAGES, SB = tf32::bwd_b_stages(2 * COLS);
  constexpr uint32_t OWN = BKEY * C * 4;   // a chunk of V or K
  constexpr uint32_t STR = BQ * C * 4;     // one of dO_i or Q_i, or its
                                           // small parts
  constexpr uint32_t A_BYTES = OWN + 2 * STR;
  constexpr uint32_t TB = STR * (COLS / C);  // Q_i's or dO_i's columns
  constexpr uint32_t B_BYTES = 2 * TB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* ring_a = aligned_smem(smem_raw);
  uint8_t* ring_b = ring_a + SA * A_BYTES;
  // Ring B's lse and delta, [SB][2][STAT_LD], from the 16-byte aligned
  // element at or before the tile's first (tf32::STAT says why).
  constexpr int STAT = tf32::STAT, STAT_LD = tf32::STAT_LD;
  float* stats = reinterpret_cast<float*>(ring_b + SB * B_BYTES);
  float4* pbuf = reinterpret_cast<float4*>(stats + SB * 2 * STAT_LD);
  uint64_t* full_a = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(pbuf) + tf32::PBUF_BYTES);
  uint64_t* ready_a = full_a + SA;
  uint64_t* empty_a = ready_a + SA;
  uint64_t* full_b = empty_a + SA;
  uint64_t* empty_b = full_b + SB;

  const int nd = d / C, nc = (d + COLS - 1) / COLS;
  const WideBlock blk = wide_block((sk + BKEY - 1) / BKEY, nc, false);
  const int bh = blk.bh, k0 = blk.row0 * BKEY, chunk = blk.chunk;
  const int col0 = chunk * COLS, ncols = min(COLS, d - col0);
  // Causal: q-tiles that end before this block's first key add nothing.
  const int qb0 = causal ? k0 / BQ : 0;
  const int n_iter = max(0, (sq + BQ - 1) / BQ - qb0);
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
      int s = 0, ph = 0;  // ring A's next slot, and its use's parity
      for (int i = 0, n = 0; i < n_iter; ++i) {
        const int q0 = (qb0 + i) * BQ;
        for (int pass = 0; pass < 2; ++pass)  // V, dO_i; then K, Q_i
          for (int c = 0; c < nd; ++c, ++n) {
            if (n >= SA) mbar_wait(&empty_a[s], ph ^ 1);
            uint8_t* slot = ring_a + s * A_BYTES;
            mbar_expect_tx(&full_a[s], OWN + STR);
            tma_load(slot, pass ? &map_k : &map_v, &full_a[s], C * c, k0, bh);
            tma_load(slot + OWN, pass ? &map_q : &map_do, &full_a[s], C * c,
                     q0, bh);
            if (++s == SA) s = 0, ph ^= 1;
          }
        // Q_i's and dO_i's columns of this chunk, and the tile's lse and
        // delta from the 16-byte aligned element at or before its first
        // (rows past the head's end are masked by the consumers).
        const int b = i % SB;
        if (i >= SB) mbar_wait(&empty_b[b], (i / SB - 1) & 1);
        uint8_t* slot = ring_b + b * B_BYTES;
        mbar_expect_tx(&full_b[b], 2 * (ncols / C) * STR + 2 * STAT * 4);
        for (int j = 0; j < ncols / C; ++j) {
          tma_load(slot + j * STR, &map_q, &full_b[b], col0 + C * j, q0, bh);
          tma_load(slot + TB + j * STR, &map_do, &full_b[b], col0 + C * j,
                   q0, bh);
        }
        const int x0 = (bh * sq + q0) & ~3;
        tma_load_1d(stats + b * 2 * STAT_LD, &map_lse, &full_b[b], x0);
        tma_load_1d(stats + (b * 2 + 1) * STAT_LD, &map_delta, &full_b[b],
                    x0);
      }
    } else if (warp > tf32::WARPS) {  // the converters
      const int ct = threadIdx.x - (tf32::WARPS + 1) * 32;
      int s = 0, ph = 0;
      for (int n = 0; n < n_iter * 2 * nd; ++n) {
        mbar_wait(&full_a[s], ph);
        tf32::write_small_parts(ring_a + s * A_BYTES, ct, false);
        __syncwarp();
        if (lane == 0) mbar_arrive(&ready_a[s]);
        if (++s == SA) s = 0, ph ^= 1;
      }
    }
    return;
  }

  // Consumer warp `warp` owns keys w0 .. w0 + 15, its warpgroup keys
  // wg_key0 .. wg_key0 + 63.
  reg_alloc<tf32::CONSUMER_REGS>();
  const int g = lane >> 2, t = lane & 3;
  const int w0 = k0 + warp * 16, wg_key0 = k0 + (warp / 4) * 64;
  const float c2 = scale * LOG2E;

  float dk_acc[COLS / 2], dv_acc[COLS / 2];  // [16 x COLS] across the warp
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float sc[BQ / 2];  // dP^T_i, then S^T_i, P^T_i and dS^T_i
  float4* mine = pbuf + threadIdx.x;  // this thread's dP^T_i

  auto release = [&](uint64_t* bar) {  // this warp is done with a slot
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  int s = 0, ph = 0;  // ring A's slot in use and its use's parity
  for (int i = 0; i < n_iter; ++i) {
    const int q0 = (qb0 + i) * BQ;
    // Some query of the tile is unmasked for some key of this warpgroup.
    const bool live = wg_key0 < sk && !(causal && q0 + BQ - 1 < wg_key0);
    for (int pass = 0; pass < 2; ++pass) {  // dP^T_i, then S^T_i
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) sc[j] = 0.f;
      for (int c = 0; c < nd; ++c) {
        mbar_wait(&full_a[s], ph);
        mbar_wait(&ready_a[s], ph);
        if (live)
          tf32::score_chunk<false>(sc, ring_a + s * A_BYTES, warp, g, t);
        release(&empty_a[s]);
        if (++s == SA) s = 0, ph ^= 1;
      }
      if (pass == 0 && live) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
          mine[j * tf32::WARPS * 32] =
              make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2],
                          sc[4 * j + 3]);
      }
    }
    const int b = i % SB;
    mbar_wait(&full_b[b], (i / SB) & 1);
    if (live) {
      const uint8_t* slot = ring_b + b * B_BYTES;
      const float* lse = stats + b * 2 * STAT_LD + ((bh * sq + q0) & 3);
      const float* dlt = lse + STAT_LD;
      if (q0 + BQ > sq || w0 + 16 > sk || (causal && q0 < w0 + 15)) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q0 + 8 * j + 2 * t + (e & 1);
            const int key = w0 + g + 8 * (e >> 1);
            if (!(q < sq && key < sk && (!causal || key <= q)))
              sc[4 * j + e] = NEG_INF;
          }
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = fast_exp2(fmaf(
              sc[4 * j + e], c2, -lse[8 * j + 2 * t + (e & 1)] * LOG2E));
      tf32::col_product<COLS>(dv_acc, sc, slot + TB, ncols / C, g, t);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float4 dp = mine[j * tf32::WARPS * 32];
        const float p[4] = {dp.x, dp.y, dp.z, dp.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] *= p[e] - dlt[8 * j + 2 * t + (e & 1)];
      }
      tf32::col_product<COLS>(dk_acc, sc, slot, ncols / C, g, t);
    }
    release(&empty_b[b]);
  }

#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) dk_acc[i] *= scale;
  const size_t at = ((size_t)bh * sk + w0) * d + col0;
  store_cols<COLS, T>(dk + at, d, dk_acc, sk - w0, ncols);
  store_cols<COLS, T>(dv + at, d, dv_acc, sk - w0, ncols);
}

// The float32 pair's launchers: maps of 32-column boxes (the owned rows'
// of 128, the streamed rows' of 64), the grid one block per (row block,
// chunk of COLS of the gradients' columns), COLS from tf32::cols at the
// grid's row blocks (dK/dV's at most DKV_WIDEST). Their shared memory at a
// grid that fills the card (flash_bwd_smem reports it).
static int tf32_dq_smem(int d) {
  return tf32::bwd_smem(tf32::cols(d, tf32::FILL, tf32::DQ_WIDEST), false);
}
static int tf32_dkv_smem(int d) {
  return tf32::bwd_smem(2 * tf32::cols(d, tf32::FILL, tf32::DKV_WIDEST),
                        true);
}

// Calls go(std::integral_constant<int, COLS>()) for the widths compiled
// (tf32::DQ_WIDEST and DKV_WIDEST are 128).
template <typename Go>
static int with_cols(int cols, Go go) {
  switch (cols) {
    case 32: return go(std::integral_constant<int, 32>());
    case 64: return go(std::integral_constant<int, 64>());
    case 128: return go(std::integral_constant<int, 128>());
  }
  return FLASH_ERR_UNSUPPORTED;
}

static int bwd_dq_tf32(const void* q, const void* k, const void* v,
                       const void* dout, const void* out, const void* lse,
                       void* delta, void* dq, int bh, int sq, int sk, int d,
                       int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int err = sm90::make_map_cols<float>(&mq, q, bh, sq, d, tf32::ROWS,
                                       tf32::CHUNK);
  if (!err)
    err = sm90::make_map_cols<float>(&mk, k, bh, sk, d, tf32::TILE,
                                     tf32::CHUNK);
  if (!err)
    err = sm90::make_map_cols<float>(&mv, v, bh, sk, d, tf32::TILE,
                                     tf32::CHUNK);
  if (!err)
    err = sm90::make_map_cols<float>(&mdo, dout, bh, sq, d, tf32::ROWS,
                                     tf32::CHUNK);
  if (err) return err;
  const long blocks = (long)bh * ((sq + tf32::ROWS - 1) / tf32::ROWS);
  return with_cols(tf32::cols(d, blocks, tf32::DQ_WIDEST), [&](auto width) {
    constexpr int COLS = decltype(width)::value;
    return launch(bwd_dq_kernel_tf32<float, COLS>,
                  dim3(blocks * ((d + COLS - 1) / COLS)), tf32::THREADS,
                  (size_t)tf32::bwd_smem(COLS, false), stream, mq, mk, mv, mdo,
                  static_cast<const float*>(dout),
                  static_cast<const float*>(out),
                  static_cast<const float*>(lse), static_cast<float*>(delta),
                  static_cast<float*>(dq), sq, sk, d, causal, scale);
  });
}

static int bwd_dkv_tf32(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int bh, int sq, int sk, int d,
                        int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo, mlse, mdelta;
  int err = sm90::make_map_cols<float>(&mq, q, bh, sq, d, tf32::TILE,
                                       tf32::CHUNK);
  if (!err)
    err = sm90::make_map_cols<float>(&mk, k, bh, sk, d, tf32::ROWS,
                                     tf32::CHUNK);
  if (!err)
    err = sm90::make_map_cols<float>(&mv, v, bh, sk, d, tf32::ROWS,
                                     tf32::CHUNK);
  if (!err)
    err = sm90::make_map_cols<float>(&mdo, dout, bh, sq, d, tf32::TILE,
                                     tf32::CHUNK);
  if (!err) err = sm90::make_map_1d(&mlse, lse, (long)bh * sq, tf32::STAT);
  if (!err)
    err = sm90::make_map_1d(&mdelta, delta, (long)bh * sq, tf32::STAT);
  if (err) return err;
  const long blocks = (long)bh * ((sk + tf32::ROWS - 1) / tf32::ROWS);
  return with_cols(
      tf32::cols(d, blocks, tf32::DKV_WIDEST), [&](auto width) {
        constexpr int COLS = decltype(width)::value;
        return launch(bwd_dkv_kernel_tf32<float, COLS>,
                      dim3(blocks * ((d + COLS - 1) / COLS)), tf32::THREADS,
                      (size_t)tf32::bwd_smem(2 * COLS, true), stream, mq, mk,
                      mv, mdo, mlse, mdelta, static_cast<float*>(dk),
                      static_cast<float*>(dv), sq, sk, d, causal, scale);
      });
}

// Shared memory of each body (ray_tpu_torch/ops/attention.py's
// kernel_smem_bytes mirrors these).
template <typename T, int D>
static size_t dq_smem() {
  if constexpr (hopper_body<T, D>()) {
    using Tl = sm90::DqTiles<D>;  // Q, dO and, up to D 128, O resident
    return (D <= 128 ? 3 : 2) * sm90::tile_bytes<Tl::ROWS, D>() +
           Tl::STAGES * 2 * sm90::tile_bytes<Tl::TILE, D>() +
           (1 + 2 * Tl::STAGES) * sizeof(uint64_t) + sm90::SMEM_ALIGN;
  } else {
    return tf32_dq_smem(D);
  }
}

template <typename T, int D>
static size_t dkv_smem() {
  if constexpr (hopper_body<T, D>()) {
    using Tl = sm90::DkvTiles<D>;  // above D 128, two float32 P^T buffers
    return 2 * sm90::tile_bytes<Tl::ROWS, D>() +
           Tl::STAGES * (2 * sm90::tile_bytes<Tl::TILE, D>() +
                         2 * Tl::TILE * sizeof(float)) +
           (D <= 128 ? 0 : 2 * Tl::ROWS * Tl::TILE * sizeof(float)) +
           (1 + 2 * Tl::STAGES + (D <= 128 ? 0 : 4)) * sizeof(uint64_t) +
           sm90::SMEM_ALIGN;
  } else {
    return tf32_dkv_smem(D);
  }
}

template <typename T, int D>
static int bwd_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* out, const void* lse,
                  void* delta, void* dq, int bh, int sq, int sk, int causal,
                  float scale, cudaStream_t stream) {
  if constexpr (hopper_body<T, D>()) {
    using Tl = sm90::DqTiles<D>;
    CUtensorMap mq, mk, mv, mdo, mo = {};  // O's map: up to D 128
    int err = sm90::make_map<T, D>(&mq, q, bh, sq, Tl::ROWS);
    if (!err) err = sm90::make_map<T, D>(&mk, k, bh, sk, Tl::TILE);
    if (!err) err = sm90::make_map<T, D>(&mv, v, bh, sk, Tl::TILE);
    if (!err) err = sm90::make_map<T, D>(&mdo, dout, bh, sq, Tl::ROWS);
    if (!err && D <= 128)
      err = sm90::make_map<T, D>(&mo, out, bh, sq, Tl::ROWS);
    if (err) return err;
    const dim3 grid(bh * ((sq + Tl::ROWS - 1) / Tl::ROWS));
    return launch(bwd_dq_kernel_sm90<T, D>, grid, sm90::THREADS,
                  dq_smem<T, D>(), stream, mq, mk, mv, mdo, mo,
                  static_cast<const T*>(out), static_cast<const float*>(lse),
                  static_cast<float*>(delta), static_cast<T*>(dq), sq, sk,
                  causal, scale);
  } else {
    return bwd_dq_tf32(q, k, v, dout, out, lse, delta, dq, bh, sq, sk, D,
                       causal, scale, stream);
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
    const float* lse_f = static_cast<const float*>(lse);
    const float* delta_f = static_cast<const float*>(delta);
    if constexpr (D <= 128)
      return launch(bwd_dkv_kernel_sm90<T, D>, grid, sm90::THREADS,
                    dkv_smem<T, D>(), stream, mq, mk, mv, mdo, lse_f,
                    delta_f, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
                    causal, scale);
    else
      return launch(bwd_dkv_kernel_sm90_split<T, D>, grid, sm90::THREADS,
                    dkv_smem<T, D>(), stream, mq, mk, mv, mdo, lse_f,
                    delta_f, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
                    causal, scale);
  } else {
    return bwd_dkv_tf32(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, D,
                        causal, scale, stream);
  }
}

// Shared memory of the 16-bit bodies above d 256: ring A's slots, ring
// B's, (dK/dV) the P^T buffer and the slots' lse and delta, a full and an
// empty mbarrier a slot (and the buffer's pair), and the swizzle's
// alignment.
template <int COLS>
static size_t dq_smem_sm90_wide() {
  using Tl = sm90::WideDqTiles;
  return Tl::STAGES * 2 * (sm90::tile_bytes<Tl::ROWS, 64>() +
                           sm90::tile_bytes<Tl::TILE, 64>()) +
         Tl::B_STAGES * sm90::tile_bytes<Tl::TILE, COLS>() +
         2 * (Tl::STAGES + Tl::B_STAGES) * sizeof(uint64_t) + sm90::SMEM_ALIGN;
}
template <int COLS>
static size_t dkv_smem_sm90_wide() {
  using Tl = sm90::WideDkvTiles;
  return Tl::STAGES * 2 * (sm90::tile_bytes<Tl::ROWS, 64>() +
                           sm90::tile_bytes<Tl::TILE, 64>()) +
         Tl::B_STAGES * (2 * sm90::tile_bytes<Tl::TILE, COLS>() +
                         2 * Tl::TILE * sizeof(float)) +
         Tl::ROWS * Tl::TILE * sizeof(float) +
         (2 * (Tl::STAGES + Tl::B_STAGES) + 2) * sizeof(uint64_t) +
         sm90::SMEM_ALIGN;
}

template <typename T, int COLS>
static int bwd_dq_sm90_wide(const void* q, const void* k, const void* v,
                            const void* dout, const void* out,
                            const void* lse, void* delta, void* dq, int bh,
                            int sq, int sk, int d, int causal, float scale,
                            cudaStream_t stream) {
  using Tl = sm90::WideDqTiles;
  CUtensorMap mq, mk, mv, mdo;
  int err = sm90::make_map_cols<T>(&mq, q, bh, sq, d, Tl::ROWS, 64);
  if (!err) err = sm90::make_map_cols<T>(&mk, k, bh, sk, d, Tl::TILE, 64);
  if (!err) err = sm90::make_map_cols<T>(&mv, v, bh, sk, d, Tl::TILE, 64);
  if (!err) err = sm90::make_map_cols<T>(&mdo, dout, bh, sq, d, Tl::ROWS, 64);
  if (err) return err;
  const dim3 grid(bh * ((sq + Tl::ROWS - 1) / Tl::ROWS) *
                  sm90::wide_chunks(d));
  return launch(bwd_dq_kernel_sm90_wide<T, COLS>, grid, sm90::THREADS,
                dq_smem_sm90_wide<COLS>(), stream, mq, mk, mv, mdo,
                static_cast<const T*>(dout), static_cast<const T*>(out),
                static_cast<const float*>(lse), static_cast<float*>(delta),
                static_cast<T*>(dq), sq, sk, d, causal, scale);
}

template <typename T, int COLS>
static int bwd_dkv_sm90_wide(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int sq, int sk, int d, int causal, float scale,
                             cudaStream_t stream) {
  using Tl = sm90::WideDkvTiles;
  CUtensorMap mq, mk, mv, mdo;
  int err = sm90::make_map_cols<T>(&mq, q, bh, sq, d, Tl::TILE, 64);
  if (!err) err = sm90::make_map_cols<T>(&mk, k, bh, sk, d, Tl::ROWS, 64);
  if (!err) err = sm90::make_map_cols<T>(&mv, v, bh, sk, d, Tl::ROWS, 64);
  if (!err) err = sm90::make_map_cols<T>(&mdo, dout, bh, sq, d, Tl::TILE, 64);
  if (err) return err;
  const dim3 grid(bh * ((sk + Tl::ROWS - 1) / Tl::ROWS) *
                  sm90::wide_chunks(d));
  return launch(bwd_dkv_kernel_sm90_wide<T, COLS>, grid, sm90::THREADS,
                dkv_smem_sm90_wide<COLS>(), stream, mq, mk, mv, mdo,
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk),
                static_cast<T*>(dv), sq, sk, d, causal, scale);
}

// Above d 256: the Hopper bodies in 16 bits (the gradients' column chunks
// 192 or 256 wide), the 3xTF32 ones in float32.
template <typename T>
static int bwd_dq_wide(const void* q, const void* k, const void* v,
                       const void* dout, const void* out, const void* lse,
                       void* delta, void* dq, int bh, int sq, int sk, int d,
                       int causal, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (sm90::wide_cols(d) == 192)
      return bwd_dq_sm90_wide<T, 192>(q, k, v, dout, out, lse, delta, dq, bh,
                                      sq, sk, d, causal, scale, stream);
    return bwd_dq_sm90_wide<T, 256>(q, k, v, dout, out, lse, delta, dq, bh,
                                    sq, sk, d, causal, scale, stream);
  } else {
    return bwd_dq_tf32(q, k, v, dout, out, lse, delta, dq, bh, sq, sk, d,
                       causal, scale, stream);
  }
}

template <typename T>
static int bwd_dkv_wide(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int bh, int sq, int sk, int d,
                        int causal, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (sm90::wide_cols(d) == 192)
      return bwd_dkv_sm90_wide<T, 192>(q, k, v, dout, lse, delta, dk, dv, bh,
                                       sq, sk, d, causal, scale, stream);
    return bwd_dkv_sm90_wide<T, 256>(q, k, v, dout, lse, delta, dk, dv, bh,
                                     sq, sk, d, causal, scale, stream);
  } else {
    return bwd_dkv_tf32(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                        causal, scale, stream);
  }
}

template <typename T>
static int dq_wide_smem(int d) {
  if constexpr (sizeof(T) == 2)
    return (int)(sm90::wide_cols(d) == 192 ? dq_smem_sm90_wide<192>()
                                           : dq_smem_sm90_wide<256>());
  else
    return tf32_dq_smem(d);
}

template <typename T>
static int dkv_wide_smem(int d) {
  if constexpr (sizeof(T) == 2)
    return (int)(sm90::wide_cols(d) == 192 ? dkv_smem_sm90_wide<192>()
                                           : dkv_smem_sm90_wide<256>());
  else
    return tf32_dkv_smem(d);
}

// q, dout, out [bh, sq, d]; k, v [bh, sk, d]; lse [bh, sq] float32
// -> delta [bh, sq] float32, dq [bh, sq, d].
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* out,
                            const void* lse, void* delta, void* dq, int bh,
                            int sq, int sk, int d, int causal, float scale,
                            int dtype, void* stream) {
  if (int err = bind_device()) return err;
  if (wide_head_dim(d))
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
  if (int err = bind_device()) return err;
  if (wide_head_dim(d))
    FLASH_DISPATCH_WIDE(bwd_dkv_wide, dtype, q, k, v, dout, lse, delta, dk,
                        dv, bh, sq, sk, d, causal, scale,
                        static_cast<cudaStream_t>(stream));
  FLASH_DISPATCH(bwd_dkv, dtype, d, q, k, v, dout, lse, delta, dk, dv, bh, sq,
                 sk, causal, scale, static_cast<cudaStream_t>(stream));
}

// Shared memory one block of flash_bwd_dq (kernel 0) or flash_bwd_dkv
// (kernel 1) takes at this head dim and dtype.
extern "C" int flash_bwd_smem(int kernel, int d, int dtype) {
  if (wide_head_dim(d)) {
    if (kernel == 0) FLASH_DISPATCH_WIDE(dq_wide_smem, dtype, d);
    FLASH_DISPATCH_WIDE(dkv_wide_smem, dtype, d);
  }
  if (kernel == 0) FLASH_DISPATCH(dq_smem, dtype, d, );
  FLASH_DISPATCH(dkv_smem, dtype, d, );
}
