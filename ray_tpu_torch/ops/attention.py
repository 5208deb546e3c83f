"""Flash attention, forward and backward, on hand-written CUDA kernels.

Counterpart of `ray_tpu/ops/attention.py`, whose three Pallas TPU kernels
become the CUDA C++ kernels in `ray_tpu_torch/csrc/` (flash_fwd.cu,
flash_bwd.cu): blocked online softmax that never writes the seq x seq score
matrix to device memory and saves the row logsumexp, and two backward
kernels (dQ streaming K/V; dK/dV streaming Q/dO) that recompute the
probabilities from it.

Public layout as in the JAX package: q, k, v are [batch, heads, seq,
head_dim]. The kernels and their plain PyTorch versions work on
[batch * heads, seq, head_dim]. Each wrapper launches its kernel for a
CUDA tensor and runs the plain version for a CPU tensor; it never swaps one
for the other. On the card every body runs on the tensor cores, fed by a
TMA ring, chosen by type and head dim: bf16 and float16 run the Hopper
bodies (wgmma) of all three kernels at every head dim, one instance per d
up to 256 and, above, d at run time with the output's columns split over
the grid. float32 runs the 3xTF32 bodies of all three kernels (each
float32 operand split into two TF32 parts; wgmma and mma.sync) at every
head dim, d at run time, the output's columns split over the grid
(`TILES` lists each one's tiles).
The dQ kernel runs first in the backward and also writes delta =
rowsum(dO * O), which the dK/dV kernel reads.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

_NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 192, 256)  # head dims with an instance of their own
SMEM_LIMIT = 232448        # shared memory one block may use on Hopper
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HALF = (torch.bfloat16, torch.float16)  # the types wgmma takes
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


class Tile(NamedTuple):
    """Tiles of one kernel body, as its source fixes them."""
    rows: int     # rows one block owns (queries; keys for dK/dV)
    stream: int   # rows of each tile the block streams past them
    stages: int   # slots of the TMA ring the streamed tiles pass through
    # Consumer warpgroups per 64 owned rows; at 2 (16-bit dK/dV above d
    # 128) one accumulates dV and the other dK, and the first hands P^T to
    # the second through shared memory.
    split: int = 1
    wide: bool = False  # d at run time
    # The bodies with d at run time (16 bits above d 256, float32 at every
    # d): the columns of the output (O; dQ; dK and dV) one block owns, 192
    # or 256 (float32: a power of two from 32 up to 256, 128 in the
    # backward pair, at a grid that fills the card); the grid holds one
    # block per chunk of that many.
    cols: int = 0


# The Hopper bodies' tiles (flash_common.cuh FwdTiles, DqTiles, DkvTiles):
# dQ and dK/dV stream a smaller tile at d = 128, where their accumulators
# take the most registers, and dQ has 4 slots. At d 192 and 256 the forward
# streams 64 keys through as many slots as fit beside Q (3 and 2), dQ 32
# keys through as many as fit beside Q and dO, and dK/dV's two warpgroups
# share 64 keys (split 2) and stream 64 queries.
_RING = {
    "flash_fwd": {**dict.fromkeys((32, 64, 128), Tile(128, 128, 3)),
                  192: Tile(128, 64, 3), 256: Tile(128, 64, 2)},
    "flash_bwd_dkv": {32: Tile(128, 64, 3), 64: Tile(128, 64, 3),
                      128: Tile(128, 32, 3),
                      192: Tile(64, 64, 3, 2),
                      256: Tile(64, 64, 2, 2)},
    "flash_bwd_dq": {32: Tile(128, 128, 4),
                     64: Tile(128, 128, 4),
                     128: Tile(128, 64, 4),
                     192: Tile(128, 32, 5),
                     256: Tile(128, 32, 3)},
}
_V_STAGES = 2  # the 16-bit forward above d 256 and the float32 forward:
# slots of V's tiles
# The 16-bit dQ and dK/dV above d 256: slots of ring B, which holds the
# operand of the block's chunk product (K's columns; Q's and dO's).
_B_STAGES = 1


def wide_chunks(d: int) -> Tuple[int, int]:
    """(chunks, columns a chunk) of the output (O; dQ; dK and dV) at head
    dim d > 256 in the 16-bit kernels (flash_common.cuh wide_chunks,
    wide_cols): as few chunks as 256 columns each allow, of one width, a
    multiple of 64; the last may run past d."""
    m = d // 64
    n = -(-m // 4)
    return n, -(-m // n) * 64


def _ring_wide(name: str, d: int) -> Tile:
    """The 16-bit tiles above d 256 (flash_common.cuh WideFwdTiles,
    WideDqTiles, WideDkvTiles), each block owning one chunk of `cols` of
    the output's columns. Forward: 128 query rows, 64-key tiles, a ring of
    6 slots each holding a 64-column chunk of Q and one of K, and 2 slots
    of V's [64 x cols] tiles. dQ: 128 query rows, 64-key tiles, 4 slots
    each holding a 64-column chunk of Q, dO, K and V. dK/dV: 64 keys that
    both warpgroups share (split 2), 64-query tiles, 4 slots each holding a
    chunk of K, V, Q and dO. Both backward kernels read their chunk
    product's operand through `_B_STAGES` more slots."""
    cols = wide_chunks(d)[1]
    if name == "flash_fwd":
        return Tile(128, 64, 6, wide=True, cols=cols)
    if name == "flash_bwd_dq":
        return Tile(128, 64, 4, wide=True, cols=cols)
    return Tile(64, 64, 4, 2, wide=True, cols=cols)


# The float32 bodies (flash_common.cuh, namespace tf32): a block owns 128
# rows (queries; keys for dK/dV) and streams 64-row tiles (keys; queries),
# d at run time at every head dim, the output's columns split over the
# grid (`f32_cols`). The forward: each of ring A's slots holds a 32-column
# chunk of Q's rows, of the tile's keys and of their small TF32 parts, 4
# slots, 3 where a block owns 256 of O's columns; ring B's 2 slots V's
# [64 x cols] tiles. The backward pair: ring A's 4 slots the same, a
# chunk of the owned rows (dO, then Q; V, then K) and of the tile's rows
# with their small parts; ring B's slots the tile's columns of the block's
# chunk (K's; Q's and dO's with the tile's lse and delta), one slot where
# that is more than 128 columns, else 2; a float32 buffer of the block's
# [128 x 64] dP (dP^T); dQ's rows' lse and delta.
_F32_CHUNK = 32   # columns of its TMA boxes: 128 bytes, the 128B swizzle
_FILL = 132       # blocks an H100 runs at once (tf32::FILL)
_F32_BWD_STAGES = 4  # tf32::BWD_STAGES
_F32_STAT_LD = 96    # tf32::STAT_LD: floats of dK/dV's lse (delta) a slot
# The widest chunk of the output's columns a float32 block owns: 128 in the
# backward pair (tf32::DQ_WIDEST, DKV_WIDEST).
_F32_WIDEST = {"flash_fwd": 256, "flash_bwd_dq": 128, "flash_bwd_dkv": 128}


def _f32(name: str, d: int) -> Tile:
    """The float32 tiles of kernel `name` at head dim d, on a grid that
    fills the card (tf32::stages: the forward's ring A gives up a slot to
    V's wider tiles)."""
    cols = f32_cols(name, d)
    if name == "flash_fwd":
        stages = 3 if cols > 128 else 4
    else:
        stages = _F32_BWD_STAGES
    return Tile(128, 64, stages, wide=True, cols=cols)


def f32_cols(name: str, d: int, blocks: int = _FILL) -> int:
    """The columns of the output one float32 block of kernel `name` owns
    at head dim d, where the grid has `blocks` row blocks (bh x blocks of
    128 rows; by default enough to fill the card): the power of two from
    32 to `_F32_WIDEST[name]` that covers d; while the grid then holds
    fewer than 132 blocks, half as many, down to 64 (flash_common.cuh
    tf32::cols, which the launchers run)."""
    w = _F32_CHUNK
    while w < d and w < _F32_WIDEST[name]:
        w *= 2
    while w > 64 and blocks * -(-d // w) < _FILL:
        w //= 2
    return w


def _f32_b_stages(name: str, cols: int) -> int:
    """Ring B's slots of a float32 backward block owning `cols` columns
    (tf32::bwd_b_stages)."""
    b_cols = cols * (2 if name == "flash_bwd_dkv" else 1)
    return 1 if b_cols > 128 else 2


def _tile(name: str, dtype: torch.dtype, d: int) -> Tile:
    """The tiles of kernel `name`'s body in this dtype at head dim d."""
    if dtype == torch.float32:
        return _f32(name, d)
    if d > 256:
        return _ring_wide(name, d)
    return _RING[name][d]


def _smem(name: str, t: Tile, d: int, size: int) -> int:
    """Shared memory of one block of kernel `name` with tiles `t` at head
    dim d for elements of `size` bytes (the formulas of csrc/)."""
    if size == 4 and name != "flash_fwd":
        # The float32 backward pair (tf32::bwd_smem): ring A's slots, a
        # 32-column (128-byte) chunk of the owned rows, of the streamed
        # rows and of their small parts each; ring B's, the streamed rows x
        # cols (K's; Q's and dO's); the float32 dP buffer of rows x stream;
        # lse and delta of the owned rows (dQ) or of each slot's streamed
        # rows (dK/dV); a full, a ready and an empty mbarrier a slot of A,
        # a full and an empty one a slot of B; 1024 bytes to align the
        # swizzle pattern. d sets only cols.
        dkv = name == "flash_bwd_dkv"
        sb = _f32_b_stages(name, t.cols)
        ring_b = sb * t.stream * t.cols * (2 if dkv else 1) * 4
        # dK/dV's lse and delta: _F32_STAT_LD floats each a slot, for the
        # tile's rows from the 16-byte boundary at or before its first.
        stats = (sb * _F32_STAT_LD if dkv else t.rows) * 2 * 4
        return (t.stages * (t.rows + 2 * t.stream) * 128 + ring_b
                + t.rows * t.stream * 4 + stats
                + 8 * (3 * t.stages + 2 * sb) + 1024)
    if size == 4:
        # The float32 forward (tf32::smem): ring A's slots, a 32-column
        # (128-byte) chunk of Q's rows, of K's streamed rows and of their
        # small parts each; V's [stream x cols] slots; a full, a ready and
        # an empty mbarrier a slot of A, a full and an empty one a slot of
        # B; 1024 bytes to align the swizzle pattern. d sets only cols.
        return (t.stages * (t.rows + 2 * t.stream) * 128
                + _V_STAGES * t.stream * t.cols * 4
                + 8 * (3 * t.stages + 2 * _V_STAGES) + 1024)
    if t.wide and name == "flash_fwd":
        # The 16-bit forward above d 256 (fwd_smem_sm90_wide): ring A's
        # slots, a 64-column chunk of Q's rows and of K's streamed rows
        # each; V's [stream x cols] slots; a full and an empty mbarrier a
        # slot; 1024 bytes to align the swizzle pattern. d sets only cols.
        ring_a = t.stages * (t.rows + t.stream) * 64 * size
        ring_b = _V_STAGES * t.stream * t.cols * size
        return ring_a + ring_b + 8 * 2 * (t.stages + _V_STAGES) + 1024
    if t.wide:
        # The 16-bit dQ and dK/dV above d 256 (dq_smem_sm90_wide,
        # dkv_smem_sm90_wide): ring A's slots, a 64-column chunk of two
        # owned and two streamed row blocks each (Q, dO, K, V; K, V, Q,
        # dO); ring B's, the streamed rows x cols of K (dQ) or of Q and dO
        # with the tile's lse and delta (dK/dV); dK/dV's float32 P^T buffer
        # of rows x stream with a full and an empty mbarrier; a full and an
        # empty mbarrier a slot; 1024 bytes to align the swizzle pattern. d
        # sets only cols.
        ring_a = t.stages * 2 * (t.rows + t.stream) * 64 * size
        if name == "flash_bwd_dq":
            ring_b, handoff = _B_STAGES * t.stream * t.cols * size, 0
        else:
            ring_b = _B_STAGES * (2 * t.stream * t.cols * size
                                  + 2 * t.stream * 4)
            handoff = t.rows * t.stream * 4 + 8 * 2
        return (ring_a + ring_b + handoff + 8 * 2 * (t.stages + _B_STAGES)
                + 1024)
    # Tiles are unpadded (TMA swizzles them); one 8-byte mbarrier per
    # resident load and two per slot (four in the forward above d 128,
    # where K and V are released apart); 1024 bytes to align the swizzle
    # pattern. Resident: Q (forward); Q, dO and, up to d 128, O (dQ); K
    # and V (dK/dV). At split 2, two float32 buffers of P^T with a full
    # and an empty mbarrier each.
    owned = {"flash_fwd": 1, "flash_bwd_dq": 3 if d <= 128 else 2,
             "flash_bwd_dkv": 2}[name] * t.rows * d * size
    slot = 2 * t.stream * d * size
    if name == "flash_bwd_dkv":
        slot += 2 * t.stream * 4       # lse and delta
    handoff = (2 * t.rows * t.stream * 4 + 8 * 4) if t.split == 2 else 0
    bars = (4 if name == "flash_fwd" and d > 128 else 2) * t.stages
    return owned + t.stages * slot + handoff + 8 * (1 + bars) + 1024


# The largest head dim the kernels take. None of their blocks grows with d
# above 256 (each owns a chunk of the output's columns), so shared memory
# sets no limit there, and a search for the largest d that fits would not
# end; the cost of recomputing S (and dP) once per chunk does grow, to 3x
# the minimum FLOPs of the 16-bit dQ at d 1024 and 3.5x of the float32
# dK/dV at d 704. Each cap keeps the set of head dims its types have always
# taken, the widest of which the card tests check (tests/test_torch_cuda.py):
# 1024 in bf16 and float16; 704 in float32, where it was the largest d
# whose blocks fit a block's shared memory while the float32 backward pair
# kept its accumulators there.
HALF_WIDE_MAX_D = 1024
F32_WIDE_MAX_D = 704

# dtype -> the largest head dim the kernels take.
WIDE_MAX_D: Dict[torch.dtype, int] = {torch.float32: F32_WIDE_MAX_D,
                                      torch.bfloat16: HALF_WIDE_MAX_D,
                                      torch.float16: HALF_WIDE_MAX_D}


def head_dims(dtype: torch.dtype) -> Tuple[int, ...]:
    """Every head dim the kernels take in this dtype: `HEAD_DIMS`, then
    the multiples of 64 above 256 up to `WIDE_MAX_D`."""
    return HEAD_DIMS + tuple(range(320, WIDE_MAX_D[dtype] + 1, 64))


# (kernel, dtype) -> {head dim: Tile}, mirroring csrc/: bf16 and float16 run
# the Hopper bodies at every head dim; float32 the 3xTF32 bodies at every
# head dim (`cols` at a grid that fills the card).
TILES: Dict[Tuple[str, torch.dtype], Dict[int, Tile]] = {
    (name, dtype): {d: _tile(name, dtype, d) for d in head_dims(dtype)}
    for name in KERNELS for dtype in _DTYPE_CODES
}


def _refuse_head_dim(d: int, dtype: torch.dtype) -> None:
    """Raise unless the kernels take head dim d in this dtype."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"flash attention takes float32, bfloat16 or "
                         f"float16, not {dtype}")
    if d in TILES[KERNELS[0], dtype]:
        return
    if d > 256 and d % 64 == 0:
        raise ValueError(
            f"head dim {d}: the kernels in {dtype} take the multiples of 64 "
            f"up to {WIDE_MAX_D[dtype]}")
    raise ValueError(f"head dim {d}: the kernels take {HEAD_DIMS} and the "
                     f"multiples of 64 up to {WIDE_MAX_D[dtype]}")


_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def kernel_launches() -> Dict[str, int]:
    """How many times each kernel was launched on the card so far."""
    return dict(_launches)


def reset_kernel_launches() -> None:
    for name in _launches:
        _launches[name] = 0


def mha_reference(q, k, v, causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention. q,k,v: [batch, heads, seq, head_dim].

    The causal mask aligns sequence ends (tril(k=ks-qs)); probabilities are
    cast to v's dtype before the PV product."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        qs, ks = q.shape[2], k.shape[2]
        mask = torch.ones(qs, ks, dtype=torch.bool,
                          device=q.device).tril(ks - qs)
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


# --------------------------------------------------------------------------- #
# Plain versions of the kernels: [bh, seq, d], float32 arithmetic (float64
# for float64 inputs, which only checks pass them)
# --------------------------------------------------------------------------- #


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or in float64 where it is float64."""
    return x if x.dtype == torch.float64 else x.float()


def _scores(q, k, causal: bool, scale: float,
            matmul=torch.matmul) -> torch.Tensor:
    """Scaled, masked float32 scores [bh, sq, sk]; the causal mask starts
    both positions at 0, as the kernels' does."""
    s = matmul(_wide(q), _wide(k).transpose(1, 2)) * scale
    if causal:
        mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    return s


def _softmax_pv(s, v, matmul=torch.matmul
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(softmax(s) V, lse) in float32 from the scores s."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return matmul(p, _wide(v)) / denom, (m + torch.log(denom)).squeeze(-1)


def flash_forward_reference(q, k, v, causal: bool, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [bh, sq, d] in q's dtype, lse [bh, sq] float32)."""
    out, lse = _softmax_pv(_scores(q, k, causal, scale), v)
    return out.to(q.dtype), lse


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (8 exponent and 10 mantissa bits), to
    nearest with ties away from zero, as cvt.rna.tf32.f32 rounds: the best
    one TF32 pass can take of x."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x as mma.sync reads a TF32 operand: its 13 low bits
    dropped (rounded toward zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = big + small as the float32 kernels' products read them
    (`tf32::split`): big is x truncated, small what is left, truncated;
    x - (big + small) is at most 2^-20 of x."""
    big = truncate_tf32(x)
    return big, truncate_tf32(x.float() - big)


def _matmul_tf32(a, b, passes: int) -> torch.Tensor:
    """a @ b in float32 from TF32 operands: one pass on the rounded
    operands, or the three products of the split ones, the corrections
    first."""
    if passes == 1:
        return torch.matmul(round_tf32(a), round_tf32(b))
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    return (torch.matmul(as_, bb) + torch.matmul(ab, bs)) + torch.matmul(ab, bb)


def flash_forward_tf32_reference(q, k, v, causal: bool, scale: float,
                                 passes: int = 3
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward (float32 inputs) with its two products, Q K^T and
    P V, on TF32 operands as the tensor cores take them: passes=3 splits
    them as the float32 kernel does (3xTF32), passes=1 is a single TF32
    pass, Q, K, V and P rounded once, which the float32 kernel is not: its
    1e-4 limit must reject that."""
    matmul = functools.partial(_matmul_tf32, passes=passes)
    return _softmax_pv(_scores(q, k, causal, scale, matmul), v, matmul)


def _bwd_p_ds(q, k, v, do, lse, delta, causal: bool, scale: float,
              matmul=torch.matmul) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p, ds) in float32: p = exp(s - lse), ds = p * (dO V^T - delta) *
    scale."""
    p = torch.exp(_scores(q, k, causal, scale, matmul) - lse.unsqueeze(-1))
    dp = matmul(_wide(do), _wide(v).transpose(1, 2))
    return p, p * (dp - delta.unsqueeze(-1)) * scale


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool,
                           scale: float) -> torch.Tensor:
    """dQ = (p * (dO V^T - delta) * scale) K with p = exp(s - lse)."""
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale)
    return torch.matmul(ds, _wide(k)).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK = dS^T Q and dV = p^T dO."""
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.matmul(p.transpose(1, 2), _wide(do))
    dk = torch.matmul(ds.transpose(1, 2), _wide(q))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_tf32_reference(q, k, v, do, lse, delta, causal: bool,
                             scale: float, passes: int = 3
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of the plain backward pair (float32 inputs) with its
    six products, S, dP, dS K, p^T dO and dS^T Q, on TF32 operands as the
    tensor cores take them: passes=3 splits them as the float32 kernels do
    (3xTF32), passes=1 is a single TF32 pass, every operand rounded once,
    which the float32 kernels are not: their 5e-4 limit must reject that.
    For tests and checks; the backward counterpart of
    `flash_forward_tf32_reference`."""
    matmul = functools.partial(_matmul_tf32, passes=passes)
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale, matmul)
    return (matmul(ds, k.float()), matmul(ds.transpose(1, 2), q.float()),
            matmul(p.transpose(1, 2), do.float()))


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #


def _check_inputs(q, k, v, do=None, lse=None, delta=None, out=None) -> bool:
    """Validate kernel inputs; True when they lie on the card."""
    q_like = [t for t in (do, out) if t is not None]
    mats = [q, k, v] + q_like
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {dev}")
    for t in mats:
        if t.device != dev:
            raise ValueError("flash attention inputs lie on different devices")
        if t.dtype != q.dtype:
            raise ValueError("flash attention inputs differ in dtype")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError("flash attention takes contiguous [bh, seq, d]")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash attention takes float32, bfloat16 or "
                         f"float16, not {q.dtype}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != k.shape or sq == 0 or sk == 0:
        raise ValueError(f"flash attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    _refuse_head_dim(d, q.dtype)
    rows = min(TILES[name, q.dtype][d].rows for name in KERNELS)
    if bh * -(-max(sq, sk) // rows) >= 2 ** 31:
        raise ValueError(f"{bh} x {max(sq, sk)} rows exceed one launch grid")
    if any(t.shape != q.shape for t in q_like):
        raise ValueError("dO and out must have q's shape")
    for stat in (lse, delta):
        if stat is not None and (
                stat.shape != (bh, sq) or stat.dtype != torch.float32
                or stat.device != dev or not stat.is_contiguous()):
            raise ValueError("lse and delta must be contiguous float32 "
                             "[bh, seq_q]")
    on_card = dev.type == "cuda"
    if on_card and any(t.data_ptr() % 16 for t in mats):
        raise ValueError("the kernels need 16-byte aligned inputs")
    return on_card


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _flash_forward(q, k, v, causal: bool, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (out [bh, sq, d], lse [bh, sq] float32)."""
    if not _check_inputs(q, k, v):
        return flash_forward_reference(q, k, v, causal, scale)
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd.cu")
    with torch.cuda.device(q.device):
        code = lib.flash_fwd(*_ptrs(q, k, v, out, lse), bh, sq, k.shape[1],
                             d, int(causal), float(scale),
                             _DTYPE_CODES[q.dtype], _stream())
    _build.check(lib, "flash_fwd", code)
    _launches["flash_fwd"] += 1
    return out, lse


def _bwd_dq(q, k, v, do, out, lse, causal: bool, scale: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (dq [bh, sq, d], delta [bh, sq] float32). The kernel sums delta =
    rowsum(dO * O) of its rows in its prologue and writes it for K3."""
    if not _check_inputs(q, k, v, do, lse, out=out):
        delta = bwd_delta(out, do)
        return (flash_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                       scale), delta)
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    lib = _build.load("flash_bwd.cu")
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dq(*_ptrs(q, k, v, do, out, lse, delta, dq), bh,
                                sq, k.shape[1], d, int(causal), float(scale),
                                _DTYPE_CODES[q.dtype], _stream())
    _build.check(lib, "flash_bwd_dq", code)
    _launches["flash_bwd_dq"] += 1
    return dq, delta


def _bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dk, dv), each [bh, sk, d]."""
    if not _check_inputs(q, k, v, do, lse, delta):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    bh, sq, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_bwd.cu")
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dkv(*_ptrs(q, k, v, do, lse, delta, dk, dv), bh,
                                 sq, k.shape[1], d, int(causal), float(scale),
                                 _DTYPE_CODES[q.dtype], _stream())
    _build.check(lib, "flash_bwd_dkv", code)
    _launches["flash_bwd_dkv"] += 1
    return dk, dv


def bwd_delta(out, do) -> torch.Tensor:
    """delta_i = rowsum(dO * O), the softmax-jacobian diagonal term
    (float32 [bh, sq]): the plain version of what K2 computes on the card."""
    return (_wide(do) * _wide(out)).sum(dim=-1)


def _flash_backward(q, k, v, out, lse, do, causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2, then K3 with K2's delta: (dq, dk, dv), each in its input's shape
    and dtype."""
    dq, delta = _bwd_dq(q, k, v, do, out, lse, causal, scale)
    dk, dv = _bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


# --------------------------------------------------------------------------- #
# Shared memory and the differentiable entry point
# --------------------------------------------------------------------------- #


def kernel_smem_bytes(d: int, dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, int]:
    """Shared memory each kernel's block takes, from `TILES` (the formulas
    of csrc/: fwd_smem, dq_smem, dkv_smem and their wide counterparts, which
    the C entry points flash_fwd_smem and flash_bwd_smem report on the
    card)."""
    _refuse_head_dim(d, dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    return {name: _smem(name, TILES[name, dtype][d], d, size)
            for name in KERNELS}


class FlashAttention(torch.autograd.Function):
    """Kernel forward; kernel backward from the saved (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        b, h, sq, d = q.shape
        sk = k.shape[2]
        q3 = q.contiguous().view(b * h, sq, d)
        k3 = k.contiguous().view(b * h, sk, d)
        v3 = v.contiguous().view(b * h, sk, d)
        out3, lse = _flash_forward(q3, k3, v3, causal, scale)
        ctx.save_for_backward(q3, k3, v3, out3, lse)
        ctx.causal, ctx.scale = causal, scale
        return out3.view(b, h, sq, d)

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, out3, lse = ctx.saved_tensors
        b, h = g.shape[:2]
        do3 = g.contiguous().view(out3.shape)
        dq, dk, dv = _flash_backward(q3, k3, v3, out3, lse, do3, ctx.causal,
                                     ctx.scale)
        return (dq.view(b, h, *dq.shape[1:]), dk.view(b, h, *dk.shape[1:]),
                dv.view(b, h, *dv.shape[1:]), None, None)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blocked attention. q,k,v: [batch, heads, seq, head_dim].

    Runs the flash kernels (forward and backward) on the card, their plain
    versions on the CPU, when seq_q == seq_k and the head dim is one the
    kernels take (`head_dims`: 32, 64, 128, 192, 256 and every multiple of
    64 above, up to `WIDE_MAX_D`), in float32, bf16 or float16. Where the
    JAX package's `_use_pallas` answers by shape with `mha_reference`, so
    does this, on both devices: seq_q != seq_k (its causal mask aligns
    sequence ends while the kernels' starts both at 0), or a head dim that
    is not a multiple of 64 and has no kernel here (16, 48, 80, 96, ...).
    The choice depends on the shape alone, never on whether a kernel built
    or launched, so it hides no kernel. A multiple of 64 above
    `WIDE_MAX_D` raises: float32 stops at 704 (`F32_WIDE_MAX_D`), bf16
    and float16 at 1024 (`HALF_WIDE_MAX_D`). Each kernel's
    tiles are fixed by its source for each type and head dim (`TILES`);
    the kernels mask a ragged last tile, so any sequence length takes
    them."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.shape[2] != k.shape[2] or (d % 64 and d not in HEAD_DIMS):
        return mha_reference(q, k, v, causal=causal, scale=scale)
    _refuse_head_dim(d, q.dtype)
    return FlashAttention.apply(q, k, v, causal, float(scale))
