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
for the other. On the card the body is chosen by type and head dim: bf16
and float16 at d <= 128 run the Hopper bodies (TMA ring, wgmma), float32
and the 16-bit types at d 192 and 256 the CUDA-core bodies, and every type
at a multiple of 64 above 256 the wide bodies, which take d at run time and
keep their accumulators in shared memory (`TILES` lists each one's tiles).
The dQ kernel runs first in the backward and also writes delta =
rowsum(dO * O), which the dK/dV kernel reads.
"""

from __future__ import annotations

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
    stages: int   # slots of the ring the streamed tiles pass through
    ring: bool    # TMA ring + wgmma (Hopper body), or the CUDA cores
    split: int = 1  # warps per 16 owned rows, each with its share of columns
    wide: bool = False  # d at run time, accumulators in shared memory


def _plain(name: str, d: int) -> Tile:
    """A CUDA-core body's tiles (csrc/flash_common.cuh BLOCK, PlainTiles):
    above d = 128 it streams 32-row tiles, and the dK/dV block splits dK's
    and dV's columns between two warps per 16 keys."""
    if d <= 128:
        return Tile(64, 64, 1, False)
    return Tile(64, 32, 1, False, 2 if name == "flash_bwd_dkv" else 1)


# The Hopper bodies' tiles (flash_common.cuh FwdTiles, DqTiles, DkvTiles):
# dQ and dK/dV stream a smaller tile at d = 128, where their accumulators
# take the most registers, and dQ has 4 slots.
_RING = {
    "flash_fwd": dict.fromkeys((32, 64, 128), Tile(128, 128, 3, True)),
    "flash_bwd_dkv": {32: Tile(128, 64, 3, True), 64: Tile(128, 64, 3, True),
                      128: Tile(128, 32, 3, True)},
    "flash_bwd_dq": {32: Tile(128, 128, 4, True),
                     64: Tile(128, 128, 4, True),
                     128: Tile(128, 64, 4, True)},
}
# The wide bodies' tiles (flash_common.cuh, namespace wide: ROWS and the
# *_STREAM rows): one instance per type serves every multiple of 64 above
# 256, up to the largest whose shared memory fits (`WIDE_MAX_D`).
_WIDE = {"flash_fwd": Tile(16, 16, 1, False, wide=True),
         "flash_bwd_dq": Tile(16, 16, 1, False, wide=True),
         "flash_bwd_dkv": Tile(16, 8, 1, False, wide=True)}


def _smem(name: str, t: Tile, d: int, size: int) -> int:
    """Shared memory of one block of kernel `name` with tiles `t` at head
    dim d for elements of `size` bytes (the formulas of csrc/)."""
    if t.wide:
        # float32 accumulators (O; dQ; dK and dV) and P / dS tiles, then
        # the owned and streamed rows padded by 16 bytes; dK/dV keeps the
        # streamed rows' lse and delta.
        row = (d + 16 // size) * size
        n_acc, n_p, owned = {"flash_fwd": (1, 1, 1), "flash_bwd_dq": (1, 1, 2),
                             "flash_bwd_dkv": (2, 2, 2)}[name]
        out = 4 * t.rows * (n_acc * d + n_p * t.stream) \
            + (owned * t.rows + 2 * t.stream) * row
        return out + (2 * t.stream * 4 if name == "flash_bwd_dkv" else 0)
    if t.ring:
        # Tiles are unpadded (TMA swizzles them); one 8-byte mbarrier per
        # resident load and two per slot; 1024 bytes to align the swizzle
        # pattern. Resident: Q (forward); Q, dO and O (dQ); K and V (dK/dV).
        owned = {"flash_fwd": 1, "flash_bwd_dq": 3,
                 "flash_bwd_dkv": 2}[name] * t.rows * d * size
        slot = 2 * t.stream * d * size
        if name == "flash_bwd_dkv":
            slot += 2 * t.stream * 4       # lse and delta
        return owned + t.stages * slot + 8 * (1 + 2 * t.stages) + 1024
    # Rows padded by 16 bytes; each warp's rows of P or dS get a tile of
    # their own; dK/dV keeps lse and delta beside its tiles. Owned: Q
    # (forward); Q and dO (dQ); K and V (dK/dV).
    row = (d + 16 // size) * size
    owned = 1 if name == "flash_fwd" else 2
    p_tile = t.split * t.rows * (t.stream + 16 // size) * size
    out = (owned * t.rows + 2 * t.stream) * row + p_tile
    return out + (2 * t.stream * 4 if name == "flash_bwd_dkv" else 0)


def _wide_max_d(dtype: torch.dtype) -> int:
    """The largest multiple of 64 at which all three wide blocks fit."""
    size = torch.tensor([], dtype=dtype).element_size()
    d = 256
    while all(_smem(n, t, d + 64, size) <= SMEM_LIMIT
              for n, t in _WIDE.items()):
        d += 64
    return d


# dtype -> the largest head dim the kernels take: 704 in float32 and 1024
# in bf16 and float16 (the wide dK/dV block's shared memory bounds both).
WIDE_MAX_D: Dict[torch.dtype, int] = {dt: _wide_max_d(dt)
                                      for dt in _DTYPE_CODES}


def head_dims(dtype: torch.dtype) -> Tuple[int, ...]:
    """Every head dim the kernels take in this dtype: `HEAD_DIMS`, then
    the multiples of 64 above 256 up to `WIDE_MAX_D`."""
    return HEAD_DIMS + tuple(range(320, WIDE_MAX_D[dtype] + 1, 64))


# (kernel, dtype) -> {head dim: Tile}, mirroring csrc/: bf16 and float16 run
# the Hopper bodies at d <= 128 and the CUDA-core bodies at 192 and 256;
# float32 runs the CUDA-core bodies up to 256; every type runs the wide
# bodies above 256.
TILES: Dict[Tuple[str, torch.dtype], Dict[int, Tile]] = {
    (name, dtype): {d: (_WIDE[name] if d > 256
                        else _RING[name][d] if dtype in _HALF
                        and d in _RING[name] else _plain(name, d))
                    for d in head_dims(dtype)}
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
            f"head dim {d}: above {WIDE_MAX_D[dtype]} the kernels' tiles "
            f"in {dtype} exceed the {SMEM_LIMIT} bytes of shared memory a "
            f"block may take")
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
# Plain versions of the kernels: [bh, seq, d], float32 arithmetic
# --------------------------------------------------------------------------- #


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """Scaled, masked float32 scores [bh, sq, sk]; the causal mask starts
    both positions at 0, as the kernels' does."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    return s


def flash_forward_reference(q, k, v, causal: bool, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [bh, sq, d] in q's dtype, lse [bh, sq] float32)."""
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, v.float()) / denom
    return out.to(q.dtype), (m + torch.log(denom)).squeeze(-1)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool,
                           scale: float) -> torch.Tensor:
    """dQ = (p * (dO V^T - delta) * scale) K with p = exp(s - lse)."""
    p = torch.exp(_scores(q, k, causal, scale) - lse.unsqueeze(-1))
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta.unsqueeze(-1)) * scale
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK = dS^T Q and dV = p^T dO."""
    p = torch.exp(_scores(q, k, causal, scale) - lse.unsqueeze(-1))
    dv = torch.matmul(p.transpose(1, 2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta.unsqueeze(-1)) * scale
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


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
    return (do.float() * out.float()).sum(dim=-1)


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
    `WIDE_MAX_D` (704 in float32, 1024 in bf16 and float16) raises: the
    wide kernels' tiles no longer fit the 227 KB of shared memory a block
    may take, a resource limit as the TPU kernels' VMEM is. Each kernel's
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
