"""Ring attention: sequence/context parallelism over an sp group.

The port's copy of `ray_tpu/ops/ring_attention.py`. Each rank holds a
sequence shard of Q/K/V; the K/V shards travel around the ring of the sp
process group (`batch_isend_irecv` to rank + 1, from rank - 1: NCCL on the
card, gloo on the CPU) while each rank folds every chunk into its own
queries' output. The backward runs the ring again: dK/dV travel with their
chunk and come home after a full cycle carrying every rank's contribution,
as in the reference's second-ring backward.

Each chunk's local block is what the flash kernels compute (K1 forward, K2
dQ, K3 dK/dV, `ops/attention.py`), where the reference computes it with
float32 einsums. Chunk `src` against the rank's own queries `my`, both of
the shard's length:
  src == my   the causal kernel: equal lengths and offsets make the
              kernels' origin-0 mask the reference's offset mask;
  src <  my   the non-causal kernel: every key is visible;
  src >  my   skipped (causal only): the reference's -1e30 fill gives
              p = 0 exactly there, so the chunk adds nothing.
Chunks merge through their logsumexp in float32 (the reference's running
max/sum in another form); the backward uses the global lse and delta =
rowsum(dO * O) for every chunk (K2 computes delta from the global O). CPU
tensors run the kernels' plain versions, as every kernel wrapper does.

`ring_forward_step` and `ring_backward_step` are one step of the ring on
the chunk a rank holds, with no exchange: the exchange lives only in
`RingAttention`'s loop.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.ops import attention as _attn
from ray_tpu_torch.parallel.mesh import (mesh_shape_summary,
                                         validate_divisibility)

# (out, lse): the merged output so far, float32 [bh, s, d], and its row
# logsumexp, float32 [bh, s].
State = Tuple[torch.Tensor, torch.Tensor]


def _chunk_causal(q_offset: int, k_offset: int, causal: bool
                  ) -> Optional[bool]:
    """The kernels' causal flag for a chunk at these offsets, or None where
    it is skipped (every key after every query)."""
    if not causal:
        return False
    if k_offset > q_offset:
        return None
    return k_offset == q_offset


def _check_chunk(q, k_chunk) -> None:
    if q.shape[1] != k_chunk.shape[1]:
        raise ValueError(f"ring chunks must match the queries' length: q "
                         f"{tuple(q.shape)}, chunk {tuple(k_chunk.shape)}")


def ring_forward_step(state: Optional[State], q, k_chunk, v_chunk,
                      q_offset: int, k_offset: int, causal: bool,
                      scale: float) -> Optional[State]:
    """Fold one K/V chunk ([bh, s, d], keys from position `k_offset`) into
    the state of the queries q ([bh, s, d], from `q_offset`) through K1.
    `state` None is the state before any chunk."""
    _check_chunk(q, k_chunk)
    chunk_causal = _chunk_causal(q_offset, k_offset, causal)
    if chunk_causal is None:
        return state
    out_c, lse_c = _attn._flash_forward(q, k_chunk, v_chunk, chunk_causal,
                                        scale)
    if state is None:
        return out_c.float(), lse_c
    out, lse = state
    new = torch.logaddexp(lse, lse_c)
    out = (out * torch.exp(lse - new).unsqueeze(-1)
           + out_c.float() * torch.exp(lse_c - new).unsqueeze(-1))
    return out, new


def ring_backward_step(dk, dv, q, k_chunk, v_chunk, do, out, lse,
                       q_offset: int, k_offset: int, causal: bool,
                       scale: float):
    """One chunk of the backward through K2 and K3: (the chunk's dQ
    contribution in q's dtype, or None where the chunk is skipped; dk; dv).
    `out` and `lse` are the ring's global output and logsumexp; dk and dv
    are the chunk's traveling float32 gradients, added to in place."""
    _check_chunk(q, k_chunk)
    chunk_causal = _chunk_causal(q_offset, k_offset, causal)
    if chunk_causal is None:
        return None, dk, dv
    dq_c, delta = _attn._bwd_dq(q, k_chunk, v_chunk, do, out, lse,
                                chunk_causal, scale)
    dk_c, dv_c = _attn._bwd_dkv(q, k_chunk, v_chunk, do, lse, delta,
                                chunk_causal, scale)
    return dq_c, dk.add_(dk_c), dv.add_(dv_c)


def _exchange(tensors, group, rank: int, size: int):
    """Start sending `tensors` to rank + 1 of the ring and receiving their
    counterparts from rank - 1 into new buffers (contiguous, so the
    kernels take them). Returns (buffers, requests)."""
    nxt = dist.get_global_rank(group, (rank + 1) % size)
    prv = dist.get_global_rank(group, (rank - 1) % size)
    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
           + [dist.P2POp(dist.irecv, r, prv, group) for r in recv])
    return recv, dist.batch_isend_irecv(ops)


def _finish(pending):
    recv, reqs = pending
    for req in reqs:
        req.wait()
    return recv


class RingAttention(torch.autograd.Function):
    """Ring forward over the group; second-ring backward from the saved
    (q, k, v, out, lse). The next chunk's transfer overlaps this one's
    kernels. A ring of one exchanges nothing."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, scale: float):
        b, h, s, d = q.shape
        q3, k3, v3 = (t.contiguous().view(b * h, s, d) for t in (q, k, v))
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        state = None
        kc, vc = k3, v3
        for i in range(size):
            pending = (_exchange((kc, vc), group, rank, size)
                       if i < size - 1 else None)
            src = (rank - i) % size
            state = ring_forward_step(state, q3, kc, vc, rank * s, src * s,
                                      causal, scale)
            if pending is not None:
                kc, vc = _finish(pending)
        out3 = state[0].to(q.dtype)
        ctx.save_for_backward(q3, k3, v3, out3, state[1])
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out3.view(b, h, s, d)

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, out3, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        b, h = g.shape[:2]
        s = q3.shape[1]
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        do3 = g.contiguous().view(out3.shape)
        dq = torch.zeros(q3.shape, dtype=torch.float32, device=q3.device)
        dk = torch.zeros(k3.shape, dtype=torch.float32, device=k3.device)
        dv = torch.zeros_like(dk)
        kc, vc = k3, v3
        for i in range(size):
            pending = (_exchange((kc, vc), group, rank, size)
                       if i < size - 1 else None)
            src = (rank - i) % size
            dq_c, dk, dv = ring_backward_step(dk, dv, q3, kc, vc, do3, out3,
                                              lse, rank * s, src * s, causal,
                                              scale)
            if dq_c is not None:
                dq.add_(dq_c)
            if size > 1:  # dK/dV travel on with their chunk, home at the end
                dk, dv = _finish(_exchange((dk, dv), group, rank, size))
            if pending is not None:
                kc, vc = _finish(pending)
        return (dq.to(q3.dtype).view(b, h, s, -1),
                dk.to(k3.dtype).view(b, h, s, -1),
                dv.to(v3.dtype).view(b, h, s, -1), None, None, None)


def ring_attention(q, k, v, group=None, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a ring of sequence shards.

    q, k, v: this rank's sequence shard [batch, heads, seq_shard, head_dim]
    (shard r holds positions r * seq_shard onward, r its rank in `group`,
    the sp process group; None is the default group), in a type and head
    dim the flash kernels take."""
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"ring attention takes q, k, v of one shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if group is None:
        group = dist.group.WORLD
    return RingAttention.apply(q, k, v, group, causal, float(scale))


class _Layout:
    """Where this rank's block of a global [b, h, s, d] tensor lies on a
    mesh: its batch rows over the data axes (dp, then fsdp: dp-major) and
    its sequence shard over the sp axis."""

    def __init__(self, mesh, sp_axis: str, batch: int, seq: int):
        names = mesh.mesh_dim_names
        shape = mesh_shape_summary(mesh)
        coord = mesh.get_coordinate()
        data = [a for a in ("dp", "fsdp") if a in names]
        # (group, ways, index) of each split, the innermost first: the
        # order in which `gather` rebuilds the global tensor.
        self.splits = [(2, mesh.get_group(sp_axis), shape[sp_axis],
                        coord[names.index(sp_axis)])] + [
            (0, mesh.get_group(a), shape[a], coord[names.index(a)])
            for a in reversed(data)]
        rows = batch
        self.row0 = 0
        for a in data:
            rows //= shape[a]
        ways = 1
        for _, _, n, i in self.splits[1:]:
            self.row0 += i * ways * rows
            ways *= n
        self.rows = rows
        if seq % shape[sp_axis]:
            raise ValueError(f"sequence length {seq} not divisible by "
                             f"{sp_axis}={shape[sp_axis]}")
        self.seq = seq // shape[sp_axis]
        self.seq0 = coord[names.index(sp_axis)] * self.seq

    def slice(self, x):
        return x[self.row0:self.row0 + self.rows, :,
                 self.seq0:self.seq0 + self.seq].contiguous()

    def gather(self, x):
        for dim, group, ways, _ in self.splits:
            if ways > 1:
                parts = [torch.empty_like(x) for _ in range(ways)]
                dist.all_gather(parts, x.contiguous(), group=group)
                x = torch.cat(parts, dim=dim)
        return x


class _ToShard(torch.autograd.Function):
    """A global tensor that every rank holds -> this rank's block. Its
    backward gathers the blocks' gradients, so every rank gets the whole
    gradient, as with the reference's global arrays."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return layout.slice(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.gather(g), None


class _ToGlobal(torch.autograd.Function):
    """This rank's block -> the global tensor. Every rank computes the
    same replicated loss from it, so each holds the same whole upstream
    gradient: the backward slices it (an all-gather's reduce-scatter
    would scale it by the number of blocks)."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return layout.gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.slice(g), None


def ring_attention_sharded(q, k, v, mesh, causal: bool = True,
                           scale: Optional[float] = None,
                           sp_axis: str = "sp") -> torch.Tensor:
    """Ring attention over the mesh's sp axis, on global tensors.

    q, k, v: the global [batch, heads, seq, head_dim] tensors, the same on
    every rank of `mesh` (a DeviceMesh). Each rank takes its batch rows
    over dp/fsdp and its sequence shard over `sp_axis`, runs the ring over
    that axis's group, and all-gathers the output back to the global
    layout. With no sp axis, or sp = 1, this is `flash_attention`."""
    shape = mesh_shape_summary(mesh)
    if shape.get(sp_axis, 1) == 1:
        return _attn.flash_attention(q, k, v, causal, scale)
    validate_divisibility(mesh, q.shape[0], q.shape[2])
    layout = _Layout(mesh, sp_axis, q.shape[0], q.shape[2])
    out = ring_attention(*(_ToShard.apply(t, layout) for t in (q, k, v)),
                         group=mesh.get_group(sp_axis), causal=causal,
                         scale=scale)
    return _ToGlobal.apply(out, layout)
