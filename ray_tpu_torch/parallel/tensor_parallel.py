"""Tensor, data and fully-sharded parallelism over a mesh's process groups.

What the JAX package leaves to GSPMD (`make_train_step(mesh=)`, whose
logical constraints let XLA place the psums over tp), the port does by
hand, one process a rank:

- tp is Megatron-style column-then-row parallelism on each rank's LOCAL
  shards: a column product reads a replicated input through `copy_in`
  (identity forward, all-reduce of the gradient over tp) and a row product
  ends in `reduce_out` (all-reduce forward, identity backward), so each
  attention block and each MLP costs one all-reduce over tp forward and one
  backward. The embedding and the tied or untied head are vocab-parallel:
  the lookup is masked to the rank's rows and all-reduced, the logits stay
  vocab-sharded, `vocab_parallel_nll` takes a max and a sum over tp, and
  `vocab_parallel_argmax` (the serving engine's greedy pick) gathers each
  rank's best.
- fsdp is FSDP2 (`fully_shard`) over the mesh's fsdp axis, each parameter
  sharded on its "embed" dim where it has one (the reference's rule);
  gradients are reduce-scattered.
- dp, dcn_dp and sp all-reduce the gradients of the replicated parameters
  (`sync_gradients`).
- ep (MoE's expert parallelism, `models/moe.py`) holds E / ep of the
  experts a rank. Tokens are replicated over ep as over tp, so the
  experts' partial sums close over ep and tp together: `expert_copy_in`
  and `expert_reduce_out` are `copy_in` and `reduce_out` over both
  groups. An expert weight's gradient is its rank's alone, and ep is never
  among the groups a gradient is summed over.

Parameters are DTensors: their tp placement on the mesh's tp sub-mesh,
which FSDP2 extends over (fsdp, tp). The flash kernels never see one: a
module takes `local(p)`, the plain tensor of this rank's shard.

Losses are normalised over the GLOBAL batch, the numerator and the
denominator reduced apart (`next_token_loss_parts`), so every reduction of
a gradient over a data axis is a sum.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ray_tpu_torch.parallel.mesh import (DATA_AXES, axis_group, axis_rank,
                                         axis_size)


def local(t):
    """This rank's shard of a DTensor as a plain tensor (autograd flows
    back to the DTensor); a plain tensor as it is."""
    to_local = getattr(t, "to_local", None)
    return to_local() if to_local is not None else t


@dataclass
class MeshContext:
    """A rank's view of a training mesh: its tp, sp and ep lines, the
    groups that sum losses and gradients, and whether FSDP2 shards over
    fsdp.

    tp and sp collectives run on every mesh that has the axis, at size 1
    too (the sharded code path is the one that runs); gradient all-reduces
    skip axes of size 1, where they change nothing."""

    mesh: Any
    tp_group: Any = None
    tp_size: int = 1
    tp_rank: int = 0
    sp_group: Any = None
    sp_size: int = 1
    sp_rank: int = 0
    ep_group: Any = None
    ep_size: int = 1
    ep_rank: int = 0
    fsdp: bool = False
    # The groups of the axes of size > 1 that a loss is summed over (data
    # and sp) and that replicated gradients are summed over (the data axes
    # FSDP2 does not reduce, and sp).
    loss_groups: List[Any] = field(default_factory=list)
    grad_groups: List[Any] = field(default_factory=list)

    @classmethod
    def of(cls, mesh) -> "MeshContext":
        names = mesh.mesh_dim_names
        fsdp = "fsdp" in names
        ctx = cls(mesh=mesh, fsdp=fsdp,
                  tp_group=axis_group(mesh, "tp"),
                  tp_size=axis_size(mesh, "tp"), tp_rank=axis_rank(mesh, "tp"),
                  sp_group=axis_group(mesh, "sp"),
                  sp_size=axis_size(mesh, "sp"), sp_rank=axis_rank(mesh, "sp"),
                  ep_group=axis_group(mesh, "ep"),
                  ep_size=axis_size(mesh, "ep"), ep_rank=axis_rank(mesh, "ep"))
        for name in (*DATA_AXES, "sp"):
            if name in names and axis_size(mesh, name) > 1:
                group = mesh.get_group(name)
                ctx.loss_groups.append(group)
                if not (fsdp and name == "fsdp"):
                    ctx.grad_groups.append(group)
        return ctx

    @property
    def tp_mesh(self):
        return self.mesh["tp"] if "tp" in self.mesh.mesh_dim_names else None

    @property
    def fsdp_size(self) -> int:
        return axis_size(self.mesh, "fsdp")

    # -- tp collectives ------------------------------------------------------

    def copy_in(self, x):
        """A replicated activation entering column products: identity
        forward, its gradient all-reduced over tp."""
        return _CopyIn.apply(x, (self.tp_group,)) \
            if self.tp_group is not None else x

    def reduce_out(self, x):
        """Partial sums of row products (or of a masked lookup): all-reduced
        over tp forward, the gradient passed through."""
        return _ReduceOut.apply(x, (self.tp_group,)) \
            if self.tp_group is not None else x

    @property
    def expert_groups(self) -> tuple:
        """The groups that hold one token shard's experts between them: ep
        (each rank E / ep experts) and tp (each expert's hidden columns
        split), those the mesh has."""
        return tuple(g for g in (self.ep_group, self.tp_group)
                     if g is not None)

    def expert_copy_in(self, x):
        """A replicated tensor entering this rank's experts: identity
        forward, its gradient (this rank's experts' part) all-reduced over
        ep and tp."""
        groups = self.expert_groups
        return _CopyIn.apply(x, groups) if groups else x

    def expert_reduce_out(self, x):
        """This rank's experts' partial sum: all-reduced over ep and tp
        forward, the gradient passed through."""
        groups = self.expert_groups
        return _ReduceOut.apply(x, groups) if groups else x

    def gather_rows(self, x):
        """This rank's contiguous dim-0 shard of a tp-sharded tensor
        gathered whole on every tp rank; the gradient is reduce-scattered
        back to the shard."""
        return _GatherRows.apply(x, self.tp_group) \
            if self.tp_group is not None else x


class _CopyIn(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over each of `groups`."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    """All-reduced over each of `groups` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, groups):
        x = x.contiguous().clone()
        for group in groups:
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        size = dist.get_world_size(group)
        x = x.contiguous()
        out = x.new_empty((size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        size = dist.get_world_size(ctx.group)
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // size, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return out, None


# --------------------------------------------------------------------------- #
# Vocab-parallel embedding and cross-entropy
# --------------------------------------------------------------------------- #


def vocab_parallel_embedding(ids, weight, ctx: Optional[MeshContext]):
    """The rows of `weight` ([vocab, e], this rank's vocab shard when
    `ctx` has tp) that `ids` name: each rank looks up the ids in its
    shard, zeros the others, and the tp ranks sum. Without `ctx`, a plain
    lookup."""
    if ctx is None:
        return weight[ids]
    n = weight.shape[0]
    shifted = ids - ctx.tp_rank * n
    inside = (shifted >= 0) & (shifted < n)
    rows = weight[shifted.clamp(0, n - 1)]
    rows = torch.where(inside.unsqueeze(-1), rows, torch.zeros_like(rows))
    return ctx.reduce_out(rows)


def vocab_parallel_argmax(logits, ctx: Optional[MeshContext]):
    """The greedy pick, `logits.argmax(dim=-1)` over the whole vocab, of
    logits [..., vocab / tp] split on the last dim over tp: each rank takes
    its best column (the first of equal ones) and its value, offset to the
    global index, one all-gather brings every rank's, and the largest value
    wins, the lowest rank on a tie. So a tie goes to the lowest global
    index, as `torch.argmax` and `jnp.argmax` break it, and every rank gets
    the same indices. Without tp, the plain argmax."""
    if ctx is None or ctx.tp_group is None:
        return logits.argmax(dim=-1)
    idx = logits.argmax(dim=-1, keepdim=True)
    # Values and indices in one float64 tensor, both exact there (a 16-bit
    # or float32 logit, an index below 2^53): one exchange, not two.
    mine = torch.stack([logits.gather(-1, idx).squeeze(-1).double(),
                        (idx.squeeze(-1) + ctx.tp_rank * logits.shape[-1])
                        .double()])
    every = mine.new_empty((ctx.tp_size * 2, *mine.shape[1:]))
    dist.all_gather_into_tensor(every, mine, group=ctx.tp_group)
    every = every.view(ctx.tp_size, *mine.shape)
    best = every[:, 0].argmax(dim=0, keepdim=True)
    return every[:, 1].gather(0, best).squeeze(0).long()


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[target] over logits split on the last dim over
    `group` (this rank's columns from `start`), in float32: the max and
    the sum of exponentials are all-reduced, and the target's logit comes
    from the rank that holds it. The backward gives each rank's columns
    softmax - one-hot, times the incoming gradient."""

    @staticmethod
    def forward(ctx, logits, targets, start: int, group):
        n = logits.shape[-1]
        m = logits.max(dim=-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        shifted = logits - m.unsqueeze(-1)
        rel = targets - start
        inside = (rel >= 0) & (rel < n)
        idx = rel.clamp(0, n - 1).unsqueeze(-1)
        tgt = torch.where(inside, shifted.gather(-1, idx).squeeze(-1),
                          torch.zeros_like(m))
        dist.all_reduce(tgt, group=group)
        exp = shifted.exp_()
        sumexp = exp.sum(dim=-1)
        dist.all_reduce(sumexp, group=group)
        nll = sumexp.log() - tgt
        exp.div_(sumexp.unsqueeze(-1))          # softmax, kept for backward
        ctx.save_for_backward(exp, idx, inside)
        return nll

    @staticmethod
    def backward(ctx, g):
        # In place on the saved softmax: one backward, no copy of the
        # [tokens, vocab / tp] float32 tensor.
        grad, idx, inside = ctx.saved_tensors
        grad.scatter_add_(-1, idx, -inside.unsqueeze(-1).to(grad.dtype))
        return grad.mul_(g.unsqueeze(-1)), None, None, None


def vocab_parallel_nll(logits, targets, ctx: Optional[MeshContext]):
    """Per-token negative log-likelihood (float32) of `targets` under
    `logits` [..., vocab] split over tp: logsumexp - logit[target], as
    `next_token_loss` computes it on whole logits."""
    logits = logits.float()
    if ctx is None or ctx.tp_group is None:
        lse = torch.logsumexp(logits, dim=-1)
        return lse - logits.gather(-1, targets.unsqueeze(-1)).squeeze(-1)
    return _VocabParallelNLL.apply(logits, targets,
                                   ctx.tp_rank * logits.shape[-1],
                                   ctx.tp_group)


def next_token_targets(labels, ctx: Optional[MeshContext],
                       ignore_index: int = -100):
    """Each position's next label, on this rank's sequence shard: its own
    labels shifted by one, and at its end the first label of the next sp
    shard (gathered over sp), `ignore_index` after the sequence's last."""
    b = labels.shape[0]
    tail = torch.full((b, 1), ignore_index, dtype=labels.dtype,
                      device=labels.device)
    if ctx is not None and ctx.sp_group is not None and ctx.sp_size > 1:
        firsts = labels.new_empty((ctx.sp_size * b, 1))
        dist.all_gather_into_tensor(firsts, labels[:, :1].contiguous(),
                                    group=ctx.sp_group)
        if ctx.sp_rank < ctx.sp_size - 1:
            tail = firsts.view(ctx.sp_size, b, 1)[ctx.sp_rank + 1]
    return torch.cat([labels[:, 1:], tail], dim=1)


def global_sum(x, ctx: Optional[MeshContext]):
    """`x` summed over the loss axes (the data axes and sp), in place on a
    copy, without autograd."""
    x = x.detach().clone()
    for group in (ctx.loss_groups if ctx is not None else ()):
        dist.all_reduce(x, group=group)
    return x


def next_token_loss_parts(logits, labels, ctx: Optional[MeshContext],
                          ignore_index: int = -100):
    """(objective, shown) of the shifted cross-entropy on this rank's shard
    of the batch and sequence, with vocab-sharded logits [b, s, vocab / tp]:
    the reference's sum(nll * mask) / sum(mask) over the GLOBAL batch. The
    denominator is summed over the data axes and sp first, so `objective`
    is this rank's share (its gradients sum over those axes to the global
    loss's) and `shown` the global loss, the same on every rank."""
    targets = next_token_targets(labels, ctx, ignore_index)
    mask = targets != ignore_index
    targets = torch.where(mask, targets, torch.zeros_like(targets))
    nll = vocab_parallel_nll(logits, targets, ctx)
    num = (nll * mask).sum()
    den = global_sum(mask.sum().to(torch.float64), ctx).clamp_min(1)
    objective = num / den.to(num.dtype)
    shown = global_sum(num.to(torch.float64), ctx) / den
    return objective, shown.to(num.dtype)


# --------------------------------------------------------------------------- #
# Placing a module on the mesh
# --------------------------------------------------------------------------- #


def _set_param(module: nn.Module, name: str, value) -> None:
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    setattr(module, leaf, nn.Parameter(value))


def local_piece(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's piece of the whole tensor `t` (a view) in the layout
    `placements` give on `mesh`: contiguous chunks along each sharded
    dim, DTensor's own split."""
    from torch.distributed.tensor import Shard

    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            t = t.chunk(mesh.size(mesh_dim), dim=pl.dim)[
                mesh.get_local_rank(mesh_dim)]
    return t


def shard_local(t: torch.Tensor, mesh, placements):
    """A DTensor over `mesh` whose local shard each rank copies out of
    the whole `t` (every rank holds the same values): no communication,
    and no storage shared with `t`."""
    from torch.distributed.tensor import DTensor

    piece = local_piece(t, mesh, placements)
    return DTensor.from_local(piece.clone(memory_format=torch.contiguous_format),
                              mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


def tp_placements(dim: Optional[int]) -> tuple:
    """The placement on a tp sub-mesh of a parameter split on `dim` (None:
    replicated)."""
    from torch.distributed.tensor import Replicate, Shard

    return (Replicate(),) if dim is None else (Shard(dim),)


def place_module(module: nn.Module, ctx: MeshContext,
                 tp_dims: Dict[str, Optional[int]],
                 fsdp_dims: Dict[str, int],
                 blocks: Sequence[nn.Module] = ()) -> None:
    """Make `module`'s parameters DTensors on the mesh, in place: each
    whole parameter (every rank holds the same values) keeps its tp shard,
    dim `tp_dims[name]` (None: replicated), on the tp sub-mesh, and a
    parameter that is a DTensor already stays as it is; then, where the
    mesh has fsdp, FSDP2 shards each of `blocks` and the module over fsdp,
    parameter `name` on dim `fsdp_dims[name]`."""
    from torch.distributed.tensor import Shard

    tp_mesh = ctx.tp_mesh
    if tp_mesh is not None:
        for name, p in list(module.named_parameters()):
            if not hasattr(p, "device_mesh"):
                _set_param(module, name,
                           shard_local(p.detach(), tp_mesh,
                                       tp_placements(tp_dims[name])))
    if not ctx.fsdp:
        return
    from torch.distributed.fsdp import fully_shard

    dims = {id(p): fsdp_dims[name] for name, p in module.named_parameters()}

    def placement(p):
        return Shard(dims[id(p)])

    fsdp_mesh = ctx.mesh["fsdp"]
    for blk in blocks:
        fully_shard(blk, mesh=fsdp_mesh, shard_placement_fn=placement)
    fully_shard(module, mesh=fsdp_mesh, shard_placement_fn=placement)


def sync_gradients(params: Iterable[torch.Tensor], ctx: MeshContext) -> None:
    """Sum the gradients of `params` over the axes that replicate them and
    that FSDP2 does not reduce (dp, dcn_dp, sp; fsdp on a mesh without
    FSDP2), in place, one flat all-reduce a group. Never over ep: a
    parameter replicated there gets its whole gradient on every ep rank
    (`expert_copy_in`), and an expert weight is its rank's own."""
    if not ctx.grad_groups:
        return
    grads = [local(p.grad) for p in params if p.grad is not None]
    if not grads:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        for group in ctx.grad_groups:
            dist.all_reduce(flat, group=group)
        offset = 0
        for g in same:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n


def full_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters whole on every rank (`full_tensor()` of
    each DTensor), by name: collective, every rank calls it. (Gathering
    FSDP2's strided shards takes two all-gathers, which DTensor logs a
    warning for at each call; the gather is a one-off, so it is muted.)"""
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        out = {}
        for name, p in module.named_parameters():
            p = p.detach()
            out[name] = p.full_tensor() if hasattr(p, "full_tensor") else p
        return out
    finally:
        log.setLevel(level)


def place_like(t: torch.Tensor, like):
    """The whole tensor `t` placed as `like` is (a DTensor's mesh and
    placements, FSDP2's strided shards included); `t` itself when `like`
    is a plain tensor."""
    if not hasattr(like, "device_mesh"):
        return t.to(like.device)
    from torch.distributed.tensor import Replicate, distribute_tensor

    mesh = like.device_mesh
    whole = distribute_tensor(t.to(like.device), mesh,
                              [Replicate()] * mesh.ndim)
    return whole.redistribute(mesh, like.placements)


__all__ = [
    "MeshContext", "local", "vocab_parallel_embedding", "vocab_parallel_nll",
    "vocab_parallel_argmax", "local_piece", "shard_local", "tp_placements",
    "next_token_targets", "next_token_loss_parts", "global_sum",
    "place_module", "sync_gradients", "full_state",
    "place_like",
]
