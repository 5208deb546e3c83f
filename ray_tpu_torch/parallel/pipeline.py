"""Pipeline parallelism: GPipe microbatch schedule over the `pp` mesh axis.

The port's copy of `ray_tpu/parallel/pipeline.py`. Where the JAX package
wraps a layer function into one SPMD program with `shard_map`, the port
runs it as a per-rank program over the mesh's pp group, one process a
stage:

- The model's repeated trunk (L identical layers) is stacked into per-leaf
  `[n_stages, layers_per_stage, ...]` tensors whose leading dim is the
  stage (`stage_shardings`: `Shard(0)` over pp, the rest replicated).
- `gpipe` turns a single-layer apply into the program each rank runs: it
  holds its stage, runs its local layers in order, and for `n_microbatches
  + n_stages - 1` ticks swaps stage boundaries with its ring neighbours
  (`_RingShift`, an autograd Function: forward sends to rank + 1 and
  receives from rank - 1, backward the reverse). Every rank runs every tick,
  so the exchanges stay in lockstep, forward and backward. The pipelined
  backward is autograd's through those exchanges (`remat_stage=True` runs
  each stage under `torch.utils.checkpoint`).
- Embedding and LM head run outside the pipelined trunk, on every rank.
  The trunk's input enters with a backward that sums over pp (only stage 0
  reads it), and its output leaves through a sum over pp whose backward
  passes the gradient through unchanged (an all-reduce's would multiply
  the trunk's gradients by pp): the replicated embed, pos and head get the
  global gradients on every pp rank.
- With dp (or fsdp) in the mesh, each dp slice pipelines its share of each
  microbatch, as the JAX package's `x_spec` does; gradients are partial
  over dp and `make_pp_train_step` sums them there.

Stage 0 feeds microbatch `t` while later stages take what the ring
delivered; the last stage's outputs are collected tick-aligned and summed
over pp (zeros elsewhere), so the schedule is a fixed function of the tick
and the rank.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._torch_env import resolve_device

BATCH_AXES = ("dp", "fsdp")


def stack_stage_params(layer_params: Dict[str, torch.Tensor], n_stages: int
                       ) -> Dict[str, torch.Tensor]:
    """Reshape stacked layers `[L, ...]` to `[P, L/P, ...]`."""

    def reshape(leaf):
        n = leaf.shape[0]
        if n % n_stages:
            raise ValueError(
                f"{n} layers not divisible by {n_stages} pipeline stages")
        return leaf.reshape(n_stages, n // n_stages, *leaf.shape[1:])

    return {k: reshape(v) for k, v in layer_params.items()}


def unstack_stage_params(staged_params: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of `stack_stage_params`: `[P, L/P, ...]` -> `[L, ...]`."""
    return {k: v.reshape(v.shape[0] * v.shape[1], *v.shape[2:])
            for k, v in staged_params.items()}


def to_microbatches(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches}"
                         " microbatches")
    return x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])


def from_microbatches(y: torch.Tensor) -> torch.Tensor:
    return y.reshape(y.shape[0] * y.shape[1], *y.shape[2:])


# --------------------------------------------------------------------------- #
# The exchanges, as autograd Functions
# --------------------------------------------------------------------------- #


def _exchange(x: torch.Tensor, group, send_to: int, recv_from: int
              ) -> torch.Tensor:
    """Send x to global rank `send_to` and receive a tensor like it from
    `recv_from`, both posted at once."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, send_to, group),
           dist.P2POp(dist.irecv, out, recv_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """Forward: send to the next stage, receive from the previous one (the
    JAX package's `ppermute` with perm i -> i + 1 mod P). Backward: the
    gradient travels the other way."""

    @staticmethod
    def forward(ctx, x, group, to_next, to_prev):
        ctx.group, ctx.to_next, ctx.to_prev = group, to_next, to_prev
        return _exchange(x, group, to_next, to_prev)

    @staticmethod
    def backward(ctx, grad):
        return (_exchange(grad, ctx.group, ctx.to_prev, ctx.to_next),
                None, None, None)


class _EnterPipe(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group:
    the trunk's input is replicated over pp and only stage 0 reads it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _LeavePipe(torch.autograd.Function):
    """Sum over the group forward (the JAX package's final `psum`); the
    backward passes the gradient through unchanged: every rank holds the
    one replicated output and the same cotangent of it."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherBatch(torch.autograd.Function):
    """All-gather along `dim` over a batch axis's group; the backward keeps
    this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        rank = dist.get_rank(ctx.group)
        return grad.chunk(n, dim=ctx.dim)[rank].contiguous(), None, None


def _local(t):
    """A DTensor's local shard (differentiable), or the tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _batch_axes(mesh) -> List[str]:
    return [a for a in BATCH_AXES if a in mesh.mesh_dim_names]


def _batch_slice(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's share of `dim` over the batch axes (the slowest axis
    first, as P(None, ("dp", "fsdp")) splits it)."""
    for axis in _batch_axes(mesh):
        group = mesh.get_group(axis)
        x = x.chunk(dist.get_world_size(group), dim=dim)[
            dist.get_rank(group)]
    return x


def _batch_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    for axis in reversed(_batch_axes(mesh)):
        x = _GatherBatch.apply(x, mesh.get_group(axis), dim)
    return x


def gpipe(layer_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor],
                             torch.Tensor], mesh, n_microbatches: int,
          axis: str = "pp", remat_stage: bool = False):
    """Build `run(staged_params, x_mb, gather=True) -> y`, this rank's part
    of running layer_fn's stack pipelined over the mesh's `axis` group.

    `staged_params` leaves are `[P, L/P, ...]` (see stack_stage_params): a
    DTensor placed `Shard(0)` over `axis` (or its local `[1, L/P, ...]`
    shard), or the whole tensor, of which the rank takes its stage. `x_mb`
    is the whole `[M, mb, ...]` microbatched input on every rank. `y` equals
    the sequential application of all L layers (same math, pipelined
    schedule). With batch axes in the mesh each rank pipelines its share of
    dim 1; `gather=True` returns the whole of it on every rank (the
    backward keeps the rank's rows, so gradients are partial over the batch
    axes), `gather=False` the rank's share."""

    def stage_fn(stage_params, x):
        n_local = next(iter(stage_params.values())).shape[0]
        for i in range(n_local):
            x = layer_fn({k: v[i] for k, v in stage_params.items()}, x)
        return x

    if remat_stage:
        plain = stage_fn

        def stage_fn(stage_params, x):
            return checkpoint(plain, stage_params, x, use_reentrant=False)

    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    idx = dist.get_rank(group)
    to_next = dist.get_global_rank(group, (idx + 1) % n_stages)
    to_prev = dist.get_global_rank(group, (idx - 1) % n_stages)

    def local_stage(leaf):
        local = _local(leaf)
        return local[idx] if local.shape[0] == n_stages else local[0]

    def run(staged_params, x_mb, gather: bool = True):
        stage_params = {k: local_stage(v) for k, v in staged_params.items()}
        x_mb = _batch_slice(x_mb, mesh, dim=1)
        if n_stages > 1:
            x_mb = _EnterPipe.apply(x_mb, group)
        m = x_mb.shape[0]
        zero_mb = torch.zeros_like(x_mb[0])
        first = torch.tensor(idx == 0, device=x_mb.device)
        buf, outs = zero_mb, []
        for t in range(m + n_stages - 1):
            # Stage 0 feeds microbatch t (while there is one); the others
            # take what the ring delivered last tick. A select, not a
            # branch: every rank's graph holds every exchange, so the
            # backward's exchanges run on every rank too.
            feed = x_mb[t] if t < m else zero_mb
            inp = torch.where(first, feed, buf)
            out = stage_fn(stage_params, inp)
            if n_stages > 1:
                buf = _RingShift.apply(out, group, to_next, to_prev)
            outs.append(out)
        # The last stage emitted microbatch j's output at tick j + P - 1.
        tail = torch.stack(outs[n_stages - 1:])
        if n_stages > 1:
            last = torch.tensor(idx == n_stages - 1, device=tail.device)
            y = _LeavePipe.apply(torch.where(last, tail,
                                             torch.zeros_like(tail)), group)
        else:
            y = tail
        return _batch_gather(y, mesh, dim=1) if gather else y

    return run


# --------------------------------------------------------------------------- #
# A pipelined transformer LM built from functional blocks
# --------------------------------------------------------------------------- #
#
# The trunk blocks are functions over a params dict (not modules), so a
# stage applies its slice of the stacked leaves directly; embed and head
# stay outside the pipelined trunk. Dense weights are [in, out], as the
# JAX package stores them.


def init_block_params(gen: torch.Generator, d_model: int, n_head: int,
                      d_ff: int, dtype=torch.float32, device=None) -> dict:
    dev = gen.device if device is None else device
    s = 0.02

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=dev) * s

    return {
        "ln1_scale": torch.ones(d_model, dtype=dtype, device=dev),
        "ln2_scale": torch.ones(d_model, dtype=dtype, device=dev),
        "qkv": normal(d_model, 3 * d_model),
        "proj": normal(d_model, d_model),
        "fc": normal(d_model, d_ff),
        "fc_out": normal(d_ff, d_model),
    }


def _rms(x, scale, eps=1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def block_apply(p: dict, x: torch.Tensor, n_head: int) -> torch.Tensor:
    """Pre-norm causal attention + MLP block on [b, s, d]: plain softmax
    attention, as the JAX package computes it (no kernel here)."""
    b, s, d = x.shape
    hd = d // n_head
    h = _rms(x, p["ln1_scale"])
    q, k, v = (h @ p["qkv"]).split(d, dim=-1)

    def heads(t):
        return t.reshape(b, s, n_head, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / (hd ** 0.5)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    attn = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v)
    attn = attn.transpose(1, 2).reshape(b, s, d)
    x = x + attn @ p["proj"]
    h2 = _rms(x, p["ln2_scale"])
    # jax.nn.gelu's default is the tanh approximation.
    return x + F.gelu(h2 @ p["fc"], approximate="tanh") @ p["fc_out"]


def init_pp_lm(seed: int, vocab: int, d_model: int, n_layer: int,
               n_head: int, d_ff: int, n_positions: int, n_stages: int,
               device=None) -> dict:
    """Params for the pipelined LM on `device` (the card unless "cpu" is
    asked for), drawn from `seed`: stacked trunk + embed/pos/head."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = [init_block_params(gen, d_model, n_head, d_ff, device=dev)
              for _ in range(n_layer)]
    layers = {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}

    def normal(shape, s):
        return torch.randn(shape, generator=gen, device=dev) * s

    return {
        "stages": stack_stage_params(layers, n_stages),
        "embed": normal((vocab, d_model), 0.02),
        "pos": normal((n_positions, d_model), 0.01),
        "head": normal((d_model, vocab), 0.02),
    }


def _leaves(params: dict) -> Dict[str, torch.Tensor]:
    """{"stages/<name>": ..., "embed": ...}: the params' tensors (a
    DTensor's local shard), flat."""
    out = {f"stages/{k}": _local(v) for k, v in params["stages"].items()}
    out.update({k: _local(v) for k, v in params.items() if k != "stages"})
    return out


def _tree(leaves: Dict[str, torch.Tensor]) -> dict:
    out = {"stages": {}}
    for k, v in leaves.items():
        if k.startswith("stages/"):
            out["stages"][k[len("stages/"):]] = v
        else:
            out[k] = v
    return out


def make_pp_train_step(mesh, n_head: int, n_microbatches: int,
                       optimizer: Callable[[List[torch.Tensor]], Any],
                       remat_stage: bool = False, axis: str = "pp"):
    """(step, forward) for the pipelined LM on this rank.

    `forward(params, input_ids)` gives the whole batch's logits on every
    rank. `step(params, opt_state, batch) -> (params, opt_state, loss)`:
    `optimizer` builds a torch optimizer from a list of tensors (e.g.
    `functools.partial(torch.optim.Adam, lr=1e-2)`); pass `opt_state=None`
    first, and the step builds it over the params' tensors (a DTensor's
    local shard), which it then updates in place. Gradients are summed over
    the batch axes. Loss is next-token cross-entropy."""
    from ray_tpu_torch.models.gpt2 import next_token_loss

    pipe = gpipe(functools.partial(block_apply, n_head=n_head), mesh,
                 n_microbatches, axis=axis, remat_stage=remat_stage)
    batch_groups = [mesh.get_group(a) for a in _batch_axes(mesh)]

    def forward(params, input_ids):
        p = _tree(_leaves(params))
        s = input_ids.shape[1]
        x = p["embed"][input_ids] + p["pos"][None, :s]
        x_mb = to_microbatches(x, n_microbatches)
        # The head on this rank's share of the batch, then the gather: every
        # gradient is then partial over the batch axes.
        y_mb = pipe(p["stages"], x_mb, gather=False)
        return from_microbatches(_batch_gather(y_mb @ p["head"], mesh,
                                               dim=1))

    def step(params, opt_state, batch):
        if opt_state is None:
            leaves = {k: v.detach().requires_grad_()
                      for k, v in _leaves(params).items()}
            opt_state = (leaves, optimizer(list(leaves.values())))
        leaves, opt = opt_state
        opt.zero_grad(set_to_none=True)
        loss = next_token_loss(forward(_tree(leaves), batch["input_ids"]),
                               batch["labels"])
        loss.backward()
        for g in batch_groups:
            for v in leaves.values():
                dist.all_reduce(v.grad, group=g)
        opt.step()
        return params, opt_state, loss.detach()

    return step, forward


def sequential_forward(params: dict, input_ids, n_head: int):
    """Reference: apply the same stacked layers without the pipeline
    (whole `[P, L/P, ...]` stage tensors)."""
    s = input_ids.shape[1]
    x = params["embed"][input_ids] + params["pos"][None, :s]
    layers = unstack_stage_params(params["stages"])
    for i in range(next(iter(layers.values())).shape[0]):
        x = block_apply({k: v[i] for k, v in layers.items()}, x, n_head)
    return x @ params["head"]


def stage_shardings(mesh, params: dict, axis: str = "pp") -> dict:
    """(mesh, placements) for every leaf: stages `Shard(0)` over `axis`,
    everything else replicated (place with `distribute_tensor`)."""
    from torch.distributed.tensor import Replicate, Shard

    staged = tuple(Shard(0) if name == axis else Replicate()
                   for name in mesh.mesh_dim_names)
    rep = (Replicate(),) * mesh.ndim
    out = {k: (mesh, rep) for k in params if k != "stages"}
    out["stages"] = {k: (mesh, staged) for k in params["stages"]}
    return out
