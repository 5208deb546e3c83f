"""Sparse mixture-of-experts decoder in PyTorch, computing what
`ray_tpu/models/moe.py` computes.

A Llama-shaped decoder (the port's own RMSNorm, dense layer, RoPE and
GQA attention from `ray_tpu_torch/models/llama.py`) whose MLP is a top-k routed mixture of
SwiGLU experts with a fixed expert capacity:

- The router is float32 whatever `param_dtype` is; its softmax picks each
  token's top-k experts, whose gates are renormalised to sum to one.
- Slots are filled one routing choice at a time: every token's second
  choice queues behind every token's first. A choice past an expert's
  capacity is dropped, and its token's MLP term is zero there (it falls
  through the residual).
- Dispatch and combine are dense one-hot [T, E, C] float32 tensors, and
  their products (and the bf16 expert products) are ordinary PyTorch
  matrix products: the reference hands them to XLA, not to a Pallas kernel.
- The Switch load-balance loss and the router z-loss come back from
  `forward(..., return_aux=True)`, summed over layers; dispatch and combine
  from `forward(..., return_routing=True)` (the reference sows them into its
  "losses" and "intermediates" collections). Neither is module state.

With `mesh` (a training DeviceMesh), `MoE` runs expert parallelism, the
function the reference's GSPMD program computes over the GLOBAL batch:

- Each ep rank holds E / ep of the experts (its own slice of the stacked
  [E, d, f] weights, not a DTensor over ep), each expert's hidden columns
  split over tp; attention, norms, embedding and head are Llama's on a
  mesh (tp heads, vocab-parallel embedding and head, the ring over sp with
  global positions), the router replicated; FSDP2 shards every parameter's
  "embed" dim over fsdp.
- Capacity comes from the global token count, and the queue is global:
  one small all-gather of per-row, per-choice expert counts over the axes
  that hold other tokens (the data axes and sp) gives each rank the slots
  taken before each of its rows, in the flattened (b, s) order of the
  global batch.
- Tokens are replicated over ep and tp, so each rank runs only its experts
  on its own kept tokens at their global slots: no token all-to-all. The
  combine is a float32 partial sum over this rank's experts (and hidden
  columns), all-reduced over ep and tp; the gates and the experts' input
  enter through `expert_copy_in`, so their gradients close over ep and tp
  too, and every parameter replicated over ep gets its whole gradient on
  every ep rank.
- The router losses are shares of the global means: summed over the data
  axes and sp (as `make_train_step(mesh=)` sums gradients) they are the
  global batch's.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._torch_env import resolve_device, same_device
from ray_tpu_torch.models.gpt2 import make_train_step, next_token_loss
from ray_tpu_torch.models.llama import (Dense, RMSNorm, _positions,
                                        _set_param, causal_attention,
                                        qkv_heads, validate_tp)
from ray_tpu_torch.parallel.mesh import (DATA_AXES, axis_rank, axis_size,
                                         data_parallel_rank,
                                         data_parallel_size)
from ray_tpu_torch.parallel import tensor_parallel as tpar
from ray_tpu_torch.parallel.sharding import named_sharding
from ray_tpu_torch.parallel.tensor_parallel import (
    MeshContext, local, next_token_loss_parts, place_module, shard_local,
    tp_placements, vocab_parallel_embedding)


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    n_positions: int = 2048
    n_embd: int = 1024
    n_layer: int = 8
    n_head: int = 16
    n_kv_head: int = 8
    intermediate: int = 2816         # per-expert SwiGLU width
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25    # slots per expert = ceil(T*k*cf/E)
    aux_coef: float = 0.01           # Switch load-balance loss weight
    router_z_coef: float = 1e-3      # router logit magnitude control
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    use_flash: bool = True
    remat: bool = False              # recompute each block in the backward

    @staticmethod
    def small() -> "MoEConfig":
        return MoEConfig()

    @staticmethod
    def tiny(seq: int = 128) -> "MoEConfig":
        return MoEConfig(vocab_size=512, n_positions=seq, n_embd=128,
                         n_layer=2, n_head=4, n_kv_head=2, intermediate=256,
                         n_experts=4, top_k=2, use_flash=False)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def expert_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    cap = math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                    / cfg.n_experts)
    return max(cap, cfg.top_k)


def _dispatch(gate_idx, gate_vals, n_experts: int, cap: int, first: int = 0,
              offsets=None):
    """(dispatch [T, n, C] float32 0/1, kept gate [T, n]) of experts
    first .. first + n - 1 for the routing choices gate_idx, gate_vals
    [T, k], choice 0 queued first.

    A token picks an expert at most once, so each (token, expert) row of the
    reference's sum over choices of keep * one_hot(slot) holds one term:
    the slot is gathered over the choices as an index (-1 where the token
    was not routed there, or was dropped) and one-hot encoded once, which
    gives the reference's tensor exactly. `(pos == arange(C))` stands for
    `jax.nn.one_hot`, which gives a zero row out of range where
    `F.one_hot` raises.

    Without `offsets` the T tokens are the whole queue. With `offsets`
    [k, n, rows] (float), they are `rows` equal rows of a larger batch, and
    offsets[j, e, r] is the number of slots of expert e that choice j's
    queue fills before row r's tokens (every earlier choice, every earlier
    token of the global batch)."""
    t, k = gate_idx.shape
    dev = gate_idx.device
    experts = torch.arange(first, first + n_experts, device=dev)[:, None]
    # Expert-major [n, T], so the queue's cumulative sum runs along the
    # contiguous dimension: a scan down T rows of E columns is slow on the
    # card (PERF.md, MoE-small).
    fill = torch.zeros(n_experts, 1, device=dev)             # slots used
    slot = torch.full((n_experts, t), -1, dtype=torch.long, device=dev)
    gates = torch.zeros(n_experts, t, device=dev)
    for j in range(k):
        onehot = (gate_idx[:, j] == experts).float()             # [n, T]
        # Queue position; float32 cumulative sums of 0/1 are exact for
        # T < 2**24.
        if offsets is None:
            pos = onehot.cumsum(1) - 1.0 + fill
        else:
            rows = offsets.shape[-1]
            pos = (onehot.view(n_experts, rows, t // rows).cumsum(2) - 1.0
                   + offsets[j, :, :, None]).view(n_experts, t)
        keep = (pos < cap) & (onehot > 0)                         # dropped past C
        slot = torch.where(keep, pos.long(), slot)
        gates = gates + keep.float() * gate_vals[:, j]
        fill = fill + onehot.sum(1, keepdim=True)
    arange = torch.arange(cap, device=dev)
    dispatch = (slot.t().contiguous()[..., None] == arange).float()
    return dispatch, gates.t()


def _token_counts(counts, ctx: MeshContext):
    """Every token shard's `counts` (this rank's [k, rows, E]) gathered
    over the axes that hold other tokens: [data shards, sp, k, rows, E],
    the data shards in `data_parallel_rank`'s order and the sp shards in
    sequence order. ep and tp peers hold the same tokens and are not
    asked; an axis of size 1 costs no exchange."""
    out = counts[None]
    for name in ("sp", *reversed(DATA_AXES)):
        size = axis_size(ctx.mesh, name)
        if size > 1:
            every = out.new_empty((size * out.shape[0], *out.shape[1:]))
            dist.all_gather_into_tensor(every, out.contiguous(),
                                        group=ctx.mesh.get_group(name))
            out = every
    return out.view(-1, ctx.sp_size, *counts.shape)


def _queue_offsets(every, ctx: MeshContext):
    """(offsets [k, E, rows], top-1 counts [E]) from every shard's counts
    [data shards, sp, k, rows, E] (`_token_counts`): offsets[j, e, r] is
    the number of slots of expert e taken before this rank's row r in
    choice j's queue, which is every token's earlier choices, then choice
    j of every token ahead in the global (b, s) order: the rows of earlier
    data shards and earlier rows, then row r's tokens on earlier sp
    shards."""
    n_data, _, k, rows, e = every.shape
    total = every.sum(dim=(0, 1, 3))                         # [k, E]
    fill = total.cumsum(0) - total
    per_row = every.sum(1).transpose(0, 1).reshape(k, n_data * rows, e)
    ahead = per_row.cumsum(1) - per_row
    d = data_parallel_rank(ctx.mesh)
    offsets = (fill[:, None] + ahead[:, d * rows:(d + 1) * rows]
               + every[d, :ctx.sp_rank].sum(0))
    return offsets.transpose(1, 2), total[0]


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU experts with fixed capacity, [b, s, d] in and
    out. Returns (y, router loss, dispatch, combine); on a mesh the router
    loss is this rank's share and dispatch and combine [T, E / ep, C] hold
    this rank's tokens and experts."""

    def __init__(self, cfg: MoEConfig):
        super().__init__()
        self.cfg = cfg
        self.mesh_ctx: Optional[MeshContext] = None   # set on a mesh
        e, d, f = cfg.n_experts, cfg.n_embd, cfg.intermediate
        self.router = nn.Parameter(torch.empty(d, e))    # float32 always
        self.w_gate = nn.Parameter(torch.empty(e, d, f))
        self.w_up = nn.Parameter(torch.empty(e, d, f))
        self.w_down = nn.Parameter(torch.empty(e, f, d))

    def forward(self, x):
        cfg, ctx = self.cfg, self.mesh_ctx
        b, s, d = x.shape
        t = b * s
        e, dt = cfg.n_experts, cfg.dtype

        xt = x.reshape(t, d)
        logits = xt.float() @ local(self.router).float()         # [T, E]
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
        # Mixtral renormalises the selected gates to sum to one.
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(
            1e-9)
        lse2 = torch.logsumexp(logits, dim=-1).square()

        # Switch aux loss: E * sum_e(token_frac_e * mean_prob_e) over the
        # top-1 assignment (which carries no gradient); z-loss controls
        # router logit growth.
        if ctx is None:
            cap = expert_capacity(cfg, t)
            dispatch, gates = _dispatch(gate_idx, gate_vals, e, cap)
            token_frac = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
            aux = cfg.aux_coef * e * (token_frac * probs.mean(dim=0)).sum()
            z = cfg.router_z_coef * lse2.mean()
            xin = xt.float()
        else:
            # The global batch's capacity and queue; this rank's share of
            # the global means (token_frac is global and carries no
            # gradient, so aux is linear in the local probabilities).
            t_all = t * data_parallel_size(ctx.mesh) * ctx.sp_size
            cap = expert_capacity(cfg, t_all)
            counts = F.one_hot(gate_idx.view(b, s, -1), e).sum(1)
            offsets, top1 = _queue_offsets(
                _token_counts(counts.transpose(0, 1), ctx), ctx)
            n = e // ctx.ep_size
            first = ctx.ep_rank * n
            dispatch, gates = _dispatch(
                gate_idx, ctx.expert_copy_in(gate_vals), n, cap, first,
                offsets[:, first:first + n].float())
            token_frac = top1.float() / t_all
            aux = cfg.aux_coef * e * (token_frac * probs.sum(dim=0)
                                      / t_all).sum()
            z = cfg.router_z_coef * lse2.sum() / t_all
            xin = ctx.expert_copy_in(xt.float())
        combine = dispatch * gates[..., None]

        # Dispatch and combine in float32, the expert products in `dtype`,
        # over this rank's experts.
        n = dispatch.shape[1]
        xd = (dispatch.view(t, n * cap).t() @ xin).to(dt).view(n, cap, d)
        gate = torch.bmm(xd, local(self.w_gate).to(dt))
        up = torch.bmm(xd, local(self.w_up).to(dt))
        out_e = torch.bmm(F.silu(gate) * up, local(self.w_down).to(dt))
        y = combine.view(t, n * cap) @ out_e.float().view(n * cap, d)
        if ctx is not None:
            y = ctx.expert_reduce_out(y)
        return y.to(dt).view(b, s, d), aux + z, dispatch, combine


class MoEBlock(nn.Module):
    def __init__(self, cfg: MoEConfig):
        super().__init__()
        self.cfg = cfg
        self.mesh_ctx: Optional[MeshContext] = None   # set on a mesh
        hd, e = cfg.head_dim, cfg.n_embd
        self.attn_norm = RMSNorm(e, cfg.rms_eps, cfg.dtype)
        self.wq = Dense(e, cfg.n_head * hd, cfg.dtype)
        self.wk = Dense(e, cfg.n_kv_head * hd, cfg.dtype)
        self.wv = Dense(e, cfg.n_kv_head * hd, cfg.dtype)
        self.wo = Dense(cfg.n_head * hd, e, cfg.dtype)
        self.mlp_norm = RMSNorm(e, cfg.rms_eps, cfg.dtype)
        self.moe = MoEMLP(cfg)

    def forward(self, x, positions):
        """(x, router loss, dispatch, combine). On a mesh, attention is
        Llama's: this rank's tp heads, the ring over sp."""
        cfg, ctx = self.cfg, self.mesh_ctx
        b, s, _ = x.shape
        h = self.attn_norm(x)
        if ctx is not None:
            h = ctx.copy_in(h)
        q, k, v = qkv_heads(self, h, positions)
        sp_group = ctx.sp_group if ctx is not None and ctx.sp_size > 1 \
            else None
        attn = causal_attention(q, k, v, cfg.use_flash, sp_group=sp_group)
        out = self.wo(attn.transpose(1, 2).reshape(b, s, -1))
        if ctx is not None:
            out = ctx.reduce_out(out)
        x = x + out
        y, aux, dispatch, combine = self.moe(self.mlp_norm(x))
        return x + y, aux, dispatch, combine


class MoE(nn.Module):
    """The MoE decoder with an untied head. `device` defaults to the card.

    Parameters are drawn on the model's device from a `torch.Generator`
    seeded with `seed`, unless `state` is given: a state dict on that device
    whose tensors become the parameters by reference (`params_from_jax`'s,
    on the CPU).

    With `mesh`, the model lives on the mesh's device type and runs expert
    parallelism (module docstring): each parameter, drawn whole from the
    seed or taken whole from `state` (every rank passes the same), keeps
    this rank's ep slice of the experts and its tp shard, a DTensor on the
    tp sub-mesh where the mesh has tp, and FSDP2 shards the blocks and the
    model over fsdp. `forward` takes this rank's shard of the ids
    (`shard_batch`) and returns its vocab shard of the logits."""

    def __init__(self, config: MoEConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0,
                 state: Optional[Dict[str, torch.Tensor]] = None,
                 mesh=None):
        super().__init__()
        if mesh is not None:
            device = mesh.device_type
        dev = resolve_device(device)
        self.config = config
        self.mesh_ctx: Optional[MeshContext] = None
        with torch.device("meta"):
            self.embed = nn.Parameter(torch.empty(config.vocab_size,
                                                  config.n_embd))
            self.layers = nn.ModuleList(MoEBlock(config)
                                        for _ in range(config.n_layer))
            self.final_norm = RMSNorm(config.n_embd, config.rms_eps,
                                      config.dtype)
            self.lm_head = Dense(config.n_embd, config.vocab_size,
                                 config.dtype)
        cut = _mesh_cutter(self, mesh)
        if state is None:
            self._init_weights(seed, dev, cut)
        else:
            for name, t in state.items():
                if not same_device(dev, t.device):
                    raise ValueError(f"state tensor {name} lies on "
                                     f"{t.device}, the model on {dev}")
            if cut is None:
                self.load_state_dict(state, assign=True)
            else:
                names = [n for n, _ in self.named_parameters()]
                if set(names) != set(state):
                    raise ValueError(
                        "state names differ from the model's: "
                        f"{sorted(set(names) ^ set(state))}")
                for name in names:
                    _set_param(self, name, cut(name, state[name]))
        if mesh is not None:
            self.mesh_ctx = _place_on_mesh(self, mesh)

    @torch.no_grad()
    def _init_weights(self, seed: int, dev: torch.device, cut=None):
        """Draw every parameter whole, in order; `cut(name, whole)` (on a
        mesh) keeps only this rank's piece of each as it is drawn."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, p in list(self.named_parameters()):
            dt = (torch.float32 if name.endswith("router")
                  else self.config.param_dtype)
            init = torch.empty(p.shape, dtype=dt, device=dev)
            if name.endswith("norm.weight"):
                init.fill_(1.0)
            else:
                init.normal_(0.0, 0.02, generator=gen)
            _set_param(self, name, init if cut is None else cut(name, init))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, input_ids, return_aux: bool = False,
                return_routing: bool = False):
        """Logits [b, s, vocab]; with `return_aux`, also the router losses
        summed over layers (float32 scalar); with `return_routing`, also
        each layer's (dispatch, combine). Returns logits alone, or the tuple
        (logits, aux?, routing?) of what was asked for. On a mesh: this
        rank's vocab shard of the logits, its share of the router losses,
        and its tokens' routing to its experts."""
        cfg, ctx = self.config, self.mesh_ctx
        b, s = input_ids.shape
        x = vocab_parallel_embedding(
            input_ids, local(self.embed).to(cfg.dtype), ctx)
        positions = _positions(s, input_ids.device, ctx)
        aux = torch.zeros((), device=input_ids.device)
        routing = []
        for blk in self.layers:
            if cfg.remat:
                x, a, dispatch, combine = checkpoint(blk, x, positions,
                                                     use_reentrant=False)
            else:
                x, a, dispatch, combine = blk(x, positions)
            aux = aux + a
            if return_routing:
                routing.append((dispatch, combine))
        x = self.final_norm(x)
        logits = self.lm_head(ctx.copy_in(x) if ctx is not None else x)
        out = ((logits,) + ((aux,) if return_aux else ())
               + ((routing,) if return_routing else ()))
        return out if len(out) > 1 else logits


def make_moe_train_step(model: MoE, optimizer: torch.optim.Optimizer,
                        mesh=None):
    """`gpt2.make_train_step` with an objective that adds the router losses
    (load balance + z) to the next-token cross-entropy; the shown loss is
    the cross-entropy alone, so curves stay comparable.

    With `mesh` (the one `model` was placed on), `batch` is this rank's
    `shard_batch` and the step returns the global cross-entropy, the same
    on every rank: the objective is this rank's share of the global
    cross-entropy (`next_token_loss_parts`) plus its share of the global
    router losses."""

    def loss_fn(model, batch):
        logits, aux = model(batch["input_ids"], return_aux=True)
        if mesh is None:
            ce = next_token_loss(logits, batch["labels"])
            return ce + aux, ce
        objective, shown = next_token_loss_parts(logits, batch["labels"],
                                                 model.mesh_ctx)
        return objective + aux, shown

    return make_train_step(model, optimizer, mesh=mesh, loss_fn=loss_fn)


# --------------------------------------------------------------------------- #
# Placement on a mesh
# --------------------------------------------------------------------------- #


# Logical axes of each parameter: the reference's `with_logical_partitioning`
# annotations (`ray_tpu/models/moe.py:106-115`, and Llama's for attention,
# norms, embedding and head) on the port's names, a dense weight's the flax
# kernel's reversed (the weight is [out, in]).
_LOGICAL = (
    (r"^embed$", ("vocab", "embed")),
    (r"(wq|wk|wv)\.weight$", ("heads", "embed")),
    (r"wo\.weight$", ("embed", "heads")),
    (r"moe\.router$", ("embed", None)),
    (r"moe\.(w_gate|w_up)$", ("expert", "embed", "mlp")),
    (r"moe\.w_down$", ("expert", "mlp", "embed")),
    (r"lm_head\.weight$", ("vocab", "embed")),
    (r"norm\.weight$", ("embed",)),
)


def logical_param_specs(model: nn.Module) -> Dict[str, Tuple]:
    """Parameter name -> the logical axes of its dims (the reference's
    annotations)."""
    return {n: next(ax for pattern, ax in _LOGICAL if re.search(pattern, n))
            for n, _ in model.named_parameters()}


def mesh_shardings_for(model: nn.Module, mesh,
                       rules: Optional[Dict] = None) -> Dict[str, tuple]:
    """Parameter name -> its placements on `mesh`: the logical axes through
    the rules (`rules` overriding the defaults; "expert" over ep, "mlp",
    "heads" and "vocab" over tp, "embed" over fsdp), as the reference's
    `mesh_shardings_for` places the MoE's tree. `MoE(mesh=)` holds each
    rank's piece of this layout, its ep slice as a plain dim-0 slice."""
    return {name: named_sharding(mesh, *axes, rules=rules)[1]
            for name, axes in logical_param_specs(model).items()}


def validate_mesh(cfg: MoEConfig, mesh) -> None:
    """Fail fast on widths the mesh cannot split evenly: heads, KV heads,
    the experts' hidden width and the vocab over tp (`validate_tp`), the
    experts over ep."""
    validate_tp(cfg, axis_size(mesh, "tp"))
    ep = axis_size(mesh, "ep")
    if cfg.n_experts % ep:
        raise ValueError(f"ep={ep} does not divide n_experts="
                         f"{cfg.n_experts}: each ep rank holds n_experts / "
                         "ep experts")


def _mesh_dims(model: nn.Module, mesh) -> Dict[str, Dict[str, Optional[int]]]:
    """Parameter name -> {mesh axis: the dim it splits, or None} for tp,
    ep and fsdp, from `mesh_shardings_for`."""
    from torch.distributed.tensor import Shard

    names = mesh.mesh_dim_names
    out = {}
    for name, placements in mesh_shardings_for(model, mesh).items():
        out[name] = {
            axis: (placements[names.index(axis)].dim
                   if axis in names
                   and isinstance(placements[names.index(axis)], Shard)
                   else None)
            for axis in ("tp", "ep", "fsdp")}
    return out


def _mesh_cutter(model: nn.Module, mesh):
    """(name, whole parameter) -> this rank's piece of it: its ep slice of
    the experts, then its tp shard as a DTensor on the tp sub-mesh where
    the mesh has tp (a copy either way). None off a mesh."""
    if mesh is None:
        return None
    validate_mesh(model.config, mesh)
    dims = _mesh_dims(model, mesh)
    ep, ep_rank = axis_size(mesh, "ep"), axis_rank(mesh, "ep")
    tp_mesh = mesh["tp"] if "tp" in mesh.mesh_dim_names else None

    def cut(name, whole):
        t = whole
        if dims[name]["ep"] is not None:
            t = t.chunk(ep, dim=dims[name]["ep"])[ep_rank]
        if tp_mesh is not None:
            return shard_local(t, tp_mesh, tp_placements(dims[name]["tp"]))
        return t.clone(memory_format=torch.contiguous_format)

    return cut


def _place_on_mesh(model: "MoE", mesh) -> MeshContext:
    """FSDP2 over fsdp (`place_module`, each parameter on its "embed"
    dim); every block and its experts get the mesh's context."""
    dims = _mesh_dims(model, mesh)
    ctx = MeshContext.of(mesh)
    place_module(model, ctx, {n: d["tp"] for n, d in dims.items()},
                 {n: d["fsdp"] or 0 for n, d in dims.items()},
                 list(model.layers))
    for blk in model.layers:
        blk.mesh_ctx = blk.moe.mesh_ctx = ctx
    return ctx


def expert_param_names(model: nn.Module):
    """The stacked expert weights' names (split over ep on a mesh)."""
    return [n for n, axes in logical_param_specs(model).items()
            if axes[0] == "expert"]


def full_state(model: "MoE") -> Dict[str, torch.Tensor]:
    """The model's parameters whole on every rank: `tensor_parallel.
    full_state` (DTensors gathered over tp and fsdp), the expert weights
    then gathered over ep. Collective: every rank calls it."""
    out = tpar.full_state(model)
    ctx = model.mesh_ctx
    if ctx is None or ctx.ep_group is None:
        return out
    for name in expert_param_names(model):
        t = out[name].contiguous()
        every = t.new_empty((ctx.ep_size * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(every, t, group=ctx.ep_group)
        out[name] = every
    return out


def count_active_params(cfg: MoEConfig) -> int:
    """Parameters touched per token (dense weights + top_k experts)."""
    attn = cfg.n_embd * (cfg.n_head + 2 * cfg.n_kv_head) * cfg.head_dim \
        + cfg.n_head * cfg.head_dim * cfg.n_embd
    expert = 3 * cfg.n_embd * cfg.intermediate
    per_layer = attn + cfg.top_k * expert + cfg.n_embd * cfg.n_experts
    return cfg.n_layer * per_layer + 2 * cfg.vocab_size * cfg.n_embd


def flops_per_token(cfg: MoEConfig, seq_len: int) -> float:
    """Training FLOPs/token: 6x active params + attention term."""
    attn = 12 * cfg.n_layer * cfg.n_embd * seq_len
    return 6.0 * count_active_params(cfg) + 2.0 * attn


def params_from_jax(params_np: Dict) -> Dict[str, torch.Tensor]:
    """The port's state dict from the JAX model's parameter tree (unboxed
    to nested dicts of numpy arrays, with or without the top-level "params"
    key). Dense kernels [in, out] become [out, in]; norm `scale` becomes
    `weight`; the router [d, E] and the stacked expert weights keep their
    layout."""
    tree = params_np.get("params", params_np)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {"embed": t(tree["embed"]),
           "final_norm.weight": t(tree["final_norm"]["scale"]),
           "lm_head.weight": t(tree["lm_head"]["kernel"]).t().contiguous()}
    n_layer = sum(1 for key in tree if key.startswith("layer_"))
    for i in range(n_layer):
        blk = tree[f"layer_{i}"]
        for norm in ("attn_norm", "mlp_norm"):
            out[f"layers.{i}.{norm}.weight"] = t(blk[norm]["scale"])
        for dense in ("wq", "wk", "wv", "wo"):
            out[f"layers.{i}.{dense}.weight"] = \
                t(blk[dense]["kernel"]).t().contiguous()
        for name in ("router", "w_gate", "w_up", "w_down"):
            out[f"layers.{i}.moe.{name}"] = t(blk["moe"][name])
    return out
