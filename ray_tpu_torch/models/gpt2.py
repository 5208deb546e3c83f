"""GPT-2 in PyTorch, computing what `ray_tpu/models/gpt2.py` computes.

bfloat16 compute on float32 parameters. flax's defaults are pinned:
LayerNorm eps 1e-6 with its statistics in float32, the tanh GELU, normal(0.02)
init for dense kernels and `wte`, normal(0.01) for `wpe`, zero biases. The
output head is tied to `wte`. Attention goes through the flash kernels
(`ray_tpu_torch.ops.attention.flash_attention`), or with `use_ring` through
ring attention over an sp process group, on the caller's sequence shard
(the reference's `use_ring` inside a caller's `shard_map`). With `remat`,
each block runs under `torch.utils.checkpoint` (the counterpart of
`nn.remat(Block)`): its activations are dropped after the forward and
recomputed in the backward, flash forward included.

With `mesh` (a training DeviceMesh with any of dp, fsdp, sp and tp), the
model is placed on it (`parallel/tensor_parallel.py`): parameters are
DTensors, tp splits the heads, the MLP and the vocab Megatron-style, FSDP2
shards over fsdp, and sp runs the ring over the mesh's sp group with
global positions. Each rank then takes its shard of the batch and the
sequence (`parallel.sharding.shard_batch`) and returns vocab-sharded
logits; `make_train_step(mesh=)` steps it and returns the global loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._torch_env import resolve_device
from ray_tpu_torch.ops.attention import flash_attention, mha_reference
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel.mesh import (data_parallel_size,
                                         validate_divisibility)
from ray_tpu_torch.parallel.sharding import named_sharding, shard_params
from ray_tpu_torch.parallel.tensor_parallel import (MeshContext, local,
                                                    next_token_loss_parts,
                                                    place_module,
                                                    sync_gradients,
                                                    vocab_parallel_embedding)


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304          # padded to a multiple of 128
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    use_flash: bool = True
    use_ring: bool = False           # sequence parallelism (the sp group)
    remat: bool = False              # recompute each block in the backward

    @staticmethod
    def small() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def medium() -> "GPT2Config":
        return GPT2Config(n_embd=1024, n_layer=24, n_head=16)

    @staticmethod
    def tiny(seq: int = 128) -> "GPT2Config":
        return GPT2Config(vocab_size=512, n_positions=seq, n_embd=128,
                          n_layer=2, n_head=4)


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm: eps 1e-6, statistics and affine in float32, result in
    the input's dtype."""

    def __init__(self, n: int):
        super().__init__(n, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            local(self.weight), local(self.bias),
                            self.eps).to(x.dtype)


class Dense(nn.Linear):
    """flax Dense: weight and bias cast to the input's (compute) dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Block(nn.Module):
    def __init__(self, config: GPT2Config, sp_group=None):
        super().__init__()
        self.config = config
        self.sp_group = sp_group
        self.mesh_ctx: Optional[MeshContext] = None   # set by GPT2(mesh=)
        e = config.n_embd
        self.ln_1 = LayerNorm(e)
        self.c_attn = Dense(e, 3 * e)
        self.c_proj = Dense(e, e)
        self.ln_2 = LayerNorm(e)
        self.c_fc = Dense(e, 4 * e)
        self.mlp_proj = Dense(4 * e, e)

    def _dropout(self, x, deterministic: bool):
        p = self.config.dropout
        return F.dropout(x, p, training=True) if p and not deterministic else x

    def forward(self, x, deterministic: bool = True):
        if self.mesh_ctx is not None:
            return self._forward_mesh(x, deterministic)
        cfg = self.config
        b, s, e = x.shape
        qkv = self.c_attn(self.ln_1(x))
        # [b, s, 3, heads, d] -> three [b, heads, s, d]; the columns stay in
        # [q | k | v] order, head-major, as in the flax model.
        q, k, v = qkv.view(b, s, 3, cfg.n_head, e // cfg.n_head).permute(
            2, 0, 3, 1, 4).unbind(0)
        if cfg.use_ring:
            attn = ring_attention(q, k, v, group=self.sp_group, causal=True)
        elif cfg.use_flash:
            attn = flash_attention(q, k, v, True)
        else:
            attn = mha_reference(q, k, v, causal=True)
        attn = attn.transpose(1, 2).reshape(b, s, e)
        x = x + self._dropout(self.c_proj(attn), deterministic)
        h = self.mlp_proj(F.gelu(self.c_fc(self.ln_2(x)), approximate="tanh"))
        return x + self._dropout(h, deterministic)

    def _forward_mesh(self, x, deterministic: bool):
        """The block on this rank's shard (`x` its rows of the batch and
        sequence, replicated over tp): its n_head / tp heads and 4e / tp of
        the MLP, one all-reduce over tp after each row product.

        c_attn's tp shard is a contiguous block of its 3e rows, as the
        reference's ("embed", "mlp") rule gives it, but this rank's heads
        are the rows [q_r | k_r | v_r]. The weight and bias are gathered
        over tp (`gather_rows`; the backward reduce-scatters their
        gradients) and this rank's rows taken from the whole."""
        cfg, ctx = self.config, self.mesh_ctx
        b, s, e = x.shape
        tp, r = ctx.tp_size, ctx.tp_rank
        heads, hd = cfg.n_head // tp, e // cfg.n_head
        dt = x.dtype
        h = ctx.copy_in(self.ln_1(x))
        w = ctx.gather_rows(local(self.c_attn.weight).to(dt))
        bias = ctx.gather_rows(local(self.c_attn.bias).to(dt))
        w = w.view(3, tp, e // tp, e)[:, r].reshape(3 * e // tp, e)
        bias = bias.view(3, tp, e // tp)[:, r].reshape(3 * e // tp)
        q, k, v = F.linear(h, w, bias).view(b, s, 3, heads, hd).permute(
            2, 0, 3, 1, 4).unbind(0)
        if ctx.sp_size > 1:
            attn = ring_attention(q, k, v, group=ctx.sp_group, causal=True)
        elif cfg.use_flash:
            attn = flash_attention(q, k, v, True)
        else:
            attn = mha_reference(q, k, v, causal=True)
        attn = attn.transpose(1, 2).reshape(b, s, heads * hd)
        out = ctx.reduce_out(F.linear(attn, local(self.c_proj.weight).to(dt)))
        x = x + self._dropout(out + local(self.c_proj.bias).to(dt),
                              deterministic)
        h = F.gelu(F.linear(ctx.copy_in(self.ln_2(x)),
                            local(self.c_fc.weight).to(dt),
                            local(self.c_fc.bias).to(dt)), approximate="tanh")
        h = ctx.reduce_out(F.linear(h, local(self.mlp_proj.weight).to(dt)))
        return x + self._dropout(h + local(self.mlp_proj.bias).to(dt),
                                 deterministic)


class GPT2(nn.Module):
    """GPT-2 with a tied head. `device` defaults to the card; parameters are
    drawn on the CPU from `torch.Generator().manual_seed(seed)` and moved
    there, so one seed gives the same weights on either device. `state`
    (a state dict of whole tensors, or of DTensors, which are gathered
    whole) is loaded instead.

    With `config.use_ring`, the model takes this rank's sequence shard of
    the ids and attention runs the ring over `sp_group` (the default
    process group when None). As in the reference, whose `wpe[None, :s]`
    takes the shard's own length inside `shard_map`, positions restart at
    0 on every shard.

    With `mesh`, the model lives on the mesh's device type and is placed on
    it (module docstring): `forward` takes this rank's [b / data-parallel,
    s / sp] shard of the ids, positions global, and returns its logits
    [b / dp, s / sp, vocab / tp]. Every rank passes the same seed or state.
    `config.use_ring` does not combine with a mesh: sp comes from it."""

    def __init__(self, config: GPT2Config,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, sp_group=None, mesh=None,
                 state: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        if mesh is not None:
            if config.use_ring:
                raise ValueError("use_ring takes an sp group of its own; "
                                 "on a mesh, sp comes from the mesh")
            device = mesh.device_type
        dev = resolve_device(device)
        self.config = config
        self.mesh_ctx: Optional[MeshContext] = None
        self.wte = nn.Parameter(torch.empty(config.vocab_size, config.n_embd))
        self.wpe = nn.Parameter(torch.empty(config.n_positions, config.n_embd))
        self.h = nn.ModuleList(Block(config, sp_group)
                               for _ in range(config.n_layer))
        self.ln_f = LayerNorm(config.n_embd)
        self._init_weights(seed)
        if state is not None:
            self.load_state_dict(
                {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                 for k, v in state.items()})
        self.to(device=dev, dtype=config.param_dtype)
        if mesh is not None:
            self._place(mesh)

    def _place(self, mesh) -> None:
        """Parameters to DTensors on `mesh`: each tp-sharded on the dim its
        "mlp" or "vocab" axis names, FSDP2 over fsdp on its "embed" dim
        (dim 0 where it has none)."""
        cfg = self.config
        validate_divisibility(mesh, data_parallel_size(mesh),
                              n_head=cfg.n_head, vocab_size=cfg.vocab_size)
        ctx = MeshContext.of(mesh)
        specs = logical_param_specs(self)
        tp_dims = {n: next((d for d, a in enumerate(ax)
                            if a in ("mlp", "vocab")), None)
                   for n, ax in specs.items()}
        fsdp_dims = {n: ax.index("embed") if "embed" in ax else 0
                     for n, ax in specs.items()}
        place_module(self, ctx, tp_dims, fsdp_dims, blocks=list(self.h))
        self.mesh_ctx = ctx
        for blk in self.h:
            blk.mesh_ctx = ctx

    @torch.no_grad()
    def _init_weights(self, seed: int):
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name == "wpe":
                p.normal_(0.0, 0.01, generator=gen)
            elif name == "wte" or name.endswith(".weight") and p.dim() == 2:
                p.normal_(0.0, 0.02, generator=gen)
            elif name.endswith(".bias"):
                p.zero_()
            else:  # LayerNorm scale
                p.fill_(1.0)

    def forward(self, input_ids, deterministic: bool = True):
        cfg, ctx = self.config, self.mesh_ctx
        s = input_ids.shape[1]
        wte = local(self.wte).to(cfg.dtype)
        start = ctx.sp_rank * s if ctx is not None else 0
        x = vocab_parallel_embedding(input_ids, wte, ctx) \
            + local(self.wpe).to(cfg.dtype)[None, start:start + s]
        for block in self.h:
            if cfg.remat:
                # Dropout draws from the global generators, which the
                # checkpoint restores for the recompute: the same masks.
                x = checkpoint(block, x, deterministic, use_reentrant=False)
            else:
                x = block(x, deterministic)
        x = self.ln_f(x)
        if ctx is not None:
            x = ctx.copy_in(x)
        return torch.matmul(x, wte.t())  # tied head: einsum("bse,ve->bsv")


# --------------------------------------------------------------------------- #
# Shardings, weights from the flax tree, loss, train and eval steps
# --------------------------------------------------------------------------- #

# Logical axes of each dense layer's flax kernel [in, out]: Megatron-style
# column-then-row parallel over tp (`ray_tpu/models/gpt2.py:59-105`).
_DENSE_AXES = {"c_attn": ("embed", "mlp"), "c_fc": ("embed", "mlp"),
               "c_proj": ("mlp", "embed"), "mlp_proj": ("mlp", "embed")}


def logical_param_specs(model: "GPT2") -> Dict[str, Tuple]:
    """Parameter name -> the logical axes of its dims that the reference's
    `nn.with_logical_partitioning` annotations give it: `wte` (vocab,
    embed), `wpe` (None, embed), a dense weight its flax kernel's axes
    reversed (the weight is [out, in]) and its bias the output's axis;
    LayerNorms carry none, () (replicated)."""
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if name == "wte":
            axes = ("vocab", "embed")
        elif name == "wpe":
            axes = (None, "embed")
        elif len(parts) == 4 and parts[2] in _DENSE_AXES:
            kernel = _DENSE_AXES[parts[2]]
            axes = kernel[::-1] if parts[3] == "weight" else kernel[-1:]
        else:
            axes = ()
        out[name] = axes
    return out


def mesh_shardings_for(model: "GPT2", mesh,
                       rules: Optional[Dict] = None) -> Dict[str, tuple]:
    """Parameter name -> its placements on `mesh` (a DeviceMesh): the
    logical axes through the rules (`rules` overriding the defaults), axes
    the mesh lacks replicated."""
    return {name: named_sharding(mesh, *axes, rules=rules)[1]
            for name, axes in logical_param_specs(model).items()}


def init_sharded(config: GPT2Config, mesh, seed: int = 0
                 ) -> Dict[str, torch.Tensor]:
    """The model's parameters from `seed`, placed as DTensors in their mesh
    shardings on the mesh's device type. Every rank draws the same weights
    (on the CPU, from the seed) and keeps its shards."""
    model = GPT2(config, device=mesh.device_type, seed=seed)
    return shard_params(dict(model.named_parameters()), mesh,
                        logical_param_specs(model))


def params_from_jax(params_np: Dict) -> Dict[str, torch.Tensor]:
    """The port's state dict from the JAX model's parameter tree.

    `params_np` is the flax tree unboxed to nested dicts of numpy arrays
    (with or without the top-level "params" key). Dense kernels [in, out]
    become [out, in]; LayerNorm `scale` becomes `weight`."""
    tree = params_np.get("params", params_np)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {"wte": t(tree["wte"]), "wpe": t(tree["wpe"]),
           "ln_f.weight": t(tree["ln_f"]["scale"]),
           "ln_f.bias": t(tree["ln_f"]["bias"])}
    n_layer = sum(1 for key in tree if key.startswith("h_"))
    for i in range(n_layer):
        blk = tree[f"h_{i}"]
        for ln in ("ln_1", "ln_2"):
            out[f"h.{i}.{ln}.weight"] = t(blk[ln]["scale"])
            out[f"h.{i}.{ln}.bias"] = t(blk[ln]["bias"])
        for dense in ("c_attn", "c_proj", "c_fc", "mlp_proj"):
            kernel = t(blk[dense]["kernel"])  # [in, out]
            out[f"h.{i}.{dense}.weight"] = kernel.t().contiguous()
            out[f"h.{i}.{dense}.bias"] = t(blk[dense]["bias"])
    return out


def next_token_loss(logits, targets, ignore_index: int = -100):
    """Shifted cross-entropy in float32: logsumexp(logits) - logits[target],
    averaged over targets that are not `ignore_index`."""
    logits = logits[:, :-1].float()
    targets = targets[:, 1:]
    mask = targets != ignore_index
    targets = torch.where(mask, targets, torch.zeros_like(targets))
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.unsqueeze(-1)).squeeze(-1)
    nll = (lse - tgt) * mask
    return nll.sum() / mask.sum().clamp_min(1)


def adamw(model: nn.Module, lr: float = 3e-4, weight_decay: float = 0.1
          ) -> torch.optim.AdamW:
    """The counterpart of `optax.adamw(lr, weight_decay=...)`: b1 0.9,
    b2 0.999, eps 1e-8, every parameter decayed (biases and LayerNorm too)."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    mesh=None, loss_fn: Optional[Callable] = None
                    ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """step(batch) -> the shown loss (a 0-dim tensor, not synchronised).

    `loss_fn(model, batch) -> (objective, shown)` sets the training
    objective (MoE adds its router losses to the cross-entropy); the step
    descends the objective and returns the shown loss. The default is
    next-token cross-entropy for both. Parameters and optimizer state are
    updated in place, the counterpart of the JAX step's donate_argnums=(0,
    1): no second copy of either is made.

    With `mesh` (the one `model` was placed on, `GPT2(mesh=)` or
    `Llama(mesh=)`), `batch` is this rank's shard of the global batch
    (`parallel.sharding.shard_batch`) and the step returns the GLOBAL
    loss, the same on every rank: the default objective is this rank's
    share of sum(nll * mask) / sum(mask) over the global batch
    (`next_token_loss_parts`); a `loss_fn` must likewise return an
    objective whose gradients, summed over the data axes and sp, are the
    global objective's. FSDP2 reduce-scatters (and averages) the gradients
    over fsdp, so the objective is scaled by fsdp's size before the
    backward; the replicated gradients are summed over dp, dcn_dp and sp
    (`sync_gradients`)."""
    if mesh is None:
        if loss_fn is None:
            def loss_fn(model, batch):
                ce = next_token_loss(model(batch["input_ids"]),
                                     batch["labels"])
                return ce, ce

        def step(batch):
            optimizer.zero_grad(set_to_none=True)
            objective, shown = loss_fn(model, batch)
            objective.backward()
            optimizer.step()
            return shown.detach()

        return step

    ctx = getattr(model, "mesh_ctx", None)
    if ctx is None or ctx.mesh is not mesh:
        raise ValueError("make_train_step(mesh=) steps a model placed on "
                         "that mesh (GPT2(mesh=...), Llama(mesh=...))")
    if loss_fn is None:
        def loss_fn(model, batch):
            return next_token_loss_parts(model(batch["input_ids"]),
                                         batch["labels"], ctx)
    scale = ctx.fsdp_size if ctx.fsdp else 1
    params = list(model.parameters())

    def mesh_step(batch):
        optimizer.zero_grad(set_to_none=True)
        objective, shown = loss_fn(model, batch)
        (objective * scale if scale != 1 else objective).backward()
        sync_gradients(params, ctx)
        optimizer.step()
        return shown.detach()

    return mesh_step


def make_eval_step(model: nn.Module):
    @torch.no_grad()
    def eval_step(batch):
        return next_token_loss(model(batch["input_ids"]), batch["labels"])

    return eval_step


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def flops_per_token(cfg: GPT2Config, seq_len: int) -> float:
    """Approximate training FLOPs per token (6N + attention)."""
    n = (12 * cfg.n_layer * cfg.n_embd ** 2
         + cfg.vocab_size * cfg.n_embd)
    attn = 12 * cfg.n_layer * cfg.n_embd * seq_len
    return 6.0 * n + 2.0 * attn
