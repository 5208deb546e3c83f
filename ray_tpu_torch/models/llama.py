"""Llama in PyTorch, computing what `ray_tpu/models/llama.py` computes.

RMSNorm, rotary position embeddings (halves-style), a SwiGLU MLP,
grouped-query attention and an untied head, with flax's defaults pinned:
dense layers without bias, computing in `dtype` on `param_dtype` weights;
RMSNorm eps 1e-5 with its statistics and scale in float32; RoPE in float32;
normal(0.02) for dense kernels and the embedding, ones for norm scales.

Three forward paths share the parameters:
- `forward(input_ids)`: full causal forward, the training forward;
  attention goes through the flash kernels
  (`ray_tpu_torch.ops.attention.flash_attention`) after the GQA repeat of
  K/V, so the backward runs the dQ and dK/dV kernels at the query heads'
  width and autograd sums dK/dV over each KV head's query group. With
  `remat`, each block runs under `torch.utils.checkpoint`. With `sp_mesh`
  (a DeviceMesh with an "sp" axis), attention runs the ring over that
  axis (`ops/ring_attention.ring_attention_sharded`) on the same repeated
  K/V: every rank holds the whole batch and sequence, and each computes
  its block of the attention.
- `decode(input_ids, cache, row_pos)`: incremental forward against a dense
  per-row KV cache.
- `decode_paged(input_ids, arenas, block_tables, row_pos, write_mask)`: the
  same against the paged arena of the continuous-batching engine
  (`ray_tpu_torch/inference/`), with optional late-fusion LoRA banks.

The two cache paths write K/V in place: the cache or arena passed in is the
one returned (the counterpart of the engine's donated buffers, so no step
copies the arena). The paged gather and scatter are ordinary PyTorch ops,
as XLA compiled them in the reference, not kernels.

For pipeline parallelism the model splits by layer into `LlamaStage`s
(`stage_layer_ranges`), whose parameters keep the whole model's names, so
`split_stage_params` and `merge_stage_params` regroup a state dict at any
pp by key (`train/pipeline.py` runs them).

With `mesh` (a training DeviceMesh), `Llama` and `LlamaStage` run the
training forward tensor-parallel (`parallel/tensor_parallel.py`): wq, wk,
wv, w_gate and w_up column-parallel, wo and w_down row-parallel, the
embedding and the head vocab-parallel, each rank holding n_head / tp query
heads and n_kv_head / tp KV heads (RoPE and the GQA repeat on its local
heads), its parameters DTensors; FSDP2 over fsdp and the ring over sp as
in GPT-2. On a tp mesh the two cache paths run on the same local heads:
each rank's cache or arena holds its n_kv_head / tp KV heads
(`make_cache`, `make_paged_arena` with `mesh`; `arena_sharding` names the
split), wo and w_down reduce over tp, the embedding stays vocab-parallel,
and `decode` and `decode_paged` return this rank's vocab shard of the
logits (`vocab_parallel_argmax` picks over them). The LoRA banks' `ao`
reads the local heads' flattened output (`lora_bank_shardings`): its
rank-dim partial sum is reduced over tp before `bo`. Placing a model on a
mesh from a seed draws the whole model's parameters one at a time and
keeps each one's shard, so a rank never holds the whole model.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._torch_env import resolve_device, same_device
from ray_tpu_torch.ops.attention import flash_attention, mha_reference
from ray_tpu_torch.ops.ring_attention import (ring_attention,
                                              ring_attention_sharded)
from ray_tpu_torch.parallel.mesh import axis_size
from ray_tpu_torch.parallel.sharding import (PartitionSpec,
                                             match_partition_rules,
                                             named_sharding, placements_for,
                                             shard_params)
from ray_tpu_torch.parallel.tensor_parallel import (MeshContext, local,
                                                    place_module,
                                                    shard_local,
                                                    tp_placements,
                                                    vocab_parallel_embedding)

_NEG_INF = -1e30


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_positions: int = 4096
    n_embd: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 8               # grouped-query attention
    intermediate: int = 11008        # SwiGLU hidden width
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    use_flash: bool = True
    remat: bool = False              # recompute each block in the backward
    # Sequence parallelism: a DeviceMesh with an "sp" axis routes the
    # training forward's attention through the ring (ops/ring_attention):
    # each rank takes a sequence shard and K/V chunks travel its sp group.
    # None (or a mesh without "sp", or sp 1) keeps the flash/plain path.
    sp_mesh: Any = None

    @staticmethod
    def llama7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def small() -> "LlamaConfig":
        """~110M-param config for single-chip experiments."""
        return LlamaConfig(n_embd=768, n_layer=12, n_head=12, n_kv_head=4,
                           intermediate=2048, n_positions=2048)

    @staticmethod
    def tiny(seq: int = 128) -> "LlamaConfig":
        return LlamaConfig(vocab_size=512, n_positions=seq, n_embd=128,
                           n_layer=2, n_head=4, n_kv_head=2,
                           intermediate=352, use_flash=False)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


class Dense(nn.Linear):
    """flax Dense without bias: input and kernel cast to the compute dtype.
    A kernel already in that dtype is used as it is (no copy)."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype):
        super().__init__(n_in, n_out, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), local(self.weight).to(dt))


class RMSNorm(nn.Module):
    """Statistics in float32, times the float32 scale, then cast to
    `dtype`."""

    def __init__(self, n: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + self.eps)
        return (out * local(self.weight).float()).to(self.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding on [b, heads, s, d] with per-token positions [b, s]
    (or [s]); rotates feature pairs (i, i + d/2), halves-style."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].float() * freqs       # [b, 1, s, h]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def qkv_heads(blk: nn.Module, h, positions):
    """q [b, heads, s, d] and k, v [b, kv_heads, s, d] of a block's
    attention input `h` [b, s, e], q and k rotated to `positions`. `blk`
    holds a config `cfg` and the dense layers `wq`, `wk`, `wv` (under tp,
    this rank's heads: the head counts come from their widths)."""
    cfg = blk.cfg
    hd = cfg.head_dim
    b, s, _ = h.shape
    q = blk.wq(h).view(b, s, -1, hd).transpose(1, 2)
    k = blk.wk(h).view(b, s, -1, hd).transpose(1, 2)
    v = blk.wv(h).view(b, s, -1, hd).transpose(1, 2)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def causal_attention(q, k, v, use_flash: bool, sp_mesh=None, sp_group=None):
    """Full causal attention of q over k, v after the GQA repeat (query
    head h reads KV head h // groups, as `jnp.repeat(k, groups, axis=1)`;
    autograd sums dK and dV over each group): the ring over `sp_mesh`'s sp
    axis (global tensors), the ring over `sp_group` (this rank's sequence
    shard), the flash kernels, or plain attention. The repeat comes before
    the ring, so every shard's chunks carry the query heads' K/V, the
    tensors the flash path sees: sp on or off is a change of schedule."""
    groups = q.shape[1] // k.shape[1]
    kf = k.repeat_interleave(groups, dim=1)
    vf = v.repeat_interleave(groups, dim=1)
    if sp_group is not None:
        return ring_attention(q, kf, vf, group=sp_group, causal=True)
    if sp_mesh is not None:
        return ring_attention_sharded(q, kf, vf, sp_mesh, causal=True)
    if use_flash:
        return flash_attention(q, kf, vf, True)
    return mha_reference(q, kf, vf, causal=True)


def _masked_attention(q, kf, vf, positions, hd: int, dtype):
    """Softmax attention in float32 of q [b, h, s, d] over a gathered
    context kf, vf [b, ctx, h, d], causal over ABSOLUTE positions: query at
    position p sees context slots <= p (fill -1e30)."""
    kv_pos = torch.arange(kf.shape[1], device=q.device)
    mask = kv_pos[None, None, :] <= positions[:, :, None]     # [b, s, ctx]
    scores = torch.einsum("bhqd,bkhd->bhqk", q.float(),
                          kf.float()) / (hd ** 0.5)
    scores = scores.masked_fill(~mask[:, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bhqd", probs, vf.float()).to(dtype)


def _paged_attention(q, k, v, positions, k_arena, v_arena, block_tables,
                     write_mask, groups: int, dtype):
    """Write this call's K/V [b, kvh, s, d] into the arena IN PLACE, then
    attend over each row's logical context gathered back out of it.

    Physical slot of logical position p in row i: block_tables[i, p // bsz]
    * bsz + p % bsz. Masked tokens (batch and chunk padding) are pointed at
    physical block 0, the trash block the manager never allocates: only it
    ever takes duplicate indices, and nothing reads it."""
    nb, bsz, kvh, hd = k_arena.shape
    b = q.shape[0]
    max_blocks = block_tables.shape[1]
    max_ctx = max_blocks * bsz
    kw = k.transpose(1, 2).to(k_arena.dtype)                  # [b, s, kvh, d]
    vw = v.transpose(1, 2).to(v_arena.dtype)
    blk = torch.clamp(positions // bsz, 0, max_blocks - 1)
    phys = torch.gather(block_tables, 1, blk)                 # [b, s]
    phys = torch.where(write_mask, phys, torch.zeros_like(phys))
    flat = (phys * bsz + positions % bsz).reshape(-1)
    k_flat = k_arena.view(nb * bsz, kvh, hd)
    v_flat = v_arena.view(nb * bsz, kvh, hd)
    k_flat.index_copy_(0, flat, kw.reshape(-1, kvh, hd))
    v_flat.index_copy_(0, flat, vw.reshape(-1, kvh, hd))
    # Gather each row's logical context back out of the arena. Unwritten
    # slots sit past every query's position (or behind trash-padded table
    # entries) and are masked out.
    slot = ((block_tables * bsz)[:, :, None]
            + torch.arange(bsz, device=q.device)[None, None, :])
    slot = slot.reshape(b, max_ctx)
    kf = k_flat[slot].repeat_interleave(groups, dim=2)        # [b, ctx, h, d]
    vf = v_flat[slot].repeat_interleave(groups, dim=2)
    return _masked_attention(q, kf, vf, positions, hd, dtype)


def _dense_cache_attention(q, k, v, positions, k_cache, v_cache,
                           groups: int, dtype):
    """Write K/V at each row's `positions` [b, s] into the dense cache
    [b, max_len, kvh, d] IN PLACE and attend over the whole cache."""
    b = q.shape[0]
    rows = torch.arange(b, device=q.device)[:, None]
    k_cache[rows, positions] = k.transpose(1, 2).to(k_cache.dtype)
    v_cache[rows, positions] = v.transpose(1, 2).to(v_cache.dtype)
    kf = k_cache.repeat_interleave(groups, dim=2)             # [b, max, h, d]
    vf = v_cache.repeat_interleave(groups, dim=2)
    return _masked_attention(q, kf, vf, positions, q.shape[-1], dtype)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
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
        self.w_gate = Dense(e, cfg.intermediate, cfg.dtype)
        self.w_up = Dense(e, cfg.intermediate, cfg.dtype)
        self.w_down = Dense(cfg.intermediate, e, cfg.dtype)

    def forward(self, x, positions, cache: Optional[Tuple] = None,
                lora: Optional[Tuple] = None):
        """cache=None: full causal forward. cache=(k, v) with layout
        [b, max_len, kv_heads, head_dim]: write this call's K/V at each
        row's `positions` and attend over the cache. cache=(k_arena,
        v_arena, block_tables, write_mask) with arenas [num_blocks,
        block_size, kv_heads, head_dim]: the paged variant. Returns
        (x, cache, side); cache tensors are updated in place.

        lora=(aq, bq, ao, bo, adapter_idx): late-fusion low-rank side term
        read off the attn-normed input (aq/bq) and the flattened attention
        output (ao/bo), per batch row's bank row (row 0 the zero identity).
        It is RETURNED, never added to x, so every layer's K/V stays the
        base model's whichever adapter ran (the arena is
        adapter-invariant).

        On a mesh every head count is this rank's (n_head / tp, n_kv_head
        / tp, and the cache's too), `ao` holds the rows of the local heads'
        flattened output, and its rank-dim partial sum is reduced over tp
        before `bo`."""
        cfg, ctx = self.cfg, self.mesh_ctx
        b, s, _ = x.shape
        h = self.attn_norm(x)
        if ctx is not None:
            h = ctx.copy_in(h)
        q, k, v = qkv_heads(self, h, positions)
        groups = cfg.n_head // cfg.n_kv_head
        if cache is None:
            sp_group = ctx.sp_group if ctx is not None and ctx.sp_size > 1 \
                else None
            attn = causal_attention(q, k, v, cfg.use_flash, cfg.sp_mesh,
                                    sp_group)
        elif len(cache) == 4:
            k_arena, v_arena, block_tables, write_mask = cache
            attn = _paged_attention(q, k, v, positions, k_arena, v_arena,
                                    block_tables, write_mask, groups,
                                    cfg.dtype)
        else:
            attn = _dense_cache_attention(q, k, v, positions, *cache, groups,
                                          cfg.dtype)
        attn = attn.transpose(1, 2).reshape(b, s, -1)
        out = self.wo(attn)
        if ctx is not None:
            out = ctx.reduce_out(out)
        side = None
        if lora is not None:
            aq, bq, ao, bo, aidx = lora
            # Per-row bank gather, then two thin products per tap, in the
            # model dtype end to end.
            s_in = torch.einsum("bsr,bre->bse",
                                torch.einsum("bse,ber->bsr", h, aq[aidx]),
                                bq[aidx])
            s_attn = torch.einsum("bsf,bfr->bsr", attn, ao[aidx])
            if ctx is not None:
                s_attn = ctx.reduce_out(s_attn)
            s_attn = torch.einsum("bsr,bre->bse", s_attn, bo[aidx])
            side = (s_in + s_attn).to(cfg.dtype)
        x = x + out

        h2 = self.mlp_norm(x)
        if ctx is not None:
            h2 = ctx.copy_in(h2)
        h2 = F.silu(self.w_gate(h2)) * self.w_up(h2)
        down = self.w_down(h2)
        if ctx is not None:
            down = ctx.reduce_out(down)
        return x + down, cache, side


class Llama(nn.Module):
    """Llama with an untied head. `device` defaults to the card.

    Parameters are drawn on the model's device from a `torch.Generator`
    seeded with `seed` (so one seed gives the same weights on one kind of
    device), unless `state` is given: a state dict whose tensors, on that
    device, become the parameters by reference (no copy) — another model's
    `state_dict()`, or `params_from_jax`'s on the CPU.

    With `mesh`, the model lives on the mesh's device type and is placed
    on it (module docstring), its shards copied out of the seeded weights
    (each parameter drawn whole and cut at once) or `state` (DTensors in
    `state` are taken as they are); `forward` takes this rank's shard of
    the ids and returns its vocab-sharded logits. Every rank passes the
    same seed or state."""

    def __init__(self, config: LlamaConfig,
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
            self.layers = nn.ModuleList(LlamaBlock(config)
                                        for _ in range(config.n_layer))
            self.final_norm = RMSNorm(config.n_embd, config.rms_eps,
                                      config.dtype)
            self.lm_head = Dense(config.n_embd, config.vocab_size,
                                 config.dtype)
        if state is None:
            self._init_weights(seed, dev, _tp_cutter(self, mesh))
        else:
            for name, t in state.items():
                if not same_device(dev, t.device):
                    raise ValueError(f"state tensor {name} lies on "
                                     f"{t.device}, the model on {dev}")
            self.load_state_dict(state, assign=True)
        if mesh is not None:
            self.mesh_ctx = _place_on_mesh(self, mesh, list(self.layers))

    @torch.no_grad()
    def _init_weights(self, seed: int, dev: torch.device, cut=None):
        """Draw every parameter in order; `cut(name, whole)` (on a tp mesh)
        keeps only this rank's shard of each as it is drawn."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        dt = self.config.param_dtype
        for name, p in list(self.named_parameters()):
            init = torch.empty(p.shape, dtype=dt, device=dev)
            if name.endswith("norm.weight"):
                init.fill_(1.0)
            else:
                init.normal_(0.0, 0.02, generator=gen)
            _set_param(self, name, init if cut is None else cut(name, init))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def compute_copy(self) -> "Llama":
        """This model with its dense kernels and embedding as `dtype`
        copies (norm scales shared): numerically the same model, since each
        call would cast them to `dtype` anyway, without re-reading the
        `param_dtype` weights at every call. The serving engine's weights.
        On a mesh the copy is on the same mesh, cast shard by shard."""
        dt = self.config.dtype
        state = {name: t if name.endswith("norm.weight") else t.to(dt)
                 for name, t in self.state_dict().items()}
        return Llama(self.config, device=self.device, state=state,
                     mesh=self.mesh_ctx.mesh if self.mesh_ctx else None)

    def _embed(self, input_ids):
        return vocab_parallel_embedding(
            input_ids, local(self.embed).to(self.config.dtype), self.mesh_ctx)

    def _head(self, x):
        """Logits of the final-normed `x`: this rank's vocab shard on a
        mesh."""
        ctx = self.mesh_ctx
        return self.lm_head(ctx.copy_in(x) if ctx is not None else x)

    def forward(self, input_ids):
        ctx = self.mesh_ctx
        x = self._embed(input_ids)
        positions = _positions(input_ids.shape[1], input_ids.device, ctx)
        for blk in self.layers:
            if self.config.remat:
                x, _, _ = checkpoint(blk, x, positions, use_reentrant=False)
            else:
                x, _, _ = blk(x, positions)
        return self._head(self.final_norm(x))

    @torch.no_grad()
    def decode(self, input_ids, cache, row_pos):
        """Incremental forward: each row writes K/V at its own offset
        (`row_pos` [b]) and gets logits for its s tokens. Returns (logits,
        cache), the cache updated in place; on a mesh the cache holds this
        rank's KV heads and the logits are its vocab shard."""
        b, s = input_ids.shape
        x = self._embed(input_ids)
        positions = row_pos[:, None] + torch.arange(
            s, device=input_ids.device)[None, :]
        for blk, layer_cache in zip(self.layers, cache):
            x, _, _ = blk(x, positions, cache=layer_cache)
        return self._head(self.final_norm(x)), cache

    @torch.no_grad()
    def decode_paged(self, input_ids, arenas, block_tables, row_pos,
                     write_mask, lora_banks=None, adapter_idx=None):
        """The continuous-batching engine's step: `input_ids` [b, s] are
        each row's next s tokens, `arenas` the per-layer [(k, v)] block
        arena, `block_tables` [b, max_blocks] each row's physical blocks,
        `row_pos` [b] each row's first write position, `write_mask` [b, s]
        False for padding (written to trash block 0). Returns (logits
        [b, s, vocab], arenas), the arenas updated in place.

        `lora_banks` (per-layer [(aq, bq, ao, bo)]) + `adapter_idx` [b]:
        each layer's side term is summed and merged into the hidden state
        ONCE, before the final norm.

        On a mesh the arenas and `ao` are this rank's shards
        (`make_paged_arena(mesh=)`, `lora_bank_shardings`) and the logits
        its vocab shard [b, s, vocab / tp]."""
        b, s = input_ids.shape
        x = self._embed(input_ids)
        positions = row_pos[:, None] + torch.arange(
            s, device=input_ids.device)[None, :]
        side_sum = None
        for i, blk in enumerate(self.layers):
            k_a, v_a = arenas[i]
            lora = None
            if lora_banks is not None:
                lora = (*lora_banks[i], adapter_idx)
            x, _, side = blk(x, positions,
                             cache=(k_a, v_a, block_tables, write_mask),
                             lora=lora)
            if side is not None:
                side_sum = side if side_sum is None else side_sum + side
        if side_sum is not None:
            x = x + side_sum.to(x.dtype)
        return self._head(self.final_norm(x)), arenas


def _set_param(module: nn.Module, name: str, value: torch.Tensor) -> None:
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    setattr(module, leaf, nn.Parameter(value))


def _positions(s: int, device, ctx: Optional[MeshContext]) -> torch.Tensor:
    """Global positions of this rank's s tokens (its sp shard's offset on
    a mesh)."""
    start = ctx.sp_rank * s if ctx is not None else 0
    return torch.arange(start, start + s, device=device)


def _tp_dims(module: nn.Module) -> Dict[str, Optional[int]]:
    """Parameter name -> the dim LLAMA_PARTITION_RULES split over tp
    (None: replicated)."""
    specs = match_partition_rules(LLAMA_PARTITION_RULES,
                                  dict(module.named_parameters()))
    return {n: next((d for d, a in enumerate(spec) if a == "tp"), None)
            for n, spec in specs.items()}


def _tp_cutter(module: nn.Module, mesh):
    """(name, whole parameter) -> this rank's tp shard of it as a DTensor,
    for drawing a model on a mesh one parameter at a time; None where there
    is no mesh or no tp axis."""
    if mesh is None or "tp" not in mesh.mesh_dim_names:
        return None
    validate_tp(module.config, axis_size(mesh, "tp"))
    dims, tp_mesh = _tp_dims(module), mesh["tp"]
    return lambda name, t: shard_local(t, tp_mesh, tp_placements(dims[name]))


def _place_on_mesh(module: nn.Module, mesh, blocks) -> MeshContext:
    """Place a `Llama` or `LlamaStage` on `mesh` (`place_module`): tp
    shards by LLAMA_PARTITION_RULES, FSDP2 on each parameter's "embed" dim
    (`logical_param_specs`); every block gets the mesh's context."""
    cfg = module.config
    validate_tp(cfg, axis_size(mesh, "tp"))
    names = [n for n, _ in module.named_parameters()]
    tp_dims = _tp_dims(module)
    axes = _logical_axes(names)
    fsdp_dims = {n: axes[n].index("embed") if "embed" in axes[n] else 0
                 for n in names}
    ctx = MeshContext.of(mesh)
    place_module(module, ctx, tp_dims, fsdp_dims, blocks)
    for blk in blocks:
        blk.mesh_ctx = ctx
    return ctx


# --------------------------------------------------------------------------- #
# Caches, adapter banks, weights from the flax tree
# --------------------------------------------------------------------------- #


def arena_sharding(cfg: LlamaConfig, mesh):
    """(mesh, placements) of the paged KV arena [num_blocks, block_size,
    kv_heads, head_dim] on `mesh`: the kv-head dim over "tp", the split of
    the attention heads that read it (the reference's
    `PartitionSpec(None, None, "tp")`), after `validate_tp`."""
    validate_tp(cfg, _mesh_tp(mesh))
    return mesh, placements_for(PartitionSpec(None, None, "tp"),
                                mesh.mesh_dim_names)


def _kv_heads(cfg: LlamaConfig, mesh) -> int:
    """The KV heads a rank's cache holds: all of them, or its tp share."""
    if mesh is None:
        return cfg.n_kv_head
    arena_sharding(cfg, mesh)
    return cfg.n_kv_head // _mesh_tp(mesh)


def make_paged_arena(cfg: LlamaConfig, num_blocks: int, block_size: int,
                     device: Optional[Union[str, torch.device]] = None,
                     mesh=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Preallocated per-layer (k, v) paged arena [num_blocks, block_size,
    kv_heads, head_dim] in `dtype`. Block 0 is the trash block (never
    allocated to a sequence): masked writes land there and nothing ever
    reads it. With `mesh`, only this rank's shard (`arena_sharding`) is
    allocated, [num_blocks, block_size, n_kv_head / tp, head_dim], never
    the whole arena."""
    dev = resolve_device(device)
    shape = (num_blocks, block_size, _kv_heads(cfg, mesh), cfg.head_dim)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=dev),
             torch.zeros(shape, dtype=cfg.dtype, device=dev))
            for _ in range(cfg.n_layer)]


def make_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device: Optional[Union[str, torch.device]] = None,
               mesh=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Preallocated per-layer (k, v) cache [b, max_len, kv_heads, head_dim]
    (length-major so per-row writes are a single advanced-index set); with
    `mesh`, this rank's n_kv_head / tp heads."""
    dev = resolve_device(device)
    shape = (batch, max_len, _kv_heads(cfg, mesh), cfg.head_dim)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=dev),
             torch.zeros(shape, dtype=cfg.dtype, device=dev))
            for _ in range(cfg.n_layer)]


def lora_bank_shapes(cfg: LlamaConfig, n_rows: int, rank: int):
    """Per-layer bank shapes (aq, bq, ao, bo): one row per resident
    adapter, row 0 reserved as the zero identity. aq/bq read the block's
    attn-normed input, ao/bo the flattened attention output; both target
    the embedding and merge once, before the final norm."""
    return ((n_rows, cfg.n_embd, rank),
            (n_rows, rank, cfg.n_embd),
            (n_rows, cfg.n_head * cfg.head_dim, rank),
            (n_rows, rank, cfg.n_embd))


def lora_bank_shardings(cfg: LlamaConfig, mesh):
    """(mesh, placements) of one layer's (aq, bq, ao, bo) banks on `mesh`:
    ao's input dim splits over "tp" with the flattened heads it reads (its
    rank-dim partial sums are reduced over tp, where wo's are); aq, bq and
    bo are replicated. The reference's `lora_bank_shardings`, after
    `validate_tp`."""
    validate_tp(cfg, _mesh_tp(mesh))
    names = mesh.mesh_dim_names
    rep = (mesh, placements_for(PartitionSpec(), names))
    return rep, rep, (mesh, placements_for(PartitionSpec(None, "tp"),
                                           names)), rep


def make_adapter_weights(cfg: LlamaConfig, rank: int, seed: int,
                         scale: float = 0.05):
    """Deterministic per-layer LoRA rows from a seed: the same seed always
    yields the same weights, bit for bit the reference's (numpy float32
    draws, rounded to `dtype` to nearest even). Returns per-layer (aq_row,
    bq_row, ao_row, bo_row) CPU tensors in the model dtype."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(cfg.n_layer):
        rows = []
        for shape in ((cfg.n_embd, rank), (rank, cfg.n_embd),
                      (cfg.n_head * cfg.head_dim, rank),
                      (rank, cfg.n_embd)):
            w = rng.standard_normal(shape, dtype=np.float32) * scale
            rows.append(torch.from_numpy(w * 1.0).to(cfg.dtype))
        out.append(tuple(rows))
    return out


def params_from_jax(params_np: Dict) -> Dict[str, torch.Tensor]:
    """The port's state dict from the JAX model's parameter tree.

    `params_np` is the flax tree unboxed to nested dicts of numpy arrays
    (with or without the top-level "params" key). Dense kernels [in, out]
    become [out, in]; norm `scale` becomes `weight`."""
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
        for dense in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            out[f"layers.{i}.{dense}.weight"] = \
                t(blk[dense]["kernel"]).t().contiguous()
    return out


# --------------------------------------------------------------------------- #
# Tensor-parallel widths and the partition rule table
# --------------------------------------------------------------------------- #


def validate_tp(cfg: LlamaConfig, tp: int) -> None:
    """Fail fast on widths that cannot be sharded evenly: attention heads,
    KV heads (the paged arena shards with them), the SwiGLU hidden width
    and the vocab all split over tp."""
    bad = {name: dim for name, dim in (
        ("n_head", cfg.n_head), ("n_kv_head", cfg.n_kv_head),
        ("intermediate", cfg.intermediate), ("vocab_size", cfg.vocab_size))
        if dim % tp}
    if bad:
        raise ValueError(
            f"tp={tp} does not divide {bad} — pick a tp width that "
            "divides heads, kv heads, the MLP hidden and the vocab")


# Logical axes of each parameter: the reference's `with_logical_partitioning`
# annotations (`ray_tpu/models/llama.py:78-293`) on the port's names, a
# dense weight's the flax kernel's reversed (the weight is [out, in]).
_LOGICAL = (
    (r"embed$", ("vocab", "embed")),
    (r"(wq|wk|wv)\.weight$", ("heads", "embed")),
    (r"wo\.weight$", ("embed", "heads")),
    (r"(w_gate|w_up)\.weight$", ("mlp", "embed")),
    (r"w_down\.weight$", ("embed", "mlp")),
    (r"lm_head\.weight$", ("vocab", "embed")),
    (r"norm\.weight$", ("embed",)),
)


def _logical_axes(names) -> Dict[str, Tuple]:
    return {n: next(ax for pattern, ax in _LOGICAL if re.search(pattern, n))
            for n in names}


def logical_param_specs(model: nn.Module) -> Dict[str, Tuple]:
    """Parameter name -> the logical axes of its dims (the reference's
    annotations): what `tp_shardings` resolves through the rules."""
    return _logical_axes([n for n, _ in model.named_parameters()])


def tp_shardings(model: nn.Module, mesh) -> Dict[str, tuple]:
    """Parameter name -> (mesh, placements) on `mesh`: the logical axes
    through the standard rules (heads, mlp and vocab over tp; embed over
    fsdp), as the reference's `tp_shardings` resolves them."""
    return {name: named_sharding(mesh, *axes)
            for name, axes in logical_param_specs(model).items()}


def shard_params_tp(model: nn.Module, params: Dict[str, torch.Tensor], mesh
                    ) -> Dict[str, Any]:
    """A state dict placed as DTensors in its `tp_shardings` layout, after
    `validate_tp` (the reference's `shard_params_tp`). Every rank passes
    the same values."""
    validate_tp(model.config, _mesh_tp(mesh))
    return shard_params(params, mesh, logical_param_specs(model))


def _mesh_tp(mesh) -> int:
    return axis_size(mesh, "tp")


# The `match_partition_rules` table over a ("sp", "tp") mesh:
# column-parallel q/k/v/gate/up (output dim over tp), row-parallel wo and
# w_down (input dim over tp), vocab-sharded embed and lm_head, replicated
# norms. The reference's table (`ray_tpu/models/llama.py:473-489`) on the
# port's names: a dense layer's weight is [out, in], the flax kernel's
# transpose, so each spec names the same dim of the same parameter.
LLAMA_PARTITION_RULES = (
    (r"embed$", PartitionSpec("tp")),
    (r"(wq|wk|wv)\.weight$", PartitionSpec("tp")),
    (r"wo\.weight$", PartitionSpec(None, "tp")),
    (r"(w_gate|w_up)\.weight$", PartitionSpec("tp")),
    (r"w_down\.weight$", PartitionSpec(None, "tp")),
    (r"lm_head\.weight$", PartitionSpec("tp")),
    (r"(attn_norm|mlp_norm|final_norm)\.weight$", PartitionSpec()),
)


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs/token: 6N for the matmuls + attention term."""
    per_layer = (2 * cfg.n_embd * (cfg.n_head + 2 * cfg.n_kv_head)
                 * cfg.head_dim                       # qkv
                 + cfg.n_head * cfg.head_dim * cfg.n_embd  # out proj
                 + 3 * cfg.n_embd * cfg.intermediate)      # swiglu
    n = cfg.n_layer * per_layer + 2 * cfg.vocab_size * cfg.n_embd
    attn = 12 * cfg.n_layer * cfg.n_embd * seq_len
    return 6.0 * n + 2.0 * attn


# --------------------------------------------------------------------------- #
# Pipeline stages: the model partitioned by layer
# --------------------------------------------------------------------------- #


def stage_layer_ranges(cfg: LlamaConfig, pp: int) -> List[Tuple[int, int]]:
    """[start, end) layer range per pipeline stage: near-even split, the
    remainder to the EARLIER stages (the last stage already carries the
    final norm and the vocab-wide lm_head product)."""
    if not 1 <= pp <= cfg.n_layer:
        raise ValueError(f"pp={pp} must be in [1, n_layer={cfg.n_layer}]")
    base, rem = divmod(cfg.n_layer, pp)
    ranges, start = [], 0
    for s in range(pp):
        end = start + base + (1 if s < rem else 0)
        ranges.append((start, end))
        start = end
    return ranges


def _param_shapes(cfg: LlamaConfig) -> List[Tuple[str, torch.Size]]:
    """(name, shape) of every parameter of `Llama(cfg)`, in its order."""
    with torch.device("meta"):
        blk = LlamaBlock(cfg)
    out = [("embed", torch.Size((cfg.vocab_size, cfg.n_embd)))]
    for i in range(cfg.n_layer):
        out += [(f"layers.{i}.{name}", p.shape)
                for name, p in blk.named_parameters()]
    return out + [("final_norm.weight", torch.Size((cfg.n_embd,))),
                  ("lm_head.weight", torch.Size((cfg.vocab_size,
                                                 cfg.n_embd)))]


def _stage_of(name: str, ranges: List[Tuple[int, int]]) -> int:
    """The stage that holds parameter `name` (global names)."""
    if name == "embed":
        return 0
    if name.startswith("layers."):
        i = int(name.split(".")[1])
        return next(s for s, (a, b) in enumerate(ranges) if a <= i < b)
    return len(ranges) - 1           # final_norm, lm_head


class LlamaStage(nn.Module):
    """One pipeline stage of :class:`Llama`: stage 0 owns the embedding and
    its layer range, the last stage its range, the final norm and lm_head.
    Parameter names are the whole model's (``layers.{i}`` keeps the GLOBAL
    layer index), so a full state dict splits into stage dicts, and regroups
    at any pp, by key alone.

    `seed` draws the same weights `Llama(cfg, seed=seed)` draws on this
    device: every parameter of the whole model is drawn in its order and
    only this stage's are kept, so every pp starts from the same model.
    `state` (a stage dict on `device`) is taken by reference instead.
    `device="meta"` makes the skeleton alone, for callers that pass the
    parameters at each call (`torch.func.functional_call`).

    With `mesh` (the stage's ("sp", "tp") mesh), the stage runs
    tensor-parallel as `Llama(mesh=)` does: its parameters are placed on
    the mesh, or, for a meta skeleton, the callers' parameters are the
    DTensors that `shard_stage_params` places."""

    def __init__(self, cfg: LlamaConfig, stage: int, pp: int,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0,
                 state: Optional[Dict[str, torch.Tensor]] = None,
                 mesh=None):
        super().__init__()
        ranges = stage_layer_ranges(cfg, pp)
        if not 0 <= stage < pp:
            raise ValueError(f"stage {stage} of pp={pp}")
        meta = device is not None and torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        self.config, self.stage, self.pp = cfg, stage, pp
        self.is_first, self.is_last = stage == 0, stage == pp - 1
        self.mesh_ctx: Optional[MeshContext] = None
        start, end = ranges[stage]
        with torch.device("meta"):
            if self.is_first:
                self.embed = nn.Parameter(torch.empty(cfg.vocab_size,
                                                      cfg.n_embd))
            self.layers = nn.ModuleDict({str(i): LlamaBlock(cfg)
                                         for i in range(start, end)})
            if self.is_last:
                self.final_norm = RMSNorm(cfg.n_embd, cfg.rms_eps, cfg.dtype)
                self.lm_head = Dense(cfg.n_embd, cfg.vocab_size, cfg.dtype)
        if meta:
            if mesh is not None:
                self.mesh_ctx = MeshContext.of(mesh)
                for blk in self.layers.values():
                    blk.mesh_ctx = self.mesh_ctx
            return
        if state is None:
            self._init_weights(seed, dev, ranges)
        else:
            for name, t in state.items():
                if not same_device(dev, t.device):
                    raise ValueError(f"state tensor {name} lies on "
                                     f"{t.device}, the stage on {dev}")
            self.load_state_dict(state, assign=True)
        if mesh is not None:
            self.mesh_ctx = _place_on_mesh(self, mesh,
                                           list(self.layers.values()))

    @torch.no_grad()
    def _init_weights(self, seed: int, dev: torch.device,
                      ranges: List[Tuple[int, int]]) -> None:
        # Llama._init_weights' draws, in its order, the other stages'
        # dropped as they are made.
        gen = torch.Generator(device=dev).manual_seed(seed)
        dt = self.config.param_dtype
        for name, shape in _param_shapes(self.config):
            init = torch.empty(shape, dtype=dt, device=dev)
            if name.endswith("norm.weight"):
                init.fill_(1.0)
            else:
                init.normal_(0.0, 0.02, generator=gen)
            if _stage_of(name, ranges) == self.stage:
                _set_param(self, name, init)

    def forward(self, x):
        """Stage 0 takes token ids [b, s]; later stages take the previous
        stage's activations [b, s, embd]. The last stage returns logits,
        every other stage its boundary activations."""
        cfg, ctx = self.config, self.mesh_ctx
        if self.is_first:
            x = vocab_parallel_embedding(x, local(self.embed).to(cfg.dtype),
                                         ctx)
        positions = _positions(x.shape[1], x.device, ctx)
        for blk in self.layers.values():
            if cfg.remat:
                x, _, _ = checkpoint(blk, x, positions, use_reentrant=False)
            else:
                x, _, _ = blk(x, positions)
        if self.is_last:
            x = self.final_norm(x)
            return self.lm_head(ctx.copy_in(x) if ctx is not None else x)
        return x


def split_stage_params(params: Dict[str, Any], cfg: LlamaConfig, pp: int
                       ) -> List[Dict[str, Any]]:
    """A whole model's dict (``embed``, ``layers.{i}.…``, ``final_norm.…``,
    ``lm_head.…``) -> one dict per stage. Pure regrouping: values are
    shared, never copied, and keys keep their global names, so it inverts
    :func:`merge_stage_params` at ANY pp."""
    ranges = stage_layer_ranges(cfg, pp)
    out: List[Dict[str, Any]] = [{} for _ in range(pp)]
    for name, value in params.items():
        out[_stage_of(name, ranges)][name] = value
    return out


def merge_stage_params(stage_dicts) -> Dict[str, Any]:
    """Union of per-stage dicts back into the whole model's (global key
    names make this a plain dict merge)."""
    out: Dict[str, Any] = {}
    for tree in stage_dicts:
        dup = set(out) & set(tree)
        if dup:
            raise ValueError(f"stage dicts overlap on {sorted(dup)}: these "
                             "are not disjoint stage splits")
        out.update(tree)
    return out


def shard_stage_params(stage_params: Dict[str, torch.Tensor], mesh
                       ) -> Dict[str, Any]:
    """Place one stage's dict on its ("sp", "tp") stage mesh as DTensors by
    LLAMA_PARTITION_RULES (axes the mesh lacks stay replicated, so a mesh
    without tp works unchanged)."""
    from ray_tpu_torch.parallel.sharding import shard_params_by_rules

    return shard_params_by_rules(stage_params, mesh, LLAMA_PARTITION_RULES)
