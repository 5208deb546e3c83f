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
  `remat`, each block runs under `torch.utils.checkpoint`.
- `decode(input_ids, cache, row_pos)`: incremental forward against a dense
  per-row KV cache.
- `decode_paged(input_ids, arenas, block_tables, row_pos, write_mask)`: the
  same against the paged arena of the continuous-batching engine
  (`ray_tpu_torch/inference/`), with optional late-fusion LoRA banks.

The two cache paths write K/V in place: the cache or arena passed in is the
one returned (the counterpart of the engine's donated buffers, so no step
copies the arena). The paged gather and scatter are ordinary PyTorch ops,
as XLA compiled them in the reference, not kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._torch_env import resolve_device, same_device
from ray_tpu_torch.ops.attention import flash_attention, mha_reference

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
    sp_mesh: Any = None              # sequence parallelism: ROADMAP M8

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
        return F.linear(x.to(dt), self.weight.to(dt))


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
        return (out * self.weight.float()).to(self.dtype)


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
    holds a config `cfg` and the dense layers `wq`, `wk`, `wv`."""
    cfg = blk.cfg
    hd = cfg.head_dim
    b, s, _ = h.shape
    q = blk.wq(h).view(b, s, cfg.n_head, hd).transpose(1, 2)
    k = blk.wk(h).view(b, s, cfg.n_kv_head, hd).transpose(1, 2)
    v = blk.wv(h).view(b, s, cfg.n_kv_head, hd).transpose(1, 2)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def causal_attention(q, k, v, use_flash: bool):
    """Full causal attention of q over k, v after the GQA repeat (query
    head h reads KV head h // groups, as `jnp.repeat(k, groups, axis=1)`;
    autograd sums dK and dV over each group): the flash kernels, or plain
    attention."""
    groups = q.shape[1] // k.shape[1]
    kf = k.repeat_interleave(groups, dim=1)
    vf = v.repeat_interleave(groups, dim=1)
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
        adapter-invariant)."""
        cfg = self.cfg
        hd = cfg.head_dim
        b, s, _ = x.shape
        h = self.attn_norm(x)
        q, k, v = qkv_heads(self, h, positions)
        groups = cfg.n_head // cfg.n_kv_head
        if cache is None:
            attn = causal_attention(q, k, v, cfg.use_flash)
        elif len(cache) == 4:
            k_arena, v_arena, block_tables, write_mask = cache
            attn = _paged_attention(q, k, v, positions, k_arena, v_arena,
                                    block_tables, write_mask, groups,
                                    cfg.dtype)
        else:
            attn = _dense_cache_attention(q, k, v, positions, *cache, groups,
                                          cfg.dtype)
        attn = attn.transpose(1, 2).reshape(b, s, cfg.n_head * hd)
        out = self.wo(attn)
        side = None
        if lora is not None:
            aq, bq, ao, bo, aidx = lora
            # Per-row bank gather, then two thin products per tap, in the
            # model dtype end to end.
            s_in = torch.einsum("bsr,bre->bse",
                                torch.einsum("bse,ber->bsr", h, aq[aidx]),
                                bq[aidx])
            s_attn = torch.einsum("bsr,bre->bse",
                                  torch.einsum("bsf,bfr->bsr", attn,
                                               ao[aidx]),
                                  bo[aidx])
            side = (s_in + s_attn).to(cfg.dtype)
        x = x + out

        h2 = self.mlp_norm(x)
        h2 = F.silu(self.w_gate(h2)) * self.w_up(h2)
        x = x + self.w_down(h2)
        return x, cache, side


class Llama(nn.Module):
    """Llama with an untied head. `device` defaults to the card.

    Parameters are drawn on the model's device from a `torch.Generator`
    seeded with `seed` (so one seed gives the same weights on one kind of
    device), unless `state` is given: a state dict whose tensors, on that
    device, become the parameters by reference (no copy) — another model's
    `state_dict()`, or `params_from_jax`'s on the CPU."""

    def __init__(self, config: LlamaConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0,
                 state: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        if config.sp_mesh is not None:
            raise NotImplementedError(
                "sp_mesh: sequence parallelism is ROADMAP M8, not yet "
                "ported")
        dev = resolve_device(device)
        self.config = config
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
            self._init_weights(seed, dev)
        else:
            for name, t in state.items():
                if not same_device(dev, t.device):
                    raise ValueError(f"state tensor {name} lies on "
                                     f"{t.device}, the model on {dev}")
            self.load_state_dict(state, assign=True)

    @torch.no_grad()
    def _init_weights(self, seed: int, dev: torch.device):
        gen = torch.Generator(device=dev).manual_seed(seed)
        dt = self.config.param_dtype
        for name, p in list(self.named_parameters()):
            init = torch.empty(p.shape, dtype=dt, device=dev)
            if name.endswith("norm.weight"):
                init.fill_(1.0)
            else:
                init.normal_(0.0, 0.02, generator=gen)
            _set_param(self, name, init)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def compute_copy(self) -> "Llama":
        """This model with its dense kernels and embedding as `dtype`
        copies (norm scales shared): numerically the same model, since each
        call would cast them to `dtype` anyway, without re-reading the
        `param_dtype` weights at every call. The serving engine's weights."""
        dt = self.config.dtype
        state = {name: t if name.endswith("norm.weight") else t.to(dt)
                 for name, t in self.state_dict().items()}
        return Llama(self.config, device=self.device, state=state)

    def _embed(self, input_ids):
        return self.embed.to(self.config.dtype)[input_ids]

    def forward(self, input_ids):
        b, s = input_ids.shape
        x = self._embed(input_ids)
        positions = torch.arange(s, device=input_ids.device)
        for blk in self.layers:
            if self.config.remat:
                x, _, _ = checkpoint(blk, x, positions, use_reentrant=False)
            else:
                x, _, _ = blk(x, positions)
        return self.lm_head(self.final_norm(x))

    @torch.no_grad()
    def decode(self, input_ids, cache, row_pos):
        """Incremental forward: each row writes K/V at its own offset
        (`row_pos` [b]) and gets logits for its s tokens. Returns (logits,
        cache), the cache updated in place."""
        b, s = input_ids.shape
        x = self._embed(input_ids)
        positions = row_pos[:, None] + torch.arange(
            s, device=input_ids.device)[None, :]
        for blk, layer_cache in zip(self.layers, cache):
            x, _, _ = blk(x, positions, cache=layer_cache)
        return self.lm_head(self.final_norm(x)), cache

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
        ONCE, before the final norm."""
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
        return self.lm_head(self.final_norm(x)), arenas


def _set_param(module: nn.Module, name: str, value: torch.Tensor) -> None:
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    setattr(module, leaf, nn.Parameter(value))


# --------------------------------------------------------------------------- #
# Caches, adapter banks, weights from the flax tree
# --------------------------------------------------------------------------- #


def make_paged_arena(cfg: LlamaConfig, num_blocks: int, block_size: int,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Preallocated per-layer (k, v) paged arena [num_blocks, block_size,
    kv_heads, head_dim] in `dtype`. Block 0 is the trash block (never
    allocated to a sequence): masked writes land there and nothing ever
    reads it. Sharding it over a mesh waits for ROADMAP M8."""
    dev = resolve_device(device)
    shape = (num_blocks, block_size, cfg.n_kv_head, cfg.head_dim)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=dev),
             torch.zeros(shape, dtype=cfg.dtype, device=dev))
            for _ in range(cfg.n_layer)]


def make_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device: Optional[Union[str, torch.device]] = None
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Preallocated per-layer (k, v) cache [b, max_len, kv_heads, head_dim]
    (length-major so per-row writes are a single advanced-index set)."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_head, cfg.head_dim)
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


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs/token: 6N for the matmuls + attention term."""
    per_layer = (2 * cfg.n_embd * (cfg.n_head + 2 * cfg.n_kv_head)
                 * cfg.head_dim                       # qkv
                 + cfg.n_head * cfg.head_dim * cfg.n_embd  # out proj
                 + 3 * cfg.n_embd * cfg.intermediate)      # swiglu
    n = cfg.n_layer * per_layer + 2 * cfg.vocab_size * cfg.n_embd
    attn = 12 * cfg.n_layer * cfg.n_embd * seq_len
    return 6.0 * n + 2.0 * attn
