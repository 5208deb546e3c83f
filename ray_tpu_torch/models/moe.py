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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._torch_env import resolve_device, same_device
from ray_tpu_torch.models.gpt2 import make_train_step, next_token_loss
from ray_tpu_torch.models.llama import (Dense, RMSNorm, causal_attention,
                                        qkv_heads)


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


def _dispatch(gate_idx, gate_vals, n_experts: int, cap: int):
    """(dispatch [T, E, C] float32 0/1, kept gate [T, E]) for the routing
    choices gate_idx, gate_vals [T, k], choice 0 queued first.

    A token picks an expert at most once, so each (token, expert) row of the
    reference's sum over choices of keep * one_hot(slot) holds one term:
    the slot is gathered over the choices as an index (-1 where the token
    was not routed there, or was dropped) and one-hot encoded once, which
    gives the reference's tensor exactly. `(pos == arange(C))` stands for
    `jax.nn.one_hot`, which gives a zero row out of range where
    `F.one_hot` raises."""
    t, k = gate_idx.shape
    dev = gate_idx.device
    experts = torch.arange(n_experts, device=dev)[:, None]
    # Expert-major [E, T], so the queue's cumulative sum runs along the
    # contiguous dimension: a scan down T rows of E columns is slow on the
    # card (PERF.md, MoE-small).
    fill = torch.zeros(n_experts, 1, device=dev)             # slots used
    slot = torch.full((n_experts, t), -1, dtype=torch.long, device=dev)
    gates = torch.zeros(n_experts, t, device=dev)
    for j in range(k):
        onehot = (gate_idx[:, j] == experts).float()             # [E, T]
        # Queue position; float32 cumulative sums of 0/1 are exact for
        # T < 2**24.
        pos = onehot.cumsum(1) - 1.0 + fill
        keep = (pos < cap) & (onehot > 0)                         # dropped past C
        slot = torch.where(keep, pos.long(), slot)
        gates = gates + keep.float() * gate_vals[:, j]
        fill = fill + onehot.sum(1, keepdim=True)
    arange = torch.arange(cap, device=dev)
    dispatch = (slot.t().contiguous()[..., None] == arange).float()
    return dispatch, gates.t()


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU experts with fixed capacity, [b, s, d] in and
    out. Returns (y, router loss, dispatch, combine)."""

    def __init__(self, cfg: MoEConfig):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.n_embd, cfg.intermediate
        self.router = nn.Parameter(torch.empty(d, e))    # float32 always
        self.w_gate = nn.Parameter(torch.empty(e, d, f))
        self.w_up = nn.Parameter(torch.empty(e, d, f))
        self.w_down = nn.Parameter(torch.empty(e, f, d))

    def forward(self, x):
        cfg = self.cfg
        b, s, d = x.shape
        t = b * s
        e, dt = cfg.n_experts, cfg.dtype
        cap = expert_capacity(cfg, t)

        xt = x.reshape(t, d)
        logits = xt.float() @ self.router.float()                # [T, E]
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
        # Mixtral renormalises the selected gates to sum to one.
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(
            1e-9)
        dispatch, gates = _dispatch(gate_idx, gate_vals, e, cap)
        combine = dispatch * gates[..., None]

        # Switch aux loss: E * sum_e(token_frac_e * mean_prob_e) over the
        # top-1 assignment (which carries no gradient); z-loss controls
        # router logit growth.
        token_frac = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
        aux = cfg.aux_coef * e * (token_frac * probs.mean(dim=0)).sum()
        z = cfg.router_z_coef * torch.logsumexp(logits, dim=-1).square(
            ).mean()

        # Dispatch and combine in float32, the expert products in `dtype`.
        xd = (dispatch.view(t, e * cap).t() @ xt.float()).to(dt)
        xd = xd.view(e, cap, d)
        gate = torch.bmm(xd, self.w_gate.to(dt))
        up = torch.bmm(xd, self.w_up.to(dt))
        out_e = torch.bmm(F.silu(gate) * up, self.w_down.to(dt))
        y = (combine.view(t, e * cap) @ out_e.float().view(e * cap, d)).to(dt)
        return y.view(b, s, d), aux + z, dispatch, combine


class MoEBlock(nn.Module):
    def __init__(self, cfg: MoEConfig):
        super().__init__()
        self.cfg = cfg
        hd, e = cfg.head_dim, cfg.n_embd
        self.attn_norm = RMSNorm(e, cfg.rms_eps, cfg.dtype)
        self.wq = Dense(e, cfg.n_head * hd, cfg.dtype)
        self.wk = Dense(e, cfg.n_kv_head * hd, cfg.dtype)
        self.wv = Dense(e, cfg.n_kv_head * hd, cfg.dtype)
        self.wo = Dense(cfg.n_head * hd, e, cfg.dtype)
        self.mlp_norm = RMSNorm(e, cfg.rms_eps, cfg.dtype)
        self.moe = MoEMLP(cfg)

    def forward(self, x, positions):
        """(x, router loss, dispatch, combine)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = qkv_heads(self, self.attn_norm(x), positions)
        attn = causal_attention(q, k, v, cfg.use_flash)
        attn = attn.transpose(1, 2).reshape(b, s, cfg.n_head * cfg.head_dim)
        x = x + self.wo(attn)
        y, aux, dispatch, combine = self.moe(self.mlp_norm(x))
        return x + y, aux, dispatch, combine


class MoE(nn.Module):
    """The MoE decoder with an untied head. `device` defaults to the card.

    Parameters are drawn on the model's device from a `torch.Generator`
    seeded with `seed`, unless `state` is given: a state dict on that device
    whose tensors become the parameters by reference (`params_from_jax`'s,
    on the CPU)."""

    def __init__(self, config: MoEConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0,
                 state: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        with torch.device("meta"):
            self.embed = nn.Parameter(torch.empty(config.vocab_size,
                                                  config.n_embd))
            self.layers = nn.ModuleList(MoEBlock(config)
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
        for name, p in list(self.named_parameters()):
            dt = (torch.float32 if name.endswith("router")
                  else self.config.param_dtype)
            init = torch.empty(p.shape, dtype=dt, device=dev)
            if name.endswith("norm.weight"):
                init.fill_(1.0)
            else:
                init.normal_(0.0, 0.02, generator=gen)
            module_name, _, leaf = name.rpartition(".")
            setattr(self.get_submodule(module_name), leaf,
                    nn.Parameter(init))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, input_ids, return_aux: bool = False,
                return_routing: bool = False):
        """Logits [b, s, vocab]; with `return_aux`, also the router losses
        summed over layers (float32 scalar); with `return_routing`, also
        each layer's (dispatch, combine). Returns logits alone, or the tuple
        (logits, aux?, routing?) of what was asked for."""
        cfg = self.config
        b, s = input_ids.shape
        x = self.embed.to(cfg.dtype)[input_ids]
        positions = torch.arange(s, device=input_ids.device)
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
        logits = self.lm_head(self.final_norm(x))
        out = ((logits,) + ((aux,) if return_aux else ())
               + ((routing,) if return_routing else ()))
        return out if len(out) > 1 else logits


def make_moe_train_step(model: MoE, optimizer: torch.optim.Optimizer):
    """`gpt2.make_train_step` with an objective that adds the router losses
    (load balance + z) to the next-token cross-entropy; the shown loss is
    the cross-entropy alone, so curves stay comparable."""

    def loss_fn(model, batch):
        logits, aux = model(batch["input_ids"], return_aux=True)
        ce = next_token_loss(logits, batch["labels"])
        return ce + aux, ce

    return make_train_step(model, optimizer, loss_fn=loss_fn)


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
