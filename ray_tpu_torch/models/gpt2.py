"""GPT-2 in PyTorch, computing what `ray_tpu/models/gpt2.py` computes.

bfloat16 compute on float32 parameters. flax's defaults are pinned:
LayerNorm eps 1e-6 with its statistics in float32, the tanh GELU, normal(0.02)
init for dense kernels and `wte`, normal(0.01) for `wpe`, zero biases. The
output head is tied to `wte`. Attention goes through the flash kernels
(`ray_tpu_torch.ops.attention.flash_attention`). With `remat`, each block
runs under `torch.utils.checkpoint` (the counterpart of `nn.remat(Block)`):
its activations are dropped after the forward and recomputed in the
backward, flash forward included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._torch_env import resolve_device
from ray_tpu_torch.ops.attention import flash_attention, mha_reference


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
    use_ring: bool = False           # sequence parallelism: a later slice
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
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class Dense(nn.Linear):
    """flax Dense: weight and bias cast to the input's (compute) dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Block(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
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
        cfg = self.config
        b, s, e = x.shape
        qkv = self.c_attn(self.ln_1(x))
        # [b, s, 3, heads, d] -> three [b, heads, s, d]; the columns stay in
        # [q | k | v] order, head-major, as in the flax model.
        q, k, v = qkv.view(b, s, 3, cfg.n_head, e // cfg.n_head).permute(
            2, 0, 3, 1, 4).unbind(0)
        if cfg.use_flash:
            attn = flash_attention(q, k, v, True)
        else:
            attn = mha_reference(q, k, v, causal=True)
        attn = attn.transpose(1, 2).reshape(b, s, e)
        x = x + self._dropout(self.c_proj(attn), deterministic)
        h = self.mlp_proj(F.gelu(self.c_fc(self.ln_2(x)), approximate="tanh"))
        return x + self._dropout(h, deterministic)


class GPT2(nn.Module):
    """GPT-2 with a tied head. `device` defaults to the card; parameters are
    drawn on the CPU from `torch.Generator().manual_seed(seed)` and moved
    there, so one seed gives the same weights on either device."""

    def __init__(self, config: GPT2Config,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        if config.use_ring:
            raise NotImplementedError(
                "use_ring: sequence parallelism is the ROADMAP's multi-axis "
                "parallelism item, not yet ported")
        dev = resolve_device(device)
        self.config = config
        self.wte = nn.Parameter(torch.empty(config.vocab_size, config.n_embd))
        self.wpe = nn.Parameter(torch.empty(config.n_positions, config.n_embd))
        self.h = nn.ModuleList(Block(config) for _ in range(config.n_layer))
        self.ln_f = LayerNorm(config.n_embd)
        self._init_weights(seed)
        self.to(device=dev, dtype=config.param_dtype)

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
        cfg = self.config
        s = input_ids.shape[1]
        wte = self.wte.to(cfg.dtype)
        x = wte[input_ids] + self.wpe.to(cfg.dtype)[None, :s]
        for block in self.h:
            if cfg.remat:
                # Dropout draws from the global generators, which the
                # checkpoint restores for the recompute: the same masks.
                x = checkpoint(block, x, deterministic, use_reentrant=False)
            else:
                x = block(x, deterministic)
        x = self.ln_f(x)
        return torch.matmul(x, wte.t())  # tied head: einsum("bse,ve->bsv")


# --------------------------------------------------------------------------- #
# Weights from the flax tree, loss, train and eval steps
# --------------------------------------------------------------------------- #


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
                    loss_fn: Optional[Callable] = None
                    ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """step(batch) -> the shown loss (a 0-dim tensor, not synchronised).

    `loss_fn(model, batch) -> (objective, shown)` sets the training
    objective (MoE adds its router losses to the cross-entropy); the step
    descends the objective and returns the shown loss. The default is
    next-token cross-entropy for both. Parameters and optimizer state are
    updated in place, the counterpart of the JAX step's donate_argnums=(0,
    1): no second copy of either is made."""
    if loss_fn is None:
        def loss_fn(model, batch):
            ce = next_token_loss(model(batch["input_ids"]), batch["labels"])
            return ce, ce

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        objective, shown = loss_fn(model, batch)
        objective.backward()
        optimizer.step()
        return shown.detach()

    return step


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
