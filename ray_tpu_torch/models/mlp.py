"""MLP in PyTorch, computing what `ray_tpu/models/mlp.py` computes: the
smoke-test model of the trainers and Tune.

flax's `Dense` defaults are pinned: lecun-normal kernels (a normal
truncated at two standard deviations, scaled so the kernel's variance is
1 / fan_in) and zero biases, ReLU between layers. flax infers the input
width at init; here it is the first argument.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._torch_env import resolve_device

# Standard deviation of a unit normal truncated to [-2, 2]; flax divides
# by it so the truncated draw keeps the asked-for variance.
_TRUNC_STD = 0.87962566103423978


class MLP(nn.Module):
    """`features`: hidden widths, the last one the output width. Inputs are
    flattened to [batch, in_features]. `device` defaults to the card;
    parameters are drawn on the CPU from `torch.Generator().manual_seed(
    seed)` and moved there, so one seed gives the same weights on either
    device."""

    def __init__(self, in_features: int,
                 features: Sequence[int] = (128, 128, 10),
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        widths = (in_features, *features)
        self.dense = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(widths, widths[1:]))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in self.dense:
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
                layer.bias.zero_()
        self.to(device=dev, dtype=param_dtype)

    def forward(self, x):
        dt = self.dtype
        x = x.reshape(x.shape[0], -1).to(dt)
        for i, layer in enumerate(self.dense):
            x = F.linear(x, layer.weight.to(dt), layer.bias.to(dt))
            if i < len(self.dense) - 1:
                x = F.relu(x)
        return x


def classification_loss(logits, labels):
    """Mean softmax cross-entropy in float32; labels are integer class
    ids."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None]).squeeze(-1).mean()


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer
                    ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """step({"x", "y"}) -> loss (a 0-dim tensor, not synchronised);
    parameters and optimizer state are updated in place."""

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = classification_loss(model(batch["x"]), batch["y"])
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def params_from_jax(params_np: Dict) -> Dict[str, torch.Tensor]:
    """The port's state dict from the flax tree (unboxed to nested dicts of
    numpy arrays, with or without the top-level "params" key): `dense_i`
    kernels [in, out] become `dense.i.weight` [out, in]."""
    tree = params_np.get("params", params_np)
    out = {}
    for i in range(sum(1 for key in tree if key.startswith("dense_"))):
        layer = tree[f"dense_{i}"]
        out[f"dense.{i}.weight"] = torch.from_numpy(
            np.array(layer["kernel"], dtype=np.float32).T.copy())
        out[f"dense.{i}.bias"] = torch.from_numpy(
            np.array(layer["bias"], dtype=np.float32))
    return out
