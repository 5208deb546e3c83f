"""RLModule: the neural-network abstraction of the new RLlib stack, in torch.

The port of `ray_tpu/rllib/rl_module.py` (the reference's
`RLModule.forward_{inference,exploration,train}`,
`rllib/core/rl_module/rl_module.py:215,383-427`). A module is a small
picklable spec: `build(device, seed)` makes its `nn.Module` (the "net"),
and the forward functions take that net, so the Learner owns one net on
its card and each rollout worker one on its CPU, refreshed from the
learner's state dict (`Learner.get_weights`).

Layouts follow torch: `Linear` weights are [out, in] and `Conv2d` weights
[out, in, kh, kw]. Image observations arrive [B, H, W(, C)] uint8, go to
the device as uint8 and are scaled by 1/255 there. The convolution output
is permuted back to [B, h, w, C] before the flatten, so the torso's input
order is the reference's NHWC one and `params_from_jax` carries its kernel
with a plain transpose.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._torch_env import resolve_device


@dataclass
class SpecDict:
    obs_dim: int
    n_actions: int
    # Image modules need the full shape ([H, W] or [H, W, C]); flat modules
    # derive it from obs_dim.
    obs_shape: Tuple[int, ...] = ()

    def shape(self) -> Tuple[int, ...]:
        return tuple(self.obs_shape) if self.obs_shape else (self.obs_dim,)


def _orthogonal(layer: nn.Module, gain: float, gen: torch.Generator):
    """flax's `orthogonal(scale)` kernels and zero biases, drawn from
    `gen` (on the CPU)."""
    nn.init.orthogonal_(layer.weight, gain, generator=gen)
    nn.init.zeros_(layer.bias)


class _PolicyValueNet(nn.Module):
    """Shared torso -> (logits, value) heads (reference Catalog's default
    fcnet encoder + pi/vf heads)."""

    def __init__(self, obs_dim: int, hidden: Sequence[int], n_actions: int):
        super().__init__()
        widths = (obs_dim, *hidden)
        self.torso = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(widths, widths[1:]))
        self.pi = nn.Linear(widths[-1], n_actions)
        self.vf = nn.Linear(widths[-1], 1)

    def init_weights(self, gen: torch.Generator):
        for layer in self.torso:
            _orthogonal(layer, np.sqrt(2), gen)
        _orthogonal(self.pi, 0.01, gen)
        _orthogonal(self.vf, 1.0, gen)

    def forward(self, obs):
        x = obs.float()
        for layer in self.torso:
            x = torch.tanh(layer(x))
        return self.pi(x), self.vf(x)[..., 0]


class _ConvPolicyValueNet(nn.Module):
    """Nature-CNN torso -> (logits, value) heads for image observations.

    Observations arrive uint8 (4x less sample-batch bandwidth than float32)
    and are normalized to [0, 1] on the device; float envs are already
    scaled. Convolutions run on the NHWC tensor viewed as NCHW (a
    channels-last layout), and the flatten reads the [B, h, w, C] order of
    the reference's torso kernel."""

    def __init__(self, obs_shape: Tuple[int, ...], n_actions: int,
                 channels: Sequence[int] = (32, 64, 64),
                 kernels: Sequence[int] = (8, 4, 3),
                 strides: Sequence[int] = (4, 2, 1), dense: int = 512):
        super().__init__()
        h, w = obs_shape[:2]
        c_in = obs_shape[2] if len(obs_shape) == 3 else 1
        convs = []
        for c, k, s in zip(channels, kernels, strides):
            convs.append(nn.Conv2d(c_in, c, k, stride=s))
            c_in, h, w = c, (h - k) // s + 1, (w - k) // s + 1
        if h < 1 or w < 1:
            raise ValueError(f"observations {obs_shape} are too small for "
                             f"kernels {tuple(kernels)}")
        self.conv = nn.ModuleList(convs)
        self.torso = nn.Linear(c_in * h * w, dense)
        self.pi = nn.Linear(dense, n_actions)
        self.vf = nn.Linear(dense, 1)

    def init_weights(self, gen: torch.Generator):
        for layer in (*self.conv, self.torso):
            _orthogonal(layer, np.sqrt(2), gen)
        _orthogonal(self.pi, 0.01, gen)
        _orthogonal(self.vf, 1.0, gen)

    def forward(self, obs):
        x = obs.float()
        if not obs.dtype.is_floating_point:
            x = x / 255.0  # uint8 pixels; float envs are already scaled
        if x.ndim == 3:  # [B, H, W] -> single channel
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)
        for conv in self.conv:
            x = F.relu(conv(x))
        x = F.relu(self.torso(x.permute(0, 2, 3, 1).flatten(1)))
        return self.pi(x), self.vf(x)[..., 0]


def conv_spec_for(height: int) -> Dict[str, Any]:
    """Conv-stack sizing shared by every vision module (PPO's
    ConvPolicyModule, DQN's QModule): nature-DQN filters need >= 40 px
    frames; smaller synthetic envs get a shallower stack."""
    if height >= 40:
        return dict(channels=(32, 64, 64), kernels=(8, 4, 3),
                    strides=(4, 2, 1))
    return dict(channels=(16, 32), kernels=(4, 3), strides=(2, 1))


def net_device(net: nn.Module) -> torch.device:
    return next(net.parameters()).device


def as_device_tensor(x, device: torch.device) -> torch.Tensor:
    """A host batch column (numpy or tensor) on `device`, keeping its dtype
    (uint8 frames go to the card as uint8). A batch that came through the
    object store is a read-only view; it is only read here, so torch's
    warning about such arrays is silenced rather than paid with a copy."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable", UserWarning)
        return torch.as_tensor(x).to(device, non_blocking=True)


def make_generator(device: Union[str, torch.device], seed: int
                   ) -> torch.Generator:
    """The sampling stream of a net on `device`, seeded."""
    return torch.Generator(device=device).manual_seed(seed)


def params_from_jax(params_np: Dict) -> Dict[str, torch.Tensor]:
    """The port's state dict of a policy/value net from the reference's
    flax tree (nested dicts of numpy arrays, with or without the top-level
    "params" key): `torso_i` Dense kernels [in, out] become `torso.i.weight`
    [out, in] (MLP), `conv_i` kernels [kh, kw, in, out] become `conv.i.weight`
    [out, in, kh, kw], and the CNN's `torso` Dense is transposed (the net
    flattens in the reference's (h, w, C) order)."""
    tree = params_np.get("params", params_np)

    def t(a, *perm):
        a = np.asarray(a, dtype=np.float32)
        return torch.from_numpy(np.array(a.transpose(*perm) if perm else a,
                                         order="C"))

    out = {}
    for name, layer in tree.items():
        if name.startswith("conv_"):
            key, w = f"conv.{name[5:]}", t(layer["kernel"], 3, 2, 0, 1)
        elif name.startswith("torso_"):
            key, w = f"torso.{name[6:]}", t(layer["kernel"], 1, 0)
        else:  # torso (CNN), pi, vf
            key, w = name, t(layer["kernel"], 1, 0)
        out[f"{key}.weight"] = w
        out[f"{key}.bias"] = t(layer["bias"])
    return out


class RLModule:
    """Base class: a picklable spec that builds its net and defines the
    forward semantics over it."""

    def make_net(self) -> nn.Module:
        raise NotImplementedError

    def build(self, device: Optional[Union[str, torch.device]] = None,
              seed: int = 0) -> nn.Module:
        """The net on `device` (the card unless "cpu" is asked for). Its
        weights are drawn on the CPU from `seed` and moved, so one seed
        gives the same weights on either device."""
        dev = resolve_device(device)
        net = self.make_net()
        with torch.no_grad():
            net.init_weights(torch.Generator().manual_seed(seed))
        return net.to(dev)

    def forward_train(self, net, batch: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def forward_exploration(self, net, obs, gen: torch.Generator
                            ) -> Dict[str, Any]:
        raise NotImplementedError

    def forward_inference(self, net, obs) -> Dict[str, Any]:
        raise NotImplementedError


def _gumbel_argmax(logits, gen: torch.Generator):
    """A categorical draw from `logits` (the Gumbel-max trick, as
    `jax.random.categorical`; another stream than JAX's)."""
    u = torch.rand(logits.shape, generator=gen, device=gen.device)
    u = u.to(logits.device).clamp_min(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


class DiscretePolicyModule(RLModule):
    """Categorical-action policy+value module (PPO's default)."""

    def __init__(self, spec: SpecDict, hidden: Sequence[int] = (64, 64)):
        self.spec = spec
        self.hidden = tuple(hidden)

    def make_net(self) -> nn.Module:
        return _PolicyValueNet(self.spec.obs_dim, self.hidden,
                               self.spec.n_actions)

    def forward_train(self, net, batch):
        logits, value = net(batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(
            -1, batch["actions"][..., None].long())[..., 0]
        entropy = -(logp_all.exp() * logp_all).sum(dim=-1)
        return {"logits": logits, "vf": value, "logp": logp,
                "entropy": entropy}

    @torch.no_grad()
    def forward_exploration(self, net, obs, gen):
        logits, value = net(as_device_tensor(obs, net_device(net)))
        actions = _gumbel_argmax(logits, gen)
        logp = torch.log_softmax(logits, dim=-1).gather(
            -1, actions[..., None])[..., 0]
        return {"actions": actions, "logp": logp, "vf": value}

    @torch.no_grad()
    def forward_inference(self, net, obs):
        logits, value = net(as_device_tensor(obs, net_device(net)))
        return {"actions": torch.argmax(logits, dim=-1), "vf": value}


class ConvPolicyModule(DiscretePolicyModule):
    """CNN policy+value module for image observations (the Atari module —
    reference Catalog's vision encoder path).

    Architecture auto-sizes to the input: nature-DQN filters for >= 40 px
    frames, a shallower stack for small synthetic envs.
    """

    def __init__(self, spec: SpecDict, dense: int = 512):
        self.spec = spec
        self.dense = dense
        if len(spec.shape()) not in (2, 3):
            raise ValueError(
                f"ConvPolicyModule needs [H, W] or [H, W, C] observations, "
                f"got shape {spec.shape()} — a color env plus FrameStack "
                f"yields rank 4; add GrayscaleResize before the stack")

    def make_net(self) -> nn.Module:
        return _ConvPolicyValueNet(self.spec.shape(), self.spec.n_actions,
                                   dense=self.dense,
                                   **conv_spec_for(self.spec.shape()[0]))


def build_module(spec: SpecDict, hidden: Sequence[int] = (64, 64)) -> RLModule:
    """Default module for an env spec: CNN for image observations (rank >=
    2), MLP otherwise (reference Catalog dispatch)."""
    if len(spec.shape()) >= 2:
        return ConvPolicyModule(spec)
    return DiscretePolicyModule(spec, hidden=hidden)


def build_module_from_env_spec(env_spec: Dict[str, Any],
                               hidden: Sequence[int] = (64, 64)) -> RLModule:
    """From a RolloutWorker.env_spec() dict — the single place algorithms
    construct their learner module, so it can never drift from the module
    the rollout workers build."""
    return build_module(
        SpecDict(env_spec["obs_dim"], env_spec["n_actions"],
                 tuple(env_spec.get("obs_shape", ()))),
        hidden=hidden)
