"""Learner / LearnerGroup: the gradient-update half of the new stack.

The port of `ray_tpu/rllib/learner.py` (the reference's
`Learner.{compute_loss,update}`, `rllib/core/learner/learner.py:111,645,805`,
and `LearnerGroup`, `learner_group.py:61`). The learner's net and Adam state
live on its device, the card unless the config asks for the CPU; an update
is one loss, one backward, the global-norm clip and one Adam step, with no
host sync until the metrics are read. `update_many` copies a stacked epoch
to the device once and steps through it by index (the reference's
`lax.scan` over minibatches).

`num_learners > 1` forms one torch.distributed group over that many learner
actors, as `train/backend.py` forms one (NCCL on the card, gloo on the
CPU): each rank trains on its contiguous slice of the batch and the
gradients are averaged across ranks before the clip (the reference
dp-shards one jitted update over a mesh, `learner.py:345-521`).
"""

from __future__ import annotations

import copy
import logging
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._torch_env import granted_device
from ray_tpu_torch.rllib.rl_module import as_device_tensor

logger = logging.getLogger(__name__)


def _mean_over_ranks(values: torch.Tensor, world: int) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(values)
    return values / world


def global_mean_std(x: torch.Tensor, world: int):
    """Mean and (population) standard deviation of `x` over every rank's
    rows, so a statistic of the dp-split batch is the whole batch's."""
    if world <= 1:
        return x.mean(), x.std(correction=0)
    s = _mean_over_ranks(torch.stack([x.sum(), x.square().sum(),
                                      torch.tensor(float(x.numel()),
                                                   device=x.device)]), world)
    mean = s[0] / s[2]
    return mean, (s[1] / s[2] - mean.square()).clamp_min(0).sqrt()


class Learner:
    """Owns the net and the optimizer state; `update` is the hot path.

    `dp_world` is the number of learner processes in this learner's
    torch.distributed group (1 alone): their gradients, and the reported
    metrics, are averaged across them.
    """

    # Which batch axis data-parallelism splits: 0 for flat [B, ...]
    # batches (PPO/DQN); time-major learners ([T, n_envs, ...], IMPALA)
    # override to 1 so the V-trace loop over T stays on one rank.
    dp_axis: int = 0
    # Methods whose first argument is a batch to dp-split across learner
    # processes (subclasses with extra update entry points extend this —
    # DQN adds "update_dqn").
    batch_update_methods: tuple = ("update", "update_many")

    def __init__(self, module, config, seed: int = 0, device=None):
        self.module = module
        self.config = config
        self.device = granted_device(
            device if device is not None else getattr(config, "device", None),
            "learner", "give its LearnerGroup resources={'num_gpus': 1} "
            "(learner_resources)")
        self.net = module.build(self.device, seed)
        self._params = list(self.net.parameters())
        self.grad_clip = float(getattr(config, "grad_clip", 0.5))
        # optax.chain(clip_by_global_norm(grad_clip), adam(lr)): Adam's
        # defaults are optax's (b1 0.9, b2 0.999, eps 1e-8 outside the root).
        self.optimizer = torch.optim.Adam(
            self._params, lr=float(getattr(config, "lr", 3e-4)),
            betas=(0.9, 0.999), eps=1e-8)
        self.dp_world = 1

    # -- override point -------------------------------------------------------

    def compute_loss(self, net, batch: Dict[str, Any]):
        """Return (loss, metrics). Overridden per algorithm (PPO's)."""
        raise NotImplementedError

    # -- update ---------------------------------------------------------------

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: as_device_tensor(v, self.device) for k, v in batch.items()}

    def apply_gradients(self, loss: torch.Tensor) -> torch.Tensor:
        """Backward of `loss`, the mean over the group's ranks, optax's
        `clip_by_global_norm` (scale by c / norm only when norm >= c, no
        epsilon) and one Adam step. Returns the norm before the clip."""
        self.optimizer.zero_grad()
        loss.backward()
        # A parameter the loss does not reach (DQN's value head) keeps no
        # gradient: optax's zero gradient leaves it unchanged too.
        grads = [p.grad for p in self._params if p.grad is not None]
        if self.dp_world > 1:
            flat = _mean_over_ranks(torch.cat([g.reshape(-1) for g in grads]),
                                    self.dp_world)
            for g, part in zip(grads, torch.split(
                    flat, [g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        torch._foreach_mul_(grads, scale)
        self.optimizer.step()
        return norm

    def _step(self, batch: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        loss, metrics = self.compute_loss(self.net, batch)
        metrics = dict(metrics)
        metrics["grad_norm"] = self.apply_gradients(loss)
        metrics["total_loss"] = loss
        return {k: v.detach() for k, v in metrics.items()}

    def _report(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Device metrics to floats (one sync), averaged over the group."""
        keys = list(metrics)
        values = torch.stack([metrics[k].float() for k in keys])
        if self.dp_world > 1:
            values = _mean_over_ranks(values, self.dp_world)
        return dict(zip(keys, values.tolist()))

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        if not batch or len(next(iter(batch.values()))) == 0:
            return {}
        return self._report(self._step(self._to_device(batch)))

    def update_many(self, stacked: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Run one update per row of the leading minibatch axis: the epoch
        goes to the device in one copy, then each step indexes it. Reports
        epoch means, except KL, where the guard needs the END-of-epoch
        divergence (the mean is diluted by the first minibatch's near-zero
        KL and would fire the early stop too late)."""
        if not stacked:
            return {}
        epoch = self._to_device(stacked)
        n_mb = len(next(iter(epoch.values())))
        steps = [self._step({k: v[i] for k, v in epoch.items()})
                 for i in range(n_mb)]
        out = {k: torch.stack([s[k] for s in steps]).mean() for k in steps[0]}
        if "kl" in out:
            out["kl"] = steps[-1]["kl"]
        return self._report(out)

    def placement(self) -> Dict[str, Any]:
        """Where this learner runs: its process, the cards the runtime
        granted it and its parameters' device."""
        return {"pid": os.getpid(),
                "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": str(self._params[0].device)}

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The net's state dict as CPU copies (rollout workers are CPU
        processes: a CUDA tensor cannot be unpickled there)."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.net.state_dict().items()}

    def set_weights(self, weights: Dict[str, torch.Tensor]):
        self.net.load_state_dict(weights)

    def get_state(self) -> Dict[str, Any]:
        return {"params": self.get_weights(),
                "opt_state": _to_cpu(self.optimizer.state_dict())}

    def set_state(self, state: Dict[str, Any]):
        self.net.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def target_copy(net: torch.nn.Module) -> torch.nn.Module:
    """A frozen copy of `net` (APPO's and DQN's target networks)."""
    target = copy.deepcopy(net)
    target.requires_grad_(False)
    return target


def _actor_options(resources: Optional[Dict[str, float]]) -> Dict[str, Any]:
    """Actor options from a resource dict: "CPU"/"num_cpus" and
    "GPU"/"num_gpus" become the runtime's own options, anything else a
    custom resource."""
    opts: Dict[str, Any] = {}
    res = dict(resources or {})
    for keys, opt in ((("CPU", "num_cpus"), "num_cpus"),
                      (("GPU", "num_gpus"), "num_gpus")):
        for key in keys:
            if key in res:
                opts[opt] = res.pop(key)
    if res:
        opts["resources"] = res
    return opts


class LearnerGroup:
    """Local or remote learner execution (reference `learner_group.py:61`).

    mode="local": the learner lives in the calling process (drives the
    card it sees directly — the default for one-card training).
    mode="remote": the learner runs in a dedicated actor, with `resources`
    (`{"num_gpus": 1}` for the card), so rollout workers and the driver
    stay off the device.

    num_learners > 1 (either mode) runs that many learner actors in one
    torch.distributed group (reference `learner_group.py:114-126`, N DDP
    workers): each update splits the batch into one contiguous slice per
    rank and averages the gradients.
    """

    def __init__(self, learner_factory: Callable[..., Learner],
                 mode: str = "local",
                 resources: Optional[Dict[str, float]] = None,
                 num_learners: int = 1):
        self.mode = mode
        self.num_learners = max(1, int(num_learners))
        self._sharded_group = None
        self._learner = None
        self._actor = None
        if self.num_learners > 1:
            self._sharded_group = _ShardedLearnerGroup(
                learner_factory, self.num_learners, resources)
        elif mode == "local":
            self._learner = learner_factory()
        else:
            import ray_tpu_torch

            opts = _actor_options(resources)
            actor_cls = ray_tpu_torch.remote(_LearnerActor)
            self._actor = (actor_cls.options(**opts) if opts else actor_cls
                           ).remote(learner_factory)
            try:
                ray_tpu_torch.get(self._actor.ping.remote())
            except Exception:
                self.shutdown()
                raise

    def update(self, batch) -> Dict[str, float]:
        if self._learner is not None:
            return self._learner.update(batch)
        if self._sharded_group is not None:
            return self._sharded_group.update("update", batch)
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.update.remote(batch))

    def update_many(self, stacked) -> Dict[str, float]:
        if self._learner is not None:
            return self._learner.update_many(stacked)
        if self._sharded_group is not None:
            return self._sharded_group.update("update_many", stacked)
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.update_many.remote(stacked))

    def call(self, method: str, *args, **kwargs):
        """Dispatch an algorithm-specific learner method (DQN's update_dqn,
        sync_target, ...) through whichever mode this group runs in."""
        if self._learner is not None:
            return getattr(self._learner, method)(*args, **kwargs)
        if self._sharded_group is not None:
            if (method in self._sharded_group.batch_methods
                    and len(args) == 1 and not kwargs):
                # Batch-consuming updates split across the learner
                # processes like update()/update_many() — broadcasting
                # the full batch would duplicate work N times.
                return self._sharded_group.update(method, args[0])
            return self._sharded_group.call_all(method, *args, **kwargs)[0]
        import ray_tpu_torch

        return ray_tpu_torch.get(
            self._actor.call.remote(method, *args, **kwargs))

    def get_weights(self):
        if self._learner is not None:
            return self._learner.get_weights()
        if self._sharded_group is not None:
            return self._sharded_group.call_rank0("get_weights")
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.get_weights.remote())

    def get_state(self):
        if self._learner is not None:
            return self._learner.get_state()
        if self._sharded_group is not None:
            return self._sharded_group.call_rank0("get_state")
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.get_state.remote())

    def set_state(self, state):
        if self._learner is not None:
            self._learner.set_state(state)
        elif self._sharded_group is not None:
            self._sharded_group.call_all("set_state", state)
        else:
            import ray_tpu_torch

            ray_tpu_torch.get(self._actor.set_state.remote(state))

    def shutdown(self):
        if self._sharded_group is not None:
            self._sharded_group.shutdown()
        if self._actor is not None:
            import ray_tpu_torch

            try:
                ray_tpu_torch.kill(self._actor)
            except Exception:  # noqa: BLE001 — already gone
                pass


def make_learner_group(config, module, learner_cls) -> LearnerGroup:
    """An algorithm's LearnerGroup from its config (`learner_mode`,
    `learner_resources`, `num_learners`; the learner's device is
    `config.device`)."""
    return LearnerGroup(
        lambda: learner_cls(module, config, seed=config.seed),
        mode=config.learner_mode, resources=config.learner_resources,
        num_learners=config.num_learners)


class _ShardedLearnerGroup:
    """num_learners actors forming one data-parallel update.

    Each actor builds the same learner (same seed), the actors join one
    torch.distributed group (NCCL when the learners hold the card, gloo on
    the CPU; rank 0's weights are broadcast), and every update each actor
    receives only its slice of the batch; gradients meet in an all-reduce
    (mean) before the clip.
    """

    def __init__(self, learner_factory, num_learners: int,
                 resources: Optional[Dict[str, float]] = None):
        import ray_tpu_torch

        self.n = num_learners
        opts = _actor_options(resources)
        actor_cls = ray_tpu_torch.remote(_ShardedLearnerWorker)
        if opts:
            actor_cls = actor_cls.options(**opts)
        self.workers = [actor_cls.remote(learner_factory)
                        for _ in range(num_learners)]
        try:
            backends = ray_tpu_torch.get(
                [w.backend.remote() for w in self.workers])
            host, port = ray_tpu_torch.get(
                self.workers[0].get_free_address.remote())
            logger.info("forming learner process group: %d procs (%s) via "
                        "%s:%d", num_learners, backends[0], host, port)
            ray_tpu_torch.get([
                w.setup_group.remote(backends[0], host, port, rank,
                                     num_learners)
                for rank, w in enumerate(self.workers)])
            self.dp_axis, self.batch_methods = ray_tpu_torch.get(
                self.workers[0].get_split_spec.remote())
        except Exception:
            # Formation failed: don't leak the spawned actors or their
            # resource reservations.
            self.shutdown()
            raise

    @staticmethod
    def _split(batch: Dict[str, np.ndarray], n: int, axis: int
               ) -> List[Dict[str, np.ndarray]]:
        """Trim the batch axis to a multiple of n processes and cut it
        into n equal contiguous slices (one per learner process)."""
        out: List[Dict[str, np.ndarray]] = [dict() for _ in range(n)]
        for k, v in batch.items():
            v = np.asarray(v)
            per = v.shape[axis] // n
            for i in range(n):
                sl = [slice(None)] * v.ndim
                sl[axis] = slice(i * per, (i + 1) * per)
                out[i][k] = v[tuple(sl)]
        return out

    def update(self, method: str, batch) -> Dict[str, float]:
        import ray_tpu_torch

        axis = self.dp_axis + (1 if method == "update_many" else 0)
        orig_rows = min(np.asarray(v).shape[axis] for v in batch.values())
        slices = self._split(batch, self.n, axis)
        if any(v.shape[axis] == 0 for v in slices[0].values()):
            if method in ("update", "update_many"):
                return {}  # clean no-op, like the local drop-last path
            # Methods returning (metrics, per-row aux) cannot no-op
            # without breaking their callers' unpacking — misconfig.
            raise ValueError(
                f"batch of {orig_rows} rows is too small to split across "
                f"{self.n} learners for {method}; raise train_batch_size "
                f"or lower num_learners")
        refs = [w.update_slice.remote(method, s)
                for w, s in zip(self.workers, slices)]
        results = ray_tpu_torch.get(refs)
        if isinstance(results[0], tuple):
            # (metrics, per-row aux) shape — e.g. DQN's |TD| priorities:
            # metrics are averaged over the group, the aux rows concatenate
            # back in rank order (slices were contiguous). Drop-last
            # trimming may have shed tail rows; re-pad so callers indexing
            # with the ORIGINAL batch's indices (replay priority updates)
            # line up.
            metrics = results[0][0]
            aux = np.concatenate([np.asarray(r[1]) for r in results])
            if len(aux) < orig_rows:
                fill = float(aux.mean()) if len(aux) else 1.0
                aux = np.concatenate(
                    [aux, np.full(orig_rows - len(aux), fill, aux.dtype)])
            return metrics, aux
        return results[0]

    def call_all(self, name: str, *args, **kwargs) -> List[Any]:
        import ray_tpu_torch

        return ray_tpu_torch.get([w.call.remote(name, *args, **kwargs)
                                  for w in self.workers])

    def call_rank0(self, name: str, *args, **kwargs):
        import ray_tpu_torch

        return ray_tpu_torch.get(
            self.workers[0].call.remote(name, *args, **kwargs))

    def shutdown(self):
        import ray_tpu_torch

        try:
            ray_tpu_torch.get([w.teardown.remote() for w in self.workers],
                              timeout=10)
        except Exception:  # noqa: BLE001 — workers may already be gone
            pass
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass


class _ShardedLearnerWorker:
    """One process of a data-parallel learner group (runs inside an
    actor)."""

    def __init__(self, learner_factory):
        self._learner: Learner = learner_factory()

    def backend(self) -> str:
        return "nccl" if self._learner.device.type == "cuda" else "gloo"

    def get_free_address(self):
        from ray_tpu_torch.parallel.distributed import get_address_and_port

        return get_address_and_port()

    def setup_group(self, backend: str, host: str, port: int, rank: int,
                    world: int):
        import torch.distributed as dist

        from ray_tpu_torch.train.backend import _setup_torch_process_group

        _setup_torch_process_group(backend, host, port, rank, world, 120)
        with torch.no_grad():
            for t in self._learner.net.state_dict().values():
                dist.broadcast(t, 0)
        self._learner.dp_world = world
        return True

    def get_split_spec(self):
        return self._learner.dp_axis, tuple(self._learner.batch_update_methods)

    def update_slice(self, method: str, local_batch):
        return getattr(self._learner, method)(local_batch)

    def call(self, name: str, *args, **kwargs):
        return getattr(self._learner, name)(*args, **kwargs)

    def teardown(self):
        from ray_tpu_torch.train.backend import _teardown_torch_process_group

        return _teardown_torch_process_group()


class _LearnerActor:
    def __init__(self, learner_factory):
        self._learner = learner_factory()

    def ping(self):
        return True

    def call(self, method: str, *args, **kwargs):
        """Algorithm-specific learner methods (e.g. DQN's update_dqn /
        sync_target) without a dedicated RPC per method."""
        return getattr(self._learner, method)(*args, **kwargs)

    def update(self, batch):
        return self._learner.update(batch)

    def update_many(self, stacked):
        return self._learner.update_many(stacked)

    def get_weights(self):
        return self._learner.get_weights()

    def get_state(self):
        return self._learner.get_state()

    def set_state(self, state):
        self._learner.set_state(state)
