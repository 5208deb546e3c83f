"""ray_tpu_torch.chaos — deterministic fault injection + bounded-recovery tools.

The counterpart of `ray_tpu.chaos`. The chaos plane has three parts:

- **Plan**: `ChaosSchedule` — a seeded, reproducible event list; the same
  seed always produces the same faults at the same offsets.
- **Fire**: `ChaosRunner` drives pluggable `injectors` (node kill, GCS
  kill/restart, worker/forge kill, RPC-level drop/delay/error faults)
  against a `cluster_utils.Cluster`, measuring a per-fault
  detect→recovered MTTR under a hard recovery deadline.
- **Prove**: `HangWatchdog` (zero parked futures past the deadline) and
  `TransitionWatch` (state-machine transitions fail loudly instead of
  wedging) turn "it didn't crash" into "recovery was bounded".

Heavy submodules (injectors/runner pull in cluster machinery) load
lazily so production code importing only the deadline/watchdog pieces
stays light.
"""

from __future__ import annotations

_LAZY = {
    "ChaosEvent": "ray_tpu_torch.chaos.schedule",
    "ChaosSchedule": "ray_tpu_torch.chaos.schedule",
    "single_event_schedule": "ray_tpu_torch.chaos.schedule",
    "HangWatchdog": "ray_tpu_torch.chaos.watchdog",
    "HangDetected": "ray_tpu_torch.chaos.watchdog",
    "TransitionWatch": "ray_tpu_torch.chaos.deadline",
    "StuckTransitionError": "ray_tpu_torch.chaos.deadline",
    "Injector": "ray_tpu_torch.chaos.injectors",
    "NodeKillInjector": "ray_tpu_torch.chaos.injectors",
    "GcsRestartInjector": "ray_tpu_torch.chaos.injectors",
    "WorkerKillInjector": "ray_tpu_torch.chaos.injectors",
    "ForgeKillInjector": "ray_tpu_torch.chaos.injectors",
    "RpcFaultInjector": "ray_tpu_torch.chaos.injectors",
    "ChaosRunner": "ray_tpu_torch.chaos.runner",
    "ChaosRecoveryError": "ray_tpu_torch.chaos.runner",
    "FaultRecord": "ray_tpu_torch.chaos.runner",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module 'ray_tpu_torch.chaos' has no attribute "
                             f"{name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)
