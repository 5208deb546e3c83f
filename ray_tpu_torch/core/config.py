"""Global configuration flags of the port's inference engine.

Counterpart of `ray_tpu/core/config.py`, holding only the four flags the
engine reads when its `EngineConfig` leaves them at None. The table, the
`RAY_TPU_<NAME>` environment overrides and the resolution rules are the
reference's: an explicit assignment (`GLOBAL_CONFIG.flag = x`) wins, else
the environment, else the default; environment reads are memoized until
`refresh()`. The rest of the reference's table belongs to the control plane
and is ported with it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_"


@dataclass
class _Flag:
    name: str
    type: Callable
    default: Any
    doc: str


_FLAG_TABLE: Dict[str, _Flag] = {}


def _flag(name: str, type_: Callable, default: Any, doc: str = ""):
    _FLAG_TABLE[name] = _Flag(name, type_, default, doc)


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "on")


_flag("prefix_cache_enabled", _parse_bool, True,
      "Inference engine radix prefix cache: finished sequences donate "
      "their full-block KV prefixes to a radix tree and new requests "
      "skip prefill for the longest cached match (continuous scheduling "
      "only; cached blocks are reclaimed LRU-by-leaf under arena "
      "pressure before any live sequence is preempted)")
_flag("spec_decode_draft_len", int, 0,
      "Speculative decoding draft length k: each decode round proposes "
      "k tokens with the draft model and verifies k+1 with the target "
      "in one fixed-shape program (greedy verify — output is identical "
      "to plain decoding regardless of draft quality). 0 disables")
_flag("slo_default_class", str, "interactive",
      "SLO class for requests that do not name one: 'interactive' "
      "(admission/prefill priority, preferred to survive preemption) or "
      "'batch' (bulk traffic, first preemption victim)")
_flag("slo_interactive_reserved_slots", int, 0,
      "Batch slots the continuous scheduler holds open for "
      "interactive-class admissions: batch-class requests are only "
      "admitted while more than this many slots stay free, so a bulk "
      "flood cannot occupy the whole batch ahead of an interactive "
      "arrival. 0 disables; capped at batch_slots - 1")


class RayTpuConfig:
    """Process-wide config instance; values resolved lazily from env.

    Explicit assignment lands in `_overrides` and always wins; env-derived
    values land in `_cache`, which `refresh()` drops."""

    def __init__(self):
        object.__setattr__(self, "_overrides", {})
        object.__setattr__(self, "_cache", {})

    def __setattr__(self, name: str, value) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self._overrides[name] = value

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        overrides = self._overrides
        if name in overrides:
            return overrides[name]
        cache = self._cache
        if name in cache:
            return cache[name]
        flag = _FLAG_TABLE.get(name)
        if flag is None:
            raise AttributeError(f"Unknown config flag: {name}")
        env = os.environ.get(_ENV_PREFIX + name.upper())
        if env is not None:
            value = _parse_bool(env) if flag.type is bool else flag.type(env)
        else:
            value = flag.default
        cache[name] = value
        return value

    def refresh(self):
        """Drop env-derived memoized values (explicit sets persist)."""
        self._cache.clear()

    def dump(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in _FLAG_TABLE}


GLOBAL_CONFIG = RayTpuConfig()
