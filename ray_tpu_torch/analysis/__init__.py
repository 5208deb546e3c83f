"""raylint for the port: the framework's static checker over ray_tpu_torch.

The port's copy of `ray_tpu/analysis/`.  Runtime witnesses
(:mod:`ray_tpu_torch.util.lock_witness`) only see interleavings that
tests execute; this package is the *static* half: a small rule engine
that parses the package with :mod:`ast` and checks the ownership and
concurrency disciplines the codebase depends on — DEFERRED replies must
always be completed, raw store segments must be freed on every path,
nothing blocking may run under a control-plane lock, broad excepts must
not silently eat cancellation, threads must be daemonized or joined, and
lock acquisition order must be acyclic (RL001-RL019, the reference's
rules keyed on this package).  The torch surface gets its own
dataflow-powered family (RL020-RL024 in
:mod:`ray_tpu_torch.analysis.torchrules`, on the device/host/static
provenance layer of :mod:`ray_tpu_torch.analysis.dataflow`).

The rule catalog (``python -m ray_tpu_torch.analysis --list-rules``):

===== ============================ =======================================
RL001 deferred-reply-leak          DEFERRED replies always completed
RL002 blocking-under-lock          nothing blocking under a control lock
RL003 raw-buffer-leak              put_raw segments freed on every path
RL004 swallowed-exception          broad excepts log or re-raise
RL005 thread-leak                  threads daemonized or joined
RL007 static-lock-order            lock acquisition graph is acyclic
RL008 span-leak                    tracing spans always end()ed
RL009 gang-without-death-hook      gangs abort cleanly, handle death
RL010 retry-without-deadline       poll loops carry a deadline or bound
RL011 unbounded-keyed-state        per-key dicts have an eviction path
RL012 lease-cache-invalidation     address caches drop dead workers
RL013 unbounded-block-buffer       data-plane buffers are bounded
RL014 rpc-contract                 every call has a registered endpoint
RL015 config-knob-drift            knobs declared, read and documented
RL016 loop-confined-escape         loop-confined state stays on the loop
RL017 deferred-reply-completeness  RL001 one call hop deep
RL018 job-scoped-state             job-keyed state dies with the job
RL019 driver-materialization       drivers never collect whole datasets
RL020 device-value-control-flow    no Python branch/coercion on a device
                                   tensor in per-step code
RL021 host-sync-in-hot-loop        no device->host sync inside a loop of
                                   per-step code
RL022 use-after-inplace            no view read across an in-place write
                                   to its buffer
RL023 sharding-axis-hygiene        logical and mesh axes resolve to
                                   declared mesh axes
RL024 cuda-before-fork             no CUDA before a fork, nor at import
                                   of a module the forge preimports
===== ============================ =======================================

The ids RL020-RL024 stand for the hazards the reference's JAX rules
guard, as far as eager PyTorch has them.  Without a trace, RL020 keeps
only the device-value control flow of the reference's retrace hazard
(no retrace, no static_argnums feedback, no jit per call); RL023 has no
trailing-``None`` check (DTensor placements carry no jit cache key);
RL024 replaces the jit-closure capture, which eager code does not have,
by the CUDA-before-fork hazard of the forge.  RL006 stays retired.

Usage::

    python -m ray_tpu_torch.analysis [paths] [--json] [--rules RL001,RL002]

Findings print as ``path:line: RULE-ID message`` and the process exits
non-zero when any unsuppressed finding remains.  Individual lines are
suppressed with a trailing ``# raylint: disable=RL002`` comment (comma
lists and ``all`` accepted; the comment may also sit on the line directly
above); a whole file opts out of a rule with ``# raylint:
disable-file=RL004`` in its first ten lines.  The incremental cache
lives in ``.raylint_torch_cache/``, apart from the JAX package's.
"""

from ray_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    PROJECT_RULES,
    RULES,
    lint_paths,
    lint_paths_full,
    project_rule,
    rule,
)
from ray_tpu_torch.analysis import rules as _rules  # noqa: F401  (registers rules)
from ray_tpu_torch.analysis import project as _project  # noqa: F401  (RL014-016)
from ray_tpu_torch.analysis import torchrules as _torchrules  # noqa: F401  (RL020-024)

__all__ = ["Finding", "RULES", "PROJECT_RULES", "lint_paths",
           "lint_paths_full", "rule", "project_rule"]
