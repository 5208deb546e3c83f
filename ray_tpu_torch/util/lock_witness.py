"""Lock-order witness: a TSAN-style sanitizer for the threaded control
plane.

The reference ships TSAN/ASAN build configs for its C++ core
(`bazel --config=tsan`, `src/ray/...` race tests); this runtime's control
plane is Python threads + locks, where the classic failure mode is not a
data race (the GIL serializes byte-code) but a LOCK-ORDER INVERSION:
thread 1 takes A then B, thread 2 takes B then A, and the cluster hangs
under load timing that no unit test reproduces.

`install()` monkeypatches `threading.Lock`/`RLock` so every lock created
afterwards is a witness proxy. Each acquire records the per-thread held
stack and adds edges held→acquiring to a global lock-order graph; the
first edge that closes a cycle is reported with the creation and
acquisition sites of every lock on the cycle. Detection is ORDER-based:
it fires on the inversion pattern even when the interleaving never
actually deadlocks, which is what makes it useful in tests.

Also provides a hang watchdog: acquires that block longer than
``watchdog_s`` dump all thread stacks to stderr once (the moral
equivalent of the reference's blocked-finisher checks).

The port's counterpart of `ray_tpu/util/lock_witness.py`. Usage
(tests/test_torch_lock_witness.py drives both):

    from ray_tpu_torch.util import lock_witness
    lock_witness.install()          # BEFORE creating the locks of interest
    ... run workload ...
    assert lock_witness.report().cycles == []

Scope notes: locks created before install() (module-level registries) are
not instrumented; `threading.Condition` instruments transparently when
handed an instrumented (R)Lock. Overhead is a dict update per acquire —
fine for tests, not meant for production hot paths.
"""

from __future__ import annotations

import faulthandler
import sys
import threading
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

_real_lock = threading.Lock
_real_rlock = threading.RLock

_state_lock = _real_lock()
_installed = False
_watchdog_s: Optional[float] = None

# Lock-order graph over live witness locks: edges id(a) -> set of id(b)
# observed acquired while a was held. Sites kept for reporting.
_edges: Dict[int, Set[int]] = {}
_edge_sites: Dict[Tuple[int, int], str] = {}
_lock_sites: Dict[int, str] = {}
_cycles: List[str] = []
_held = threading.local()


@dataclass
class Report:
    cycles: List[str] = field(default_factory=list)
    locks_tracked: int = 0
    edges: int = 0


def _caller_site(depth: int = 2) -> str:
    frame = sys._getframe(depth)
    # Skip witness frames so the site names user code.
    while frame is not None and __file__ in (frame.f_code.co_filename or ""):
        frame = frame.f_back
    if frame is None:
        return "<unknown>"
    return f"{frame.f_code.co_filename}:{frame.f_lineno}"


def _held_stack() -> list:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def _find_cycle(start: int, target: int) -> Optional[List[int]]:
    """Path target ->* start in the edge graph (so adding start->target
    closes a cycle)."""
    path: List[int] = [target]
    seen = {target}

    def dfs(node: int) -> Optional[List[int]]:
        if node == start:
            return path[:]
        for nxt in _edges.get(node, ()):
            if nxt in seen:
                continue
            seen.add(nxt)
            path.append(nxt)
            found = dfs(nxt)
            if found is not None:
                return found
            path.pop()
        return None

    return dfs(target)


def _record_acquire(lock_id: int):
    stack = _held_stack()
    if not stack:
        return
    me = threading.get_ident()
    with _state_lock:
        for held_id in stack:
            if held_id == lock_id:
                continue
            edge = (held_id, lock_id)
            if lock_id in _edges.setdefault(held_id, set()):
                continue
            # New edge: does the reverse path exist? (cycle check BEFORE
            # inserting, so the report shows the closing edge.)
            cycle = _find_cycle(held_id, lock_id)
            _edges[held_id].add(lock_id)
            _edge_sites[edge] = _caller_site(3)
            if cycle is not None:
                names = " -> ".join(
                    _lock_sites.get(l, "?") for l in [held_id] + cycle)
                msg = (f"lock-order inversion (thread {me}): "
                       f"{names} -> back to first; closing acquisition at "
                       f"{_edge_sites[edge]}")
                _cycles.append(msg)


_wid_counter = iter(range(1, 1 << 62))


class _WitnessBase:
    def __init__(self, inner):
        self._inner = inner
        # Monotonic key, NOT id(self): CPython reuses freed addresses, so
        # an id-keyed graph would let a new lock inherit a dead lock's
        # edges and report phantom inversions between locks that never
        # coexisted.
        self._wid = next(_wid_counter)
        with _state_lock:
            _lock_sites[self._wid] = _caller_site(3)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking and _watchdog_s is not None and timeout == -1:
            got = self._inner.acquire(True, _watchdog_s)
            if not got:
                sys.stderr.write(
                    f"[lock_witness] acquire blocked >{_watchdog_s}s at "
                    f"{_caller_site(2)} (lock from "
                    f"{_lock_sites.get(self._wid)}); thread dump:\n")
                faulthandler.dump_traceback()
                got = self._inner.acquire(True, -1 if timeout == -1 else timeout)
        else:
            got = self._inner.acquire(blocking, timeout)
        if got:
            _record_acquire(self._wid)
            _held_stack().append(self._wid)
        return got

    def release(self):
        stack = _held_stack()
        # Remove the most recent occurrence (locks may release out of
        # LIFO order; witnesses tolerate it).
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self._wid:
                del stack[i]
                break
        else:
            # This thread never recorded the acquire. Silently releasing
            # would leave the acquirer's held-stack stale forever: every
            # lock it takes from now on grows phantom order edges, which
            # can both invent and MASK real inversions. Raise before
            # touching the inner lock so the discipline violation names
            # its site instead of corrupting the witness. Deliberate
            # tradeoff: a library using a plain Lock as a legal
            # cross-thread handoff would deadlock its owner here instead
            # of proceeding — but releasing first would unlock while the
            # owner's held-stack still lists the lock, recreating the
            # exact corruption this raise exists to prevent. No such
            # handoff exists under the sanitizer today, and the acquire
            # watchdog dumps all threads if one ever appears.
            raise RuntimeError(
                f"lock_witness: release() of lock created at "
                f"{_lock_sites.get(self._wid, '?')} by thread "
                f"{threading.get_ident()}, which never acquired it "
                f"(cross-thread release or double release)")
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # Condition support: forward RLock internals.
    def __getattr__(self, name):
        return getattr(self._inner, name)


class _WitnessLock(_WitnessBase):
    def __init__(self):
        super().__init__(_real_lock())


class _WitnessRLock(_WitnessBase):
    def __init__(self):
        super().__init__(_real_rlock())

    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        # Condition.wait releases the lock: clear our held marks for every
        # recursion level so the wait doesn't hold a phantom edge source.
        stack = _held_stack()
        while self._wid in stack:
            stack.remove(self._wid)
        return self._inner._release_save()

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)
        _held_stack().append(self._wid)


def install(watchdog_s: Optional[float] = None):
    """Patch threading.Lock/RLock with witness proxies. Idempotent."""
    global _installed, _watchdog_s
    with _state_lock:
        if _installed:
            _watchdog_s = watchdog_s if watchdog_s is not None else _watchdog_s
            return
        _installed = True
        _watchdog_s = watchdog_s
    threading.Lock = _WitnessLock  # type: ignore[misc]
    threading.RLock = _WitnessRLock  # type: ignore[misc]


def uninstall():
    global _installed
    with _state_lock:
        if not _installed:
            return
        _installed = False
    threading.Lock = _real_lock  # type: ignore[misc]
    threading.RLock = _real_rlock  # type: ignore[misc]


def reset():
    with _state_lock:
        _edges.clear()
        _edge_sites.clear()
        _cycles.clear()


def discard_cycles(site_substring: str) -> int:
    """Drop recorded cycles whose report mentions `site_substring` in any
    lock/acquisition site. For test fixtures that deliberately create
    inversions with synthetic locks: discarding by the test file's name
    removes exactly their evidence while keeping anything recorded from
    real control-plane locks, so a session-wide sanitizer gate stays
    sound. Returns the number discarded."""
    with _state_lock:
        kept = [c for c in _cycles if site_substring not in c]
        dropped = len(_cycles) - len(kept)
        _cycles[:] = kept
        return dropped


def report() -> Report:
    with _state_lock:
        return Report(cycles=list(_cycles),
                      locks_tracked=len(_lock_sites),
                      edges=sum(len(v) for v in _edges.values()))
