"""Memory monitor: host-RAM pressure detection + OOM worker killing.

Equivalent of the reference's `src/ray/common/memory_monitor.h:52`
(usage polling against a threshold, cgroup-aware) and
`src/ray/raylet/worker_killing_policy.h:34` (which worker to sacrifice).
On a GPU host the cards' memory is managed by each worker's CUDA
allocator, but the HOST RAM feeding them (datasets, preprocessing, object
store) is not — a runaway worker takes the whole VM down with it unless
something sheds load first.

Policy (reference retriable-first / last-in-first-killed): kill the
worker running the most recently started RETRIABLE normal task first —
its work is re-runnable and losing the newest wastes the least progress;
then non-retriable normal tasks. Actor workers are never chosen (they
hold state the framework cannot reconstruct); if only actors remain the
monitor logs and stands down. The killed task fails with
OutOfMemoryError (a WorkerCrashedError, so the owner's crash-retry
machinery re-runs retriable tasks as usual).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional, Tuple

logger = logging.getLogger(__name__)

_CGROUP_V2 = "/sys/fs/cgroup"
_CGROUP_V1_MEM = "/sys/fs/cgroup/memory"


def _read_int(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            raw = f.read().strip()
        return None if raw == "max" else int(raw)
    except (OSError, ValueError):
        return None


def system_memory() -> Tuple[int, int]:
    """(used_bytes, total_bytes), preferring the cgroup limit when the
    process runs in a container whose limit is tighter than the host
    (reference memory_monitor.cc reads both and takes the binding one)."""
    meminfo = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    meminfo[parts[0].rstrip(":")] = int(parts[1]) * 1024
    except OSError:
        return 0, 1
    total = meminfo.get("MemTotal", 1)
    avail = meminfo.get("MemAvailable", total)
    used = total - avail
    # cgroup v2 (unified) / v1 fallback.
    cg_limit = _read_int(os.path.join(_CGROUP_V2, "memory.max"))
    cg_used = _read_int(os.path.join(_CGROUP_V2, "memory.current"))
    if cg_limit is None:
        cg_limit = _read_int(os.path.join(_CGROUP_V1_MEM,
                                          "memory.limit_in_bytes"))
        cg_used = _read_int(os.path.join(_CGROUP_V1_MEM,
                                         "memory.usage_in_bytes"))
        if cg_limit is not None and cg_limit >= (1 << 60):
            cg_limit = None  # v1 "unlimited" sentinel
    if cg_limit is not None and cg_used is not None and cg_limit < total:
        return cg_used, cg_limit
    return used, total


def process_rss(pid: int) -> int:
    """Resident set size of `pid` in bytes (0 when unreadable)."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            fields = f.read().split()
        return int(fields[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


class MemoryMonitor:
    """Polls memory usage; sheds workers per the killing policy above.

    `usage_fn` is injectable for tests (simulating pressure without
    actually exhausting the host).
    """

    def __init__(self, raylet, refresh_ms: int, threshold: float,
                 usage_fn: Optional[Callable[[], Tuple[int, int]]] = None):
        self._raylet = raylet
        self._period_s = max(0.05, refresh_ms / 1000.0)
        self._threshold = threshold
        self._usage_fn = usage_fn or system_memory
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Kill grace: a SIGKILL'd multi-GiB process takes time to return
        # its RSS to the OS; choosing another victim before the last one
        # has actually exited (plus a settle window) would cascade-kill
        # every worker on the node during one sustained spike.
        self._last_victim_proc = None
        self._last_kill_time = 0.0
        self.kills = 0

    KILL_SETTLE_S = 1.0

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="memory-monitor", daemon=True)
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        while not self._stopped.wait(self._period_s):
            try:
                self._check_once()
            except Exception:  # noqa: BLE001 — monitoring must not die
                logger.exception("memory monitor check failed")

    def _check_once(self):
        used, total = self._usage_fn()
        if total <= 0 or used / total < self._threshold:
            return
        # Let the previous kill land before sacrificing anyone else.
        if self._last_victim_proc is not None:
            if self._last_victim_proc.poll() is None:
                return  # still dying
            if time.monotonic() - self._last_kill_time < \
                    max(self.KILL_SETTLE_S, 2 * self._period_s):
                return  # exited, but give the RSS a moment to reclaim
            self._last_victim_proc = None
        victim = self._pick_victim()
        if victim is None:
            logger.error(
                "memory usage %.1f%% exceeds threshold %.0f%% but no "
                "killable worker exists (actors are never chosen); "
                "the host may OOM", 100 * used / total,
                100 * self._threshold)
            return
        handle, spec, retriable = victim
        rss = process_rss(handle.pid)
        task_desc = (f"running {spec.name!r}" if spec is not None
                     else "serving direct-transport tasks")
        reason = (
            f"node memory usage {used / (1 << 30):.2f}/"
            f"{total / (1 << 30):.2f} GiB ({100 * used / total:.1f}%) "
            f"exceeds threshold {100 * self._threshold:.0f}%; killed "
            f"worker pid={handle.pid} (rss {rss / (1 << 30):.2f} GiB) "
            f"{task_desc}"
            + ("" if retriable else " (task is not retriable)"))
        with self._raylet.pool._lock:
            if handle.current_task is not spec or handle.state != "busy":
                # The task we chose finished (and something else may have
                # been dispatched) between selection and kill — stand
                # down this round rather than OOM-blame the wrong task.
                return
            handle.oom_kill_reason = reason
        logger.warning("OOM killer: %s", reason)
        self.kills += 1
        self._last_victim_proc = handle.proc
        self._last_kill_time = time.monotonic()
        try:
            handle.proc.kill()  # _pick_victim only returns proc-owning ones
        except (OSError, ProcessLookupError):
            pass

    def _pick_victim(self):
        """Newest retriable normal task first, then newest non-retriable,
        then direct-transport dedicated workers (the owner-side transport
        handles the crash); never actors."""
        pool = self._raylet.pool
        with pool._lock:
            handles = list(pool._workers.values())
        retriable, fallback, direct = [], [], []
        for h in handles:
            if (h.state != "busy" or h.is_actor or h.proc is None
                    or h.oom_kill_reason):
                continue
            spec = h.current_task
            if spec is None:
                direct.append((h, None))  # dedicated to a direct-task lease
            elif spec.actor_creation:
                continue
            elif spec.max_retries > 0:
                retriable.append((h, spec))
            else:
                fallback.append((h, spec))
        for group in (retriable, fallback, direct):
            if group:
                newest, spec = max(
                    group, key=lambda hs: hs[0].task_started
                    or hs[0].last_idle)
                return newest, spec, group is retriable
        return None
