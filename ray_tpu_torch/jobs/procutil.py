"""Process-group kill hygiene shared by every entrypoint supervisor.

Factored out of `job_submission/manager.py` (the PR-4 kill handshake) so
the per-node job agent and the legacy in-GCS JobManager escalate
identically: SIGTERM the group, wait out a grace window keyed on GROUP
liveness (not the direct child's), then SIGKILL survivors and confirm
the group is gone before returning.
"""

from __future__ import annotations

import os
import subprocess
import time


def kill_group(proc: subprocess.Popen, grace_s: float = 3.0) -> None:
    """SIGTERM the entrypoint's process group, then SIGKILL whatever
    part of it outlives grace_s: a TERM-trapping driver must not
    survive shutdown or park the waiting runner thread forever.

    The direct child is the `sh -c` wrapper (shell=True), and its
    death says nothing about the group — the shell dies on TERM
    while a TERM-trapping python driver it spawned survives in the
    same group. So the escalation is keyed on GROUP liveness, probed
    with killpg(pgid, 0): while any member lives the pgid (== the
    leader's pid, via start_new_session=True) cannot be recycled, so
    a positive probe means the KILL lands on our group, never on a
    stranger whose group reused a freed pid. The probe and the
    signal cannot be fully atomic — the residual window is the
    microseconds between them, within which the whole pid space
    would have to wrap for the signal to land elsewhere."""
    def _sig(sig, fallback):
        try:
            os.killpg(proc.pid, sig)
        except OSError:
            try:
                fallback()
            except OSError:
                pass  # exited and reaped in between
    _sig(15, proc.terminate)
    if not wait_group_dead(proc, grace_s):
        _sig(9, proc.kill)
        # Confirm the group is actually gone before returning: callers
        # join the killing thread as their proof of kill delivery, and
        # one that exits the process the moment we return must not race
        # the SIGKILLed survivors' death. Bounded — SIGKILL cannot be
        # trapped, so this only waits out the kernel teardown and
        # init's zombie reap.
        wait_group_dead(proc, 2.0)
    try:
        proc.wait(timeout=2.0)
    except subprocess.TimeoutExpired:
        pass  # stuck in uninterruptible sleep past SIGKILL; stay bounded


def wait_group_dead(proc: subprocess.Popen, timeout_s: float) -> bool:
    """Poll until no member of the entrypoint's process group remains
    (killpg(pgid, 0) -> ESRCH), reaping the direct child along the
    way. False if the group still has members after timeout_s."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            os.killpg(proc.pid, 0)
        except OSError:
            return True  # whole group exited (and was reaped)
        if time.monotonic() >= deadline:
            return False
        if proc.returncode is None:
            try:
                proc.wait(timeout=0.1)  # reap the shell + pace the poll
            except subprocess.TimeoutExpired:
                pass
        else:
            time.sleep(0.05)  # child reaped; poll surviving group
