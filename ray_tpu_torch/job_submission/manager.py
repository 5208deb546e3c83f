"""Server half of job submission: spawn, monitor, and log entrypoints.

The port's copy of `ray_tpu/job_submission/manager.py`: the legacy
in-GCS manager, used when `job_agent_enabled` is off. Reference: `dashboard/modules/job/job_manager.py:507` (the reference runs
drivers via a JobSupervisor actor; here the GCS process supervises the
subprocess directly — one fewer moving part, same state machine).
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.job_submission import JobStatus
from ray_tpu_torch.jobs import procutil


class JobManager:
    def __init__(self, gcs_address: str, log_dir: str):
        self._gcs_address = gcs_address
        self._log_dir = log_dir
        self._lock = threading.Lock()
        self._jobs: Dict[str, Dict[str, Any]] = {}
        self._closed = False

    # ---------------------------------------------------------------- API

    def submit(self, entrypoint: str, submission_id: Optional[str] = None,
               runtime_env: Optional[Dict[str, Any]] = None,
               metadata: Optional[Dict[str, str]] = None) -> str:
        sid = submission_id or f"raysubmit_{uuid.uuid4().hex[:16]}"
        runner = threading.Thread(target=self._run, args=(sid, runtime_env),
                                  name=f"job-{sid[:12]}", daemon=True)
        with self._lock:
            if self._closed:
                # The RPC server keeps serving submits during GCS
                # teardown (it stops AFTER job_manager.shutdown()); a
                # job admitted here would spawn after the kill sweep and
                # be orphaned when the process exits.
                raise RuntimeError("job manager is shut down")
            if sid in self._jobs:
                raise ValueError(f"submission_id {sid!r} already exists")
            self._jobs[sid] = {
                "entrypoint": entrypoint, "status": JobStatus.PENDING,
                "message": "", "start_time": None, "end_time": None,
                "metadata": metadata or {}, "proc": None,
                "runner": runner, "killer": None,
                "log_path": os.path.join(self._log_dir, f"job-{sid}.log")}
        runner.start()
        return sid

    # Kill-handshake hygiene lives in jobs/procutil.py now, shared with
    # the per-node job agent; these shims keep the existing call sites
    # (and the direct unit tests against them) stable.
    _kill_group = staticmethod(procutil.kill_group)
    _wait_group_dead = staticmethod(procutil.wait_group_dead)

    def _run(self, sid: str, runtime_env: Optional[Dict[str, Any]]):
        job = self._jobs[sid]
        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = self._gcs_address
        env["RAY_TPU_TORCH_SUBMISSION_ID"] = sid
        # The entrypoint must import the SAME framework this cluster runs
        # (which may not be pip-installed, and $TMPDIR/ray_tpu_torch session
        # dirs can shadow the package as a namespace package).
        import ray_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(ray_tpu_torch.__file__)))
        pp = env.get("PYTHONPATH", "")
        if pkg_root not in pp.split(os.pathsep):
            env["PYTHONPATH"] = pkg_root + (os.pathsep + pp if pp else "")
        for k, v in ((runtime_env or {}).get("env_vars") or {}).items():
            env[k] = str(v)
        cwd = (runtime_env or {}).get("working_dir") or None
        os.makedirs(self._log_dir, exist_ok=True)
        try:
            with open(job["log_path"], "wb") as logf:
                with self._lock:
                    if job["status"] == JobStatus.STOPPED:
                        # stop() won the race before the spawn: honor it.
                        job["end_time"] = time.time()
                        return
                # Spawn OUTSIDE the lock (raylint RL002): fork/exec can
                # take hundreds of ms and would stall every status query
                # and submit on the shared lock.
                proc = subprocess.Popen(
                    job["entrypoint"], shell=True, stdout=logf,
                    stderr=subprocess.STDOUT, env=env, cwd=cwd,
                    start_new_session=True)
                with self._lock:
                    stopped = job["status"] == JobStatus.STOPPED
                    if not stopped:
                        job["proc"] = proc
                        job["status"] = JobStatus.RUNNING
                        job["start_time"] = time.time()
                if stopped:
                    # stop() raced the spawn and found no proc to kill:
                    # the kill is ours to deliver.
                    self._kill_group(proc)
                    with self._lock:
                        job["end_time"] = time.time()
                    return
                rc = proc.wait()
            with self._lock:
                job["end_time"] = time.time()
                if job["status"] == JobStatus.STOPPED:
                    pass  # stop_job already labeled it
                elif rc == 0:
                    job["status"] = JobStatus.SUCCEEDED
                else:
                    job["status"] = JobStatus.FAILED
                    job["message"] = f"entrypoint exited with code {rc}"
        except Exception as e:  # noqa: BLE001 — spawn failure
            with self._lock:
                job["status"] = JobStatus.FAILED
                job["message"] = f"failed to start: {e}"
                job["end_time"] = time.time()

    def details(self, sid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            job = self._jobs.get(sid)
            if job is None:
                return None
            return {"submission_id": sid, "entrypoint": job["entrypoint"],
                    "status": job["status"], "message": job["message"],
                    "start_time": job["start_time"],
                    "end_time": job["end_time"],
                    "metadata": dict(job["metadata"])}

    def logs(self, sid: str) -> Optional[str]:
        with self._lock:
            job = self._jobs.get(sid)
        if job is None:
            return None
        try:
            with open(job["log_path"], "rb") as f:
                return f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""

    def stop(self, sid: str) -> bool:
        with self._lock:
            job = self._jobs.get(sid)
            if job is None or job["status"] in JobStatus.TERMINAL:
                return False
            job["status"] = JobStatus.STOPPED
            proc = job["proc"]
            killer = None
            if proc is not None and proc.poll() is None:
                # The entrypoint may have children (driver spawns workers
                # elsewhere, but shell pipelines are local): kill the
                # group, escalating to SIGKILL off-thread so a
                # TERM-trapping driver cannot outlive its STOPPED status
                # — and so this RPC-path caller never blocks on the grace
                # period. Published under the SAME lock hold that flips
                # the status: shutdown()'s waiter snapshot must never see
                # a STOPPED job whose killer is still unrecorded, or the
                # join that proves kill delivery silently skips it.
                # (poll() is WNOHANG — no RL002 concern.)
                killer = threading.Thread(
                    target=self._kill_group, args=(proc,),
                    name=f"job-kill-{sid[:12]}", daemon=True)
                job["killer"] = killer
        if killer is not None:
            killer.start()
        return True

    def delete(self, sid: str) -> bool:
        with self._lock:
            job = self._jobs.get(sid)
            if job is None or job["status"] not in JobStatus.TERMINAL:
                return False
            del self._jobs[sid]
        try:
            os.unlink(job["log_path"])
        except OSError:
            pass
        return True

    def list(self) -> List[Dict[str, Any]]:
        with self._lock:
            sids = list(self._jobs)
        return [d for sid in sids if (d := self.details(sid)) is not None]

    def shutdown(self, timeout_s: float = 10.0):
        # PENDING included: a job whose spawn is still in flight gets
        # marked STOPPED here, and the runner thread's post-spawn
        # handshake (see _run) delivers the kill to the process group it
        # just created — skipping it would orphan the entrypoint.
        with self._lock:
            self._closed = True  # later submits raise instead of orphaning
            sids = [s for s, j in self._jobs.items()
                    if j["status"] in (JobStatus.PENDING, JobStatus.RUNNING)]
        for sid in sids:
            self.stop(sid)
        # The signals are delivered off-thread (stop() must not block its
        # RPC caller on the grace period), but shutdown() is the last
        # exit ramp before the supervising process dies — returning with
        # a daemon killer still in flight would orphan an entrypoint
        # whose SIGTERM never got sent. Join the killer (stop() path) and
        # the runner (PENDING-spawn handshake path + reap) of EVERY job,
        # not just the ones this call stopped: a client stop() moments
        # before shutdown leaves its killer mid-grace too. Joins on
        # finished jobs' dead threads return immediately; the deadline
        # bounds a wedged entrypoint past the SIGKILL escalation.
        deadline = time.monotonic() + timeout_s
        with self._lock:
            waiters = [t for j in self._jobs.values()
                       for t in (j["killer"], j["runner"])
                       if t is not None]
        for t in waiters:
            while True:
                try:
                    t.join(timeout=max(0.0, deadline - time.monotonic()))
                    break
                except RuntimeError:
                    # Published in _jobs but not yet start()ed by its
                    # spawning thread (submit/stop release the lock
                    # before start()); the start is imminent — yield and
                    # retry rather than skip its kill delivery.
                    if time.monotonic() >= deadline:
                        break
                    time.sleep(0.01)
