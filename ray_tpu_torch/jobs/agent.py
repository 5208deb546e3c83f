"""Per-node job agent: launches driver subprocesses for submitted jobs.

Reference: `dashboard/modules/job/job_manager.py` supervises drivers via
a detached JobSupervisor actor per job; here the agent is a plain object
hosted INSIDE each raylet (registered RPC endpoints `agent_run_job` /
`agent_stop_job`), which gives the same placement property — the driver
runs on a worker node, not inside the GCS — without a separate daemon.

Contract with the GCS (which owns the job table):

- `run_job(sid, entrypoint, runtime_env)` spawns the entrypoint with the
  PR-4 kill-handshake hygiene (`start_new_session=True`, group-liveness
  escalation from jobs/procutil.py) and returns immediately; a runner
  thread then reports `job_started` {sid, pid}, streams stdout/stderr
  lines to `job_log_append` in batched flushes (LogStreamer cadence:
  0.25 s flush tick, bounded batch with a dropped counter — a driver
  print-storm costs bounded RPC traffic, never unbounded memory), and
  finally reports `job_terminal` {sid, returncode, message}.
- `stop_job(sid)` delivers the group kill off-thread (the RPC caller
  never blocks on the SIGTERM grace window).
- `running()` is the reconcile list `register_node` carries after a
  raylet restart: RUNNING jobs the GCS thinks live here but the fresh
  agent doesn't know are marked FAILED instead of hanging forever.

The driver inherits the job's runtime_env three ways: `env_vars` go into
its process environment directly, a `pip` spec's venv goes ahead on its
PYTHONPATH (the JAX package's agent leaves pip to the job's workers),
and the full prepared runtime_env rides in
`RAY_TPU_TORCH_JOB_RUNTIME_ENV` so the driver-side runtime adopts it as
the default for every task/actor it submits (that's what points the
job's tasks at the right per-env forge template).
"""

from __future__ import annotations

import codecs
import io
import json
import locale
import logging
import os
import select
import subprocess
import threading
import time
import zipfile
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.jobs import procutil

logger = logging.getLogger(__name__)

_FLUSH_INTERVAL_S = 0.25
_FLUSH_MAX_LINES = 500
_BUFFER_CAP_LINES = 2000


class JobAgent:
    """One per raylet. `gcs_call(method, params)` is the raylet's
    reconnecting GCS client — reports survive a GCS restart."""

    def __init__(self, node_id_hex: str, session_dir: str,
                 gcs_call: Callable[[str, Dict[str, Any]], Any],
                 gcs_address: str):
        self._node_id_hex = node_id_hex
        self._session_dir = session_dir
        self._gcs_call = gcs_call
        self._gcs_address = gcs_address
        self._lock = threading.Lock()
        # sid -> {proc, runner, killer, stopped}; entries are removed when
        # the runner reports terminal (job-cleanup handoff: the GCS job
        # table is the durable record, this is live-process state only).
        self._jobs: Dict[str, Dict[str, Any]] = {}
        self._closed = False

    # ---------------------------------------------------------------- API

    def run_job(self, sid: str, entrypoint: str,
                runtime_env: Optional[Dict[str, Any]] = None) -> None:
        runner = threading.Thread(
            target=self._run, args=(sid, entrypoint, runtime_env or {}),
            name=f"job-agent-{sid[:12]}", daemon=True)
        with self._lock:
            if self._closed:
                raise RuntimeError("job agent is shut down")
            if sid in self._jobs:
                raise ValueError(f"job {sid!r} already running on this node")
            self._jobs[sid] = {"proc": None, "runner": runner,
                               "killer": None, "stopped": False}
        runner.start()

    def stop_job(self, sid: str) -> bool:
        with self._lock:
            job = self._jobs.get(sid)
            if job is None:
                return False
            job["stopped"] = True
            proc = job["proc"]
            killer = None
            if proc is not None and proc.poll() is None and \
                    job["killer"] is None:
                # Group kill escalates off-thread (same reasoning as
                # JobManager.stop): the RPC caller must not ride out the
                # grace period, and the killer is published under the
                # SAME lock hold as the stopped flag so shutdown()'s
                # join sweep cannot miss it.
                killer = threading.Thread(
                    target=procutil.kill_group, args=(proc,),
                    name=f"job-agent-kill-{sid[:12]}", daemon=True)
                job["killer"] = killer
        if killer is not None:
            killer.start()
        return True

    def running(self) -> List[str]:
        with self._lock:
            return list(self._jobs)

    def shutdown(self, timeout_s: float = 10.0) -> None:
        with self._lock:
            self._closed = True
            sids = list(self._jobs)
        for sid in sids:
            self.stop_job(sid)
        deadline = time.monotonic() + timeout_s
        with self._lock:
            waiters = [t for j in self._jobs.values()
                       for t in (j["killer"], j["runner"]) if t is not None]
        for t in waiters:
            while True:
                try:
                    t.join(timeout=max(0.0, deadline - time.monotonic()))
                    break
                except RuntimeError:
                    # published but not yet start()ed; the start is
                    # imminent — yield rather than skip kill delivery.
                    if time.monotonic() >= deadline:
                        break
                    time.sleep(0.01)

    # ------------------------------------------------------------- runner

    def _run(self, sid: str, entrypoint: str,
             runtime_env: Dict[str, Any]) -> None:
        job = self._jobs[sid]
        try:
            env, cwd = self._driver_env(sid, runtime_env)
        except Exception as e:  # noqa: BLE001 — env materialization failed
            self._report("job_terminal",
                         {"submission_id": sid, "returncode": -1,
                          "message": f"runtime_env failed: {e}"})
            with self._lock:
                self._jobs.pop(sid, None)
            return
        try:
            with self._lock:
                if job["stopped"]:
                    self._report("job_terminal",
                                 {"submission_id": sid, "returncode": -1,
                                  "message": "stopped before start",
                                  "stopped": True})
                    self._jobs.pop(sid, None)
                    return
            # Spawn OUTSIDE the lock (raylint RL002): fork/exec can take
            # hundreds of ms and would stall stop/run RPCs meanwhile.
            proc = subprocess.Popen(
                entrypoint, shell=True, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, env=env, cwd=cwd,
                start_new_session=True)
        except Exception as e:  # noqa: BLE001 — spawn failure
            self._report("job_terminal",
                         {"submission_id": sid, "returncode": -1,
                          "message": f"failed to start: {e}"})
            with self._lock:
                self._jobs.pop(sid, None)
            return
        with self._lock:
            stopped = job["stopped"]
            if not stopped:
                job["proc"] = proc
        if stopped:
            # stop raced the spawn and found no proc: the kill is ours.
            procutil.kill_group(proc)
            self._report("job_terminal",
                         {"submission_id": sid, "returncode": -1,
                          "message": "stopped", "stopped": True})
            with self._lock:
                self._jobs.pop(sid, None)
            return
        self._report("job_started", {"submission_id": sid, "pid": proc.pid})
        self._pump_logs(sid, proc)
        rc = proc.wait()
        with self._lock:
            was_stopped = job["stopped"]
            killer = job["killer"]
        if killer is not None:
            killer.join(timeout=10.0)
        msg = "" if rc == 0 else f"entrypoint exited with code {rc}"
        self._report("job_terminal",
                     {"submission_id": sid, "returncode": rc,
                      "message": "stopped" if was_stopped else msg,
                      "stopped": was_stopped})
        with self._lock:
            self._jobs.pop(sid, None)

    def _pump_logs(self, sid: str, proc: subprocess.Popen) -> None:
        """Stream the driver's output to the GCS log plane in batched
        flushes. Runs on the runner thread until EOF (process exit).

        The pipe is polled with a timeout of one flush interval, so a
        line that no other line follows is flushed within the interval."""
        assert proc.stdout is not None
        fd = proc.stdout.fileno()
        decoder = codecs.getincrementaldecoder(
            locale.getpreferredencoding(False))(errors="replace")
        buf: List[str] = []
        dropped = 0
        pending = ""  # text after the last newline
        last_flush = time.monotonic()

        def flush():
            nonlocal buf, dropped, last_flush
            if buf or dropped:
                self._report("job_log_append",
                             {"submission_id": sid, "lines": buf,
                              "dropped": dropped})
                buf, dropped = [], 0
            last_flush = time.monotonic()

        eof = False
        while not eof:
            if select.select([fd], [], [], _FLUSH_INTERVAL_S)[0]:
                chunk = os.read(fd, 1 << 16)
                eof = not chunk
                text = pending + decoder.decode(chunk, final=eof)
                # Universal newlines, as a text stream reads them; a "\r"
                # at the end may be the first half of a "\r\n".
                held = "\r" if text.endswith("\r") and not eof else ""
                lines = text[:len(text) - len(held)].replace(
                    "\r\n", "\n").replace("\r", "\n").split("\n")
                pending = lines.pop() + held
                if eof and pending:
                    lines.append(pending)
                for line in lines:
                    if len(buf) >= _BUFFER_CAP_LINES:
                        dropped += 1  # print storm: count, don't buffer
                    else:
                        buf.append(line)
            if len(buf) >= _FLUSH_MAX_LINES or \
                    time.monotonic() - last_flush >= _FLUSH_INTERVAL_S:
                flush()
        flush()

    # ------------------------------------------------------------ plumbing

    def _report(self, method: str, params: Dict[str, Any]) -> None:
        params["node_id"] = self._node_id_hex
        try:
            self._gcs_call(method, params)
        except Exception:  # noqa: BLE001 — GCS down; reconcile will catch up
            logger.warning("job agent: %s report failed", method,
                           exc_info=True)

    def _driver_env(self, sid: str, runtime_env: Dict[str, Any]):
        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = self._gcs_address
        env["RAY_TPU_TORCH_SUBMISSION_ID"] = sid
        # The entrypoint must import the SAME framework this cluster runs
        # (which may not be pip-installed).
        import ray_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(ray_tpu_torch.__file__)))
        pp = env.get("PYTHONPATH", "")
        if pkg_root not in pp.split(os.pathsep):
            env["PYTHONPATH"] = pkg_root + (os.pathsep + pp if pp else "")
        pip = runtime_env.get("pip")
        if pip:
            # The driver runs in the job's pip environment too, as the
            # job's workers do: the venv (content-addressed under the
            # session dir, shared with the workers' materialization) goes
            # ahead on its PYTHONPATH, the base site-packages stay
            # importable behind it.
            from ray_tpu_torch.core.runtime_env import (
                _ensure_venv, _venv_site_packages)

            venv = _ensure_venv(
                pip, os.path.join(self._session_dir, "runtime_env"))
            env["PYTHONPATH"] = _venv_site_packages(venv) + os.pathsep + \
                env["PYTHONPATH"]
            env["VIRTUAL_ENV"] = venv
        for k, v in (runtime_env.get("env_vars") or {}).items():
            env[str(k)] = str(v)
        if runtime_env:
            env["RAY_TPU_TORCH_JOB_RUNTIME_ENV"] = json.dumps(runtime_env)
        cwd = None
        wd = runtime_env.get("working_dir")
        if wd:
            cwd = self._materialize_working_dir(wd)
            env["RAY_TPU_TORCH_JOB_CWD"] = cwd
        return env, cwd

    def _materialize_working_dir(self, wd: str) -> str:
        """A prepared working_dir is a `kv://runtime_env/<sha>.zip` URI:
        fetch + extract under the session dir (content-addressed, shared
        with worker-side materialization). A plain directory path passes
        through — single-node convenience."""
        from ray_tpu_torch.core.runtime_env import URI_PREFIX, _KV_NS

        if not wd.startswith(URI_PREFIX):
            if not os.path.isdir(wd):
                raise ValueError(f"working_dir {wd!r} is not a directory")
            return os.path.abspath(wd)
        sha = wd[len(URI_PREFIX):-len(".zip")]
        cache = os.path.join(self._session_dir, "runtime_env")
        dest = os.path.join(cache, sha)
        if os.path.isdir(dest):
            return dest
        os.makedirs(cache, exist_ok=True)
        resp = self._gcs_call("kv_get", {"namespace": _KV_NS,
                                         "key": wd.encode()})
        blob = resp.get("value")
        if blob is None:
            raise RuntimeError(f"runtime_env blob {wd} missing from GCS KV")
        import shutil
        import tempfile

        tmp = tempfile.mkdtemp(prefix=f"{sha}.", dir=cache)
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            zf.extractall(tmp)
        try:
            os.rename(tmp, dest)
        except OSError:
            if not os.path.isdir(dest):
                raise
            shutil.rmtree(tmp, ignore_errors=True)  # lost the race
        return dest
