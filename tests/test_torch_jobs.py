"""The port's job tier on the CPU: `ray_tpu_torch.job_submission` (the
client and the legacy in-GCS `JobManager`), the per-node job agent and
runtime-env pip, beside the JAX package's.

One module-scoped port runtime (4 CPUs). First the cases of
tests/test_jobs.py and of tests/test_cluster_services.py's job tests, each
under the name of the reference test it mirrors; the two end-to-end cases
run on both the agent path and the legacy manager
(`job_agent_enabled` off). Then one parity test: the same three
entrypoints go to a cluster of each package in this process, and their
status sequences, details and logs must agree. Last, the cases of
tests/test_runtime_env_pip.py against the port, and a job whose driver
imports a package from its pip environment.

Every wait is on a job's status, its logs or a file, never on a sleep.
"""

import contextlib
import os
import sys
import time
import uuid
import zipfile

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.job_submission import (JobDetails, JobStatus,
                                          JobSubmissionClient)
from ray_tpu_torch.jobs import public_details


@pytest.fixture(scope="module", autouse=True)
def runtime():
    ray_tpu_torch.init(num_cpus=4)
    created = ray_tpu_torch._global_runtime
    yield created
    if ray_tpu_torch._global_runtime is created:
        ray_tpu_torch.shutdown()


def _client():
    return JobSubmissionClient(ray_tpu_torch._global_runtime.gcs.address)


def _wait_terminal(client, sid, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status = client.get_job_status(sid)
        if status in JobStatus.TERMINAL:
            return status
        time.sleep(0.05)
    return client.get_job_status(sid)


def _wait_logs(client, sid, text, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        logs = client.get_job_logs(sid)
        if text in logs:
            return logs
        time.sleep(0.05)
    raise AssertionError(f"{text!r} not in job {sid}'s logs: "
                         f"{client.get_job_logs(sid)[-800:]}")


@contextlib.contextmanager
def _legacy_manager(on: bool):
    """Route submissions through the legacy in-GCS JobManager (the GCS
    reads the flag at each submit; this process hosts it)."""
    if on:
        GLOBAL_CONFIG.job_agent_enabled = False
    try:
        yield
    finally:
        GLOBAL_CONFIG._overrides.pop("job_agent_enabled", None)


def _py(src: str) -> str:
    """An entrypoint running `src` in this interpreter, unbuffered."""
    return f"{sys.executable} -u -c \"{src}\""


def test_job_details_match_the_agent_record():
    # JobDetails is built from the GCS record's public form: the same keys.
    from ray_tpu_torch.jobs import new_record

    rec = new_record("sid", "true", {}, {"k": "v"}, {}, "", 0.0)
    details = JobDetails(**public_details(rec))
    assert set(public_details(rec)) == set(vars(details))
    assert details.status == JobStatus.SUBMITTED


# --------------------------------------------------------------------------- #
# tests/test_jobs.py: the submission plane, runtime envs and tenants
# --------------------------------------------------------------------------- #


def test_submit_with_runtime_env_and_tenant():
    client = _client()
    sid = client.submit_job(
        entrypoint=_py(
            "import os, ray_tpu_torch; ray_tpu_torch.init()\n"
            "print('MARKER=' + os.environ.get('JOB_MARKER', 'missing'))\n"
            "@ray_tpu_torch.remote\n"
            "def probe():\n"
            "    return os.environ.get('JOB_MARKER', 'missing')\n"
            "print('TASK_SAW=' + ray_tpu_torch.get(probe.remote()))\n"
            "ray_tpu_torch.shutdown()"),
        runtime_env={"env_vars": {"JOB_MARKER": "tenant-e2e"}},
        tenant={"name": "batch-team", "tier": "gold"},
        metadata={"owner": "jobs-test"})
    status = _wait_terminal(client, sid)
    logs = client.get_job_logs(sid)
    assert status == JobStatus.SUCCEEDED, f"status={status} logs={logs[-800:]}"
    assert "MARKER=tenant-e2e" in logs
    assert "TASK_SAW=tenant-e2e" in logs
    info = client.get_job_info(sid)
    assert info.status == JobStatus.SUCCEEDED
    assert info.tenant == "batch-team"
    assert info.metadata == {"owner": "jobs-test"}
    assert info.runtime_env.get("env_vars") == {"JOB_MARKER": "tenant-e2e"}
    assert info.driver_job_id, "driver job never linked to the submission"
    assert info.node_id, "job record never recorded its agent node"
    client.close()


def test_submit_bad_tenant_rejected():
    client = _client()
    with pytest.raises(RuntimeError, match="tenant"):
        client.submit_job(entrypoint="true",
                          tenant={"name": "x", "tier": "platinum"})
    client.close()


def test_concurrent_jobs_with_distinct_envs():
    """N concurrent jobs with different runtime envs share one cluster;
    each sees only its own env (worker isolation by job)."""
    client = _client()
    sids = [client.submit_job(
        entrypoint=_py(
            "import os, ray_tpu_torch; ray_tpu_torch.init()\n"
            "@ray_tpu_torch.remote\n"
            "def who():\n"
            "    return os.environ.get('JOB_COLOR', '?')\n"
            "got = ray_tpu_torch.get([who.remote() for _ in range(4)])\n"
            "print('COLORS=' + ','.join(sorted(set(got))))\n"
            "ray_tpu_torch.shutdown()"),
        runtime_env={"env_vars": {"JOB_COLOR": f"color-{i}"}})
        for i in range(3)]
    for i, sid in enumerate(sids):
        status = _wait_terminal(client, sid)
        logs = client.get_job_logs(sid)
        assert status == JobStatus.SUCCEEDED, \
            f"job {i} status={status} logs={logs[-800:]}"
        assert f"COLORS=color-{i}" in logs, logs[-800:]
    client.close()


# --------------------------------------------------------------------------- #
# tests/test_jobs.py: job-scoped isolation (KV purge, worker reclamation)
# --------------------------------------------------------------------------- #


def test_job_scoped_kv_purged_on_finish():
    client = _client()
    sid = client.submit_job(entrypoint=_py(
        "import ray_tpu_torch; ray_tpu_torch.init()\n"
        "ray_tpu_torch.kv_put('state', b'job-private')\n"
        "print('KV=' + ray_tpu_torch.kv_get('state').decode())\n"
        "ray_tpu_torch.shutdown()"))
    status = _wait_terminal(client, sid)
    logs = client.get_job_logs(sid)
    assert status == JobStatus.SUCCEEDED, logs[-800:]
    assert "KV=job-private" in logs
    job_hex = client.get_job_info(sid).driver_job_id
    gcs = ray_tpu_torch._global_runtime.gcs
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        resp = gcs.call("kv_get", {"namespace": f"job:{job_hex}:default",
                                   "key": b"state"})
        if resp.get("value") is None:
            break
        time.sleep(0.05)
    assert resp.get("value") is None, "job-scoped KV outlived its job"
    client.close()


def test_interactive_kv_is_job_scoped():
    ray_tpu_torch.kv_put("k1", b"v1")
    assert ray_tpu_torch.kv_get("k1") == b"v1"
    assert ray_tpu_torch.kv_get("missing") is None
    ray_tpu_torch.kv_del("k1")
    assert ray_tpu_torch.kv_get("k1") is None
    rt = ray_tpu_torch._global_runtime
    ray_tpu_torch.kv_put("k2", b"v2", namespace="ns")
    raw = rt.gcs.call("kv_get", {
        "namespace": f"job:{rt.job_id.hex()}:ns", "key": b"k2"})
    assert raw.get("value") == b"v2"


def test_job_workers_reclaimed_after_finish():
    """A finished job's workers (leased by its job-tagged env) retire."""
    client = _client()
    sid = client.submit_job(entrypoint=_py(
        "import ray_tpu_torch; ray_tpu_torch.init()\n"
        "@ray_tpu_torch.remote\n"
        "def f(i):\n"
        "    return i\n"
        "print(sum(ray_tpu_torch.get([f.remote(i) for i in range(8)])))\n"
        "ray_tpu_torch.shutdown()"))
    assert _wait_terminal(client, sid) == JobStatus.SUCCEEDED, \
        client.get_job_logs(sid)[-800:]
    job_hex = client.get_job_info(sid).driver_job_id
    raylet = ray_tpu_torch._global_node.raylet
    deadline = time.monotonic() + 20
    leftovers = None
    while time.monotonic() < deadline:
        with raylet.pool._lock:
            leftovers = [h for h in raylet.pool._workers.values()
                         if h.state not in ("dead",)
                         and h.granted_env.get("RAY_TPU_TORCH_JOB_ID")
                         == job_hex]
        if not leftovers:
            break
        time.sleep(0.05)
    assert not leftovers, \
        f"{len(leftovers)} workers survived their job's finish"
    client.close()


def test_detached_actor_survives_job():
    client = _client()
    sid = client.submit_job(entrypoint=_py(
        "import ray_tpu_torch; ray_tpu_torch.init()\n"
        "@ray_tpu_torch.remote\n"
        "class Keeper:\n"
        "    def __init__(self):\n"
        "        self.v = 0\n"
        "    def bump(self):\n"
        "        self.v += 1\n"
        "        return self.v\n"
        "d = Keeper.options(name='jobs-keeper', "
        "lifetime='detached').remote()\n"
        "e = Keeper.options(name='jobs-ephemeral').remote()\n"
        "print('BUMP=', ray_tpu_torch.get(d.bump.remote()))\n"
        "print('EPH=', ray_tpu_torch.get(e.bump.remote()))\n"
        "ray_tpu_torch.shutdown()"))
    status = _wait_terminal(client, sid)
    assert status == JobStatus.SUCCEEDED, client.get_job_logs(sid)[-800:]
    handle = ray_tpu_torch.get_actor("jobs-keeper")
    assert ray_tpu_torch.get(handle.bump.remote(), timeout=30) == 2
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        try:
            ray_tpu_torch.get_actor("jobs-ephemeral")
        except ValueError:
            break
        time.sleep(0.05)
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("jobs-ephemeral")
    ray_tpu_torch.kill(handle)
    client.close()


def test_working_dir_job(tmp_path):
    (tmp_path / "jobdata.txt").write_text("payload-42\n")
    (tmp_path / "jobmod.py").write_text(
        "def answer():\n    return open('jobdata.txt').read().strip()\n")
    client = _client()
    sid = client.submit_job(
        entrypoint=_py("import jobmod\nprint('DATA=' + jobmod.answer())"),
        runtime_env={"working_dir": str(tmp_path)})
    status = _wait_terminal(client, sid)
    logs = client.get_job_logs(sid)
    assert status == JobStatus.SUCCEEDED, logs[-800:]
    assert "DATA=payload-42" in logs
    info = client.get_job_info(sid)
    assert info.runtime_env["working_dir"].startswith("kv://runtime_env/")
    client.close()


def test_job_table_survives_gcs_restart(tmp_path):
    """A cluster of its own (not connected: the job needs no driver
    runtime) whose GCS persists its tables; the terminal record survives
    a failover."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1},
                      gcs_storage_path=str(tmp_path / "gcs_tables.bin"))
    cluster.wait_for_nodes()
    try:
        client = JobSubmissionClient(cluster.gcs.address)
        done = client.submit_job(
            entrypoint=_py("print('done-job')"), metadata={"k": "v"})
        assert _wait_terminal(client, done) == JobStatus.SUCCEEDED
        client.close()
        cluster.gcs._persist_tables()
        cluster.kill_gcs()
        cluster.restart_gcs()
        client = JobSubmissionClient(cluster.gcs.address)
        deadline = time.monotonic() + 30
        info = None
        while time.monotonic() < deadline:
            try:
                info = client.get_job_info(done)
                break
            except (ValueError, OSError):
                time.sleep(0.05)
        assert info is not None, "job record lost across GCS restart"
        assert info.status == JobStatus.SUCCEEDED
        assert info.metadata == {"k": "v"}
        client.close()
    finally:
        cluster.shutdown()


# --------------------------------------------------------------------------- #
# tests/test_jobs.py: JobAdmission (unit) and env hashing
# --------------------------------------------------------------------------- #


def test_job_admission_stride_fairness():
    from ray_tpu_torch.jobs.tenancy import JobAdmission

    adm = JobAdmission()
    adm.register("gold", {"name": "g", "tier": "gold"})     # weight 8
    adm.register("bronze", {"name": "b", "tier": "bronze"})  # weight 1
    grants = {"gold": 0, "bronze": 0}
    for _ in range(90):
        winner = adm.order(["gold", "bronze"])[0]
        assert adm.admit(winner) == 0.0
        grants[winner] += 1
    assert grants == {"gold": 80, "bronze": 10}


def test_job_admission_rate_quota_and_refund():
    from ray_tpu_torch.jobs.tenancy import JobAdmission

    adm = JobAdmission()
    adm.register("metered", {"name": "m", "rps_limit": 1.0, "burst": 2.0})
    now = 100.0
    assert adm.admit("metered", now=now) == 0.0
    assert adm.admit("metered", now=now) == 0.0
    assert adm.admit("metered", now=now) > 0.0  # burst exhausted
    adm.refund("metered")
    assert adm.admit("metered", now=now) == 0.0
    assert adm.admit("anon") == 0.0
    adm.unregister("anon")
    adm.unregister("metered")
    assert adm.snapshot() == {}


def test_env_hash_stability():
    from ray_tpu.core.runtime_env import env_hash as ref_env_hash
    from ray_tpu_torch.core.runtime_env import env_hash

    assert env_hash(None) == ""
    assert env_hash({}) == ""
    a = env_hash({"env_vars": {"A": "1", "B": "2"}, "preimports": ["x", "y"]})
    b = env_hash({"preimports": ["y", "x"], "env_vars": {"B": "2", "A": "1"}})
    assert a == b, "env_hash must canonicalize ordering"
    assert a != env_hash({"env_vars": {"A": "1"}})
    assert len(a) == 16
    # The same environment keys the same worker pools in both packages.
    assert a == ref_env_hash({"env_vars": {"A": "1", "B": "2"},
                              "preimports": ["x", "y"]})


@pytest.mark.parametrize("scheme", ["ray://", "http://", ""])
def test_client_accepts_each_address_form(scheme):
    address = ray_tpu_torch._global_runtime.gcs.address
    client = JobSubmissionClient(scheme + address)
    sid = client.submit_job(entrypoint="true",
                            submission_id=f"form-{scheme[:-3] or 'bare'}")
    assert _wait_terminal(client, sid) == JobStatus.SUCCEEDED
    assert sid in [j.submission_id for j in client.list_jobs()]
    assert client.delete_job(sid)
    client.close()


def test_tail_job_logs_streams_while_the_job_runs(tmp_path):
    """`tail_job_logs` yields a line while the job still runs (the job
    waits for a file the test makes only after reading it), then the rest
    once it ends."""
    gate = str(tmp_path / "gate")
    client = _client()
    sid = client.submit_job(entrypoint=_py(
        "import os, time\n"
        "print('one')\n"
        f"while not os.path.exists({gate!r}):\n"
        "    time.sleep(0.01)\n"
        "print('two')"))
    chunks = []
    for chunk in client.tail_job_logs(sid, poll_s=0.02):
        chunks.append((chunk, client.get_job_status(sid)))
        if "one" in chunk:
            open(gate, "w").close()
    assert chunks[0] == ("one\n", JobStatus.RUNNING), chunks
    assert "".join(c for c, _ in chunks) == "one\ntwo\n"
    assert client.get_job_status(sid) == JobStatus.SUCCEEDED
    client.close()


# --------------------------------------------------------------------------- #
# tests/test_cluster_services.py: submission end to end, on both paths
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("legacy", [False, True], ids=["agent", "legacy"])
def test_job_submission_end_to_end(legacy):
    client = _client()
    with _legacy_manager(legacy):
        sid = client.submit_job(
            entrypoint=_py(
                "import ray_tpu_torch; ray_tpu_torch.init()\n"
                "print('job says hi')\n"
                "ray_tpu_torch.shutdown()"),
            metadata={"owner": "test"})
        first = client.get_job_status(sid)
        status = _wait_terminal(client, sid)
        logs = client.get_job_logs(sid)
        assert status == JobStatus.SUCCEEDED, \
            f"status={status} logs={logs[-800:]}"
        assert "job says hi" in logs
        # The agent's record says SUBMITTED until its driver runs, the
        # legacy manager's PENDING.
        assert first in ((JobStatus.PENDING if legacy else JobStatus.SUBMITTED),
                         JobStatus.RUNNING, JobStatus.SUCCEEDED)
        info = client.get_job_info(sid)
        assert info.metadata["owner"] == "test"
        assert info.start_time <= info.end_time
        assert any(j.submission_id == sid for j in client.list_jobs())
        assert client.delete_job(sid)
        with pytest.raises(ValueError):
            client.get_job_info(sid)
    client.close()


@pytest.mark.parametrize("legacy", [False, True], ids=["agent", "legacy"])
def test_job_stop_and_failure_status(legacy):
    client = _client()
    with _legacy_manager(legacy):
        fail_id = client.submit_job(entrypoint=_py("raise SystemExit(3)"))
        assert _wait_terminal(client, fail_id) == JobStatus.FAILED
        assert "code 3" in client.get_job_info(fail_id).message

        slow_id = client.submit_job(entrypoint=_py(
            "import time; print('napping'); time.sleep(60)"))
        _wait_logs(client, slow_id, "napping")
        assert client.get_job_status(slow_id) == JobStatus.RUNNING
        assert not client.delete_job(slow_id)  # not terminal yet
        assert client.stop_job(slow_id)
        assert _wait_terminal(client, slow_id, 30) == JobStatus.STOPPED
        assert not client.stop_job(slow_id)  # already terminal
        assert client.delete_job(slow_id)
        assert client.delete_job(fail_id)
    client.close()


def _leaked_pids(mark: str):
    """Pids whose /proc cmdline carries `mark` (put inside the `python -c`
    source, so it lands in the grandchild's argv under the sh wrapper)."""
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read()
        except OSError:
            continue
        if mark.encode() in cmdline:
            pids.append(pid)
    return pids


def _trapping_job(jm, mark: str) -> str:
    """A legacy-manager job that ignores SIGTERM, returned once it has
    said so in its log (the trap is installed)."""
    from ray_tpu_torch.job_submission.manager import JobManager

    assert isinstance(jm, JobManager)
    sid = jm.submit(
        f'{sys.executable} -u -c "import signal, time; '
        f'signal.signal(signal.SIGTERM, signal.SIG_IGN); '
        f"print('trapped'); "
        f'time.sleep(60)  # {mark}"')
    deadline = time.monotonic() + 30
    while "trapped" not in (jm.logs(sid) or "") and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert "trapped" in jm.logs(sid), jm.details(sid)
    return sid


def test_job_manager_shutdown_kills_inflight_spawn(tmp_path):
    """shutdown() racing submit() never orphans an entrypoint: a job still
    PENDING is marked STOPPED and the runner's post-spawn handshake kills
    the group it just made."""
    from ray_tpu_torch.job_submission.manager import JobManager

    mark = "jmorph_" + uuid.uuid4().hex[:12]
    jm = JobManager(gcs_address="127.0.0.1:1", log_dir=str(tmp_path))
    entry = f"{sys.executable} -u -c 'import time; time.sleep(45)  # {mark}'"
    sids = [jm.submit(entry) for _ in range(2)]
    # The first two have started (RUNNING) when shutdown lands; the next
    # two are submitted immediately before it (likely mid-spawn).
    deadline = time.monotonic() + 20
    while any(jm.details(s)["status"] == JobStatus.PENDING for s in sids) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    sids += [jm.submit(entry) for _ in range(2)]
    jm.shutdown()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        details = [jm.details(s) for s in sids]
        if all(d["status"] == JobStatus.STOPPED and d["end_time"]
               for d in details) and not _leaked_pids(mark):
            break
        time.sleep(0.05)
    details = [jm.details(s) for s in sids]
    assert all(d["status"] == JobStatus.STOPPED for d in details), details
    assert all(d["end_time"] for d in details), details
    assert _leaked_pids(mark) == []


def test_job_manager_shutdown_waits_for_kill_delivery(tmp_path):
    """shutdown() returns only once a TERM-trapping driver is dead: the
    killer thread (grace period, then SIGKILL) is joined."""
    from ray_tpu_torch.job_submission.manager import JobManager

    mark = "jmjoin_" + uuid.uuid4().hex[:12]
    jm = JobManager(gcs_address="127.0.0.1:1", log_dir=str(tmp_path))
    _trapping_job(jm, mark)
    jm.shutdown()
    assert _leaked_pids(mark) == [], "entrypoint outlived shutdown()"


def test_job_manager_submit_after_shutdown_raises(tmp_path):
    from ray_tpu_torch.job_submission.manager import JobManager

    jm = JobManager(gcs_address="127.0.0.1:1", log_dir=str(tmp_path))
    jm.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        jm.submit("echo too-late")


def test_job_manager_stop_escalates_past_sigterm_trap(tmp_path):
    """stop() on an entrypoint that ignores SIGTERM escalates to a group
    SIGKILL after the grace period, keyed on the group's liveness (the
    python grandchild outlives the sh wrapper's TERM)."""
    from ray_tpu_torch.job_submission.manager import JobManager

    mark = "jmtrap_" + uuid.uuid4().hex[:12]
    jm = JobManager(gcs_address="127.0.0.1:1", log_dir=str(tmp_path))
    sid = _trapping_job(jm, mark)
    assert jm.stop(sid)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        d = jm.details(sid)
        if d["status"] == JobStatus.STOPPED and d["end_time"] \
                and not _leaked_pids(mark):
            break
        time.sleep(0.05)
    d = jm.details(sid)
    assert d["status"] == JobStatus.STOPPED, d
    assert d["end_time"], "runner never unparked: SIGKILL escalation missing"
    assert _leaked_pids(mark) == [], "TERM-trapping driver outlived SIGKILL"
    jm.shutdown()


def test_legacy_manager_is_built_lazily_under_the_port_names():
    gcs = ray_tpu_torch._global_node.gcs
    manager = gcs.job_manager
    assert manager is gcs.job_manager
    assert os.path.basename(manager._log_dir) == "ray_tpu_torch_jobs"
    from ray_tpu_torch.job_submission.manager import JobManager

    assert isinstance(manager, JobManager)


# --------------------------------------------------------------------------- #
# Parity: the same entrypoints through both packages' job tiers
# --------------------------------------------------------------------------- #


def _gated(gate: str, code: int) -> str:
    """Print, make `gate`.started, wait for `gate` to exist, exit with
    `code`: the test sees RUNNING before the job can end. (The start is
    told by a file: the JAX package's agent holds a driver's last line
    until its next one or its exit.)"""
    return _py("import os, sys, time\n"
               "print('started', flush=True)\n"
               f"open({gate + '.started'!r}, 'w').close()\n"
               f"while not os.path.exists({gate!r}):\n"
               "    time.sleep(0.01)\n"
               "print('leaving', flush=True)\n"
               f"sys.exit({code})")


def _drive(client, status_cls, entrypoint, gate, stop):
    """Submit one job and follow it to its end; returns the statuses seen
    (consecutive repeats merged), its details and its logs."""
    sid = client.submit_job(entrypoint=entrypoint, metadata={"case": "p"},
                            runtime_env={"env_vars": {"PARITY": "1"}})
    seen = [client.get_job_status(sid)]

    def note():
        s = client.get_job_status(sid)
        if s != seen[-1]:
            seen.append(s)
        return s

    deadline = time.monotonic() + 60
    while not os.path.exists(gate + ".started") and \
            time.monotonic() < deadline:
        note()
        time.sleep(0.01)
    assert note() == status_cls.RUNNING, seen
    if stop:
        assert client.stop_job(sid)
    else:
        open(gate, "w").close()
    while note() not in status_cls.TERMINAL and time.monotonic() < deadline:
        time.sleep(0.01)
    # A stopped job's status is set at the stop, before its driver dies
    # and the agent flushes its last lines.
    logs = _wait_logs(client, sid, "started")
    details = vars(client.get_job_info(sid))
    assert client.delete_job(sid)
    return seen, details, logs


def test_job_parity_with_the_jax_package(tmp_path):
    import ray_tpu
    from ray_tpu.job_submission import JobStatus as RefStatus
    from ray_tpu.job_submission import JobSubmissionClient as RefClient

    cases = [("exits_0", 0, False), ("exits_3", 3, False),
             ("stopped", 0, True)]
    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=1)
    try:
        ref_client = RefClient(ray_tpu._global_runtime.gcs.address)
        client = _client()
        for name, code, stop in cases:
            got = {}
            for pkg, c, status_cls in (("ref", ref_client, RefStatus),
                                       ("port", client, JobStatus)):
                gate = str(tmp_path / f"{pkg}_{name}")
                got[pkg] = _drive(c, status_cls, _gated(gate, code), gate,
                                  stop)
            (ref_seen, ref_info, ref_logs), (seen, info, logs) = \
                got["ref"], got["port"]
            # The first read may come after the driver started, in either.
            trim = [s for s in seen if s != JobStatus.SUBMITTED]
            assert trim == [s for s in ref_seen if s != RefStatus.SUBMITTED]
            assert seen[0] in (JobStatus.SUBMITTED, JobStatus.RUNNING)
            assert ref_seen[0] in (RefStatus.SUBMITTED, RefStatus.RUNNING)
            assert trim[-1] == {"exits_0": JobStatus.SUCCEEDED,
                                "exits_3": JobStatus.FAILED,
                                "stopped": JobStatus.STOPPED}[name], name
            drop = ("submission_id", "start_time", "end_time", "node_id",
                    "driver_job_id", "entrypoint")
            assert {k: v for k, v in info.items() if k not in drop} == \
                {k: v for k, v in ref_info.items() if k not in drop}, name
            # Each entrypoint names its own gate file, which is all that
            # differs between the two.
            assert info["entrypoint"].replace("port_", "ref_") == \
                ref_info["entrypoint"]
            assert logs == ref_logs, name
            assert logs.startswith("started\n")
        ref_client.close()
        client.close()
    finally:
        ray_tpu.shutdown()


# --------------------------------------------------------------------------- #
# tests/test_runtime_env_pip.py: offline pip environments
# --------------------------------------------------------------------------- #


def _make_wheel(wheelhouse: str, name: str = "rtpkg", version: str = "1.0",
                value: int = 123) -> str:
    """A wheel is a zip: nothing is fetched from any index."""
    os.makedirs(wheelhouse, exist_ok=True)
    whl = os.path.join(wheelhouse, f"{name}-{version}-py3-none-any.whl")
    dist = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(whl, "w") as zf:
        zf.writestr(f"{name}/__init__.py", f"VALUE = {value}\n")
        zf.writestr(f"{dist}/METADATA",
                    f"Metadata-Version: 2.1\nName: {name}\n"
                    f"Version: {version}\n")
        zf.writestr(f"{dist}/WHEEL",
                    "Wheel-Version: 1.0\nGenerator: test\nRoot-Is-Purelib:"
                    " true\nTag: py3-none-any\n")
        zf.writestr(f"{dist}/RECORD", "")
    return whl


def test_normalize_and_hash(tmp_path):
    from ray_tpu.core.runtime_env import _normalize_pip as ref_normalize
    from ray_tpu_torch.core.runtime_env import _normalize_pip, pip_env_hash

    wh = str(tmp_path / "wheels")
    _make_wheel(wh)
    env = {"pip": ["rtpkg"], "pip_wheelhouse": wh}
    ref_env = dict(env)
    _normalize_pip(env)
    ref_normalize(ref_env)
    assert env == ref_env
    assert env["pip"]["packages"] == ["rtpkg"]
    assert env["pip"]["wheelhouse"] == wh
    assert "pip_wheelhouse" not in env
    h1 = env["pip"]["env_hash"]
    assert h1 == pip_env_hash(env["pip"])
    _make_wheel(wh, name="other")
    assert pip_env_hash(env["pip"]) != h1

    with pytest.raises(ValueError, match="wheelhouse"):
        _normalize_pip({"pip": ["rtpkg"]})
    with pytest.raises(ValueError, match="not a directory"):
        _normalize_pip({"pip": ["x"], "pip_wheelhouse": "/nope/nope"})


def test_pip_env_installs_in_worker(tmp_path):
    """A task with a pip runtime_env imports the wheel's package (and
    torch, from the base install, behind it); a task without it cannot."""
    wh = str(tmp_path / "wheels")
    _make_wheel(wh, value=777)

    @ray_tpu_torch.remote(runtime_env={"pip": ["rtpkg"],
                                       "pip_wheelhouse": wh})
    def with_pkg():
        import importlib.util

        import rtpkg

        return (rtpkg.VALUE, os.environ.get("VIRTUAL_ENV", ""),
                importlib.util.find_spec("torch") is not None)

    @ray_tpu_torch.remote
    def without_pkg():
        try:
            import rtpkg  # noqa: F401

            return "importable"
        except ImportError:
            return "missing"

    value, venv, has_torch = ray_tpu_torch.get(with_pkg.remote(),
                                               timeout=120)
    assert value == 777 and has_torch
    assert "venv-" in venv
    assert ray_tpu_torch.get(without_pkg.remote(), timeout=60) == "missing"
    _, venv2, _ = ray_tpu_torch.get(with_pkg.remote(), timeout=120)
    assert venv2 == venv  # the cached venv, by content hash


def test_pip_env_missing_package_fails_loudly(tmp_path):
    wh = str(tmp_path / "wheels")
    _make_wheel(wh)

    @ray_tpu_torch.remote(runtime_env={"pip": ["no-such-package"],
                                       "pip_wheelhouse": wh})
    def f():
        return 1

    with pytest.raises(Exception, match="runtime_env setup failed|pip install"):
        ray_tpu_torch.get(f.remote(), timeout=120)


def test_pip_env_reaches_the_job_driver_and_its_tasks(tmp_path):
    """A submitted job's pip environment reaches its driver (the venv on
    its PYTHONPATH, ahead of the base install) and the tasks it submits;
    a job whose wheel is missing fails before its driver starts."""
    wh = str(tmp_path / "wheels")
    _make_wheel(wh, value=4242)
    client = _client()
    sid = client.submit_job(
        entrypoint=_py(
            "import os, rtpkg, ray_tpu_torch\n"
            "print('DRIVER', rtpkg.VALUE, 'venv-' in os.environ['VIRTUAL_ENV'])\n"
            "ray_tpu_torch.init()\n"
            "@ray_tpu_torch.remote\n"
            "def task():\n"
            "    import rtpkg\n"
            "    return rtpkg.VALUE\n"
            "print('TASK', ray_tpu_torch.get(task.remote()))\n"
            "ray_tpu_torch.shutdown()"),
        runtime_env={"pip": ["rtpkg"], "pip_wheelhouse": wh})
    status = _wait_terminal(client, sid)
    logs = client.get_job_logs(sid)
    assert status == JobStatus.SUCCEEDED, logs[-800:]
    assert "DRIVER 4242 True" in logs and "TASK 4242" in logs, logs
    bad = client.submit_job(entrypoint="true", runtime_env={
        "pip": ["no-such-package"], "pip_wheelhouse": wh})
    assert _wait_terminal(client, bad) == JobStatus.FAILED
    assert "runtime_env failed" in client.get_job_info(bad).message
    client.close()
