"""The port's chaos plane (`ray_tpu_torch.chaos`) against the JAX
package's, and its faults on the port's runtime.

The schedule is pure Python: the same seed must give the JAX package's
`signatures()` and `describe()`. The runner executes exactly the scheduled
log; the RPC fault filter's error, drop and delay windows and the hang
watchdog's attribution work in this process. The fault cases share one
module-scoped `Cluster` (a head of 4 CPUs, the driver connected) whose GCS
marks a silent node dead within about 2 s (heartbeats every 0.1 s, health
checks every 0.2 s, 10 missed): a worker kill under actor load, a
node kill under task load, and a training gang killed when the driver has
seen its checkpoint (an event, not a clock), which resumes from it.
"""

import os
import threading
import time

import pytest
import torch
import torch.distributed as dist

import ray_tpu.chaos as ref_chaos
import ray_tpu_torch
from ray_tpu_torch.chaos import (
    ChaosRunner,
    ChaosSchedule,
    HangWatchdog,
    NodeKillInjector,
    RpcFaultInjector,
    WorkerKillInjector,
    single_event_schedule,
)
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import rpc as rpc_mod
from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.rpc import (
    ConnectionLost,
    RpcClient,
    RpcServer,
    clear_chaos_filter,
    install_chaos_filter,
)
from ray_tpu_torch.train import (
    Checkpoint,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
    session,
)


# ------------------------------------------------------------ determinism

SCHEDULES = [
    dict(seed=1234, kinds={"node_kill": 3.0, "gcs_restart": 1.0,
                           "rpc_faults": 1.0}, period_s=2.0, count=20),
    dict(seed=7, kinds=("worker_kill", "forge_kill"), period_s=0.5,
         count=9, jitter=0.4, start_delay_s=1.5),
    dict(seed=0, kinds=("node_kill",), period_s=3.0, count=10),
    dict(seed=2 ** 40 + 3, kinds={"rpc_faults": 0.25, "worker_kill": 2.0},
         period_s=0.05, count=32, jitter=0.0),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: f"seed{kw['seed']}")
def test_schedule_signatures_equal_the_reference(kw):
    ours, ref = ChaosSchedule(**kw), ref_chaos.ChaosSchedule(**kw)
    assert ours.signatures() == ref.signatures()
    assert ours.describe() == ref.describe()
    again = ChaosSchedule(**kw)
    assert again.signatures() == ours.signatures()
    other = ChaosSchedule(**dict(kw, seed=kw["seed"] + 1))
    assert other.signatures() != ours.signatures()
    kinds = set(kw["kinds"])
    assert all(e.kind in kinds for e in ours.events)
    assert [e.seq for e in ours.events] == list(range(kw["count"]))


@pytest.mark.parametrize("kind", ["worker_kill", "node_kill"])
def test_single_event_schedule_equals_the_reference(kind):
    ours = single_event_schedule(23, kind, at_s=0.25)
    ref = ref_chaos.single_event_schedule(23, kind, at_s=0.25)
    assert ours.signatures() == ref.signatures()
    assert len(ours.events) == 1 and ours.events[0].t == 0.25


class _NullInjector:
    kind = "noop"

    def __init__(self):
        self.seen = []

    def inject(self, event):
        self.seen.append(event.signature())
        return {"ok": True}

    def recovered(self):
        return True


def test_runner_executes_exactly_the_scheduled_log():
    """The executed log IS the schedule, as in the JAX package's runner,
    with the same seeded events (no cluster needed)."""
    logs = []
    for chaos in (ray_tpu_torch.chaos, ref_chaos):
        sched = chaos.ChaosSchedule(seed=7, kinds=("noop",), period_s=0.05,
                                    count=5)
        inj = _NullInjector()
        runner = chaos.ChaosRunner(cluster=None, schedule=sched,
                                   injectors={"noop": inj},
                                   recovery_deadline_s=5)
        with runner:
            assert runner.wait(timeout=10)
        assert runner.executed_signatures == sched.signatures() == inj.seen
        assert runner.faults_injected == 5
        runner.assert_recovered()
        mttr = runner.mttr_by_kind()["noop"]
        assert mttr["count"] == 5 and mttr["max_ms"] < 1000
        logs.append(runner.executed_signatures)
    assert logs[0] == logs[1]


def test_runner_refuses_kinds_without_injector_and_takes_the_deadline():
    sched = ChaosSchedule(seed=1, kinds=("node_kill",), count=1)
    with pytest.raises(ValueError, match="node_kill"):
        ChaosRunner(None, sched, {})
    runner = ChaosRunner(None, sched, {"node_kill": _NullInjector()})
    assert runner.recovery_deadline_s == GLOBAL_CONFIG.chaos_recovery_deadline_s


def test_runner_records_a_stuck_fault():
    class Never(_NullInjector):
        def recovered(self):
            return False

    sched = single_event_schedule(5, "noop", at_s=0.01)
    runner = ChaosRunner(None, sched, {"noop": Never()},
                         recovery_deadline_s=0.2, poll_s=0.02)
    with runner:
        assert runner.wait(timeout=10)
    assert [r.seq for r in runner.stuck_records] == [0]
    with pytest.raises(ray_tpu_torch.chaos.ChaosRecoveryError,
                       match="not recovered"):
        runner.assert_recovered()


# ------------------------------------------------------------ rpc faults


@pytest.fixture()
def rpc_pair():
    server = RpcServer(name="chaos-test")
    server.register("echo", lambda conn, data: data)
    server.start()
    client = RpcClient(server.address, name="chaos-test-client")
    yield server, client
    clear_chaos_filter()
    client.close()
    server.stop()


def test_rpc_filter_error_and_clear(rpc_pair):
    _, client = rpc_pair
    assert client.call("echo", 1) == 1
    install_chaos_filter(lambda name, addr, method: "error")
    with pytest.raises(ConnectionLost):
        client.call("echo", 2)
    clear_chaos_filter()
    assert client.call("echo", 3) == 3   # the connection was never closed


def test_rpc_filter_drop_hits_callers_own_timeout(rpc_pair):
    _, client = rpc_pair
    install_chaos_filter(lambda name, addr, method: "drop")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        client.call("echo", 1, timeout=0.4)
    assert 0.3 < time.monotonic() - t0 < 5.0
    clear_chaos_filter()
    assert client.call("echo", 2) == 2


def test_rpc_filter_delay_and_selectivity(rpc_pair):
    _, client = rpc_pair

    def only_echo_delay(name, addr, method):
        return ("delay", 0.3) if method == "echo" else None

    install_chaos_filter(only_echo_delay)
    t0 = time.monotonic()
    assert client.call("echo", 1) == 1
    assert time.monotonic() - t0 >= 0.3
    clear_chaos_filter()
    assert rpc_mod._CHAOS_FILTER is None


def test_rpc_fault_injector_window(rpc_pair):
    _, client = rpc_pair
    inj = RpcFaultInjector(fraction=1.0, action="error", window_s=0.3,
                           match_methods=("echo",))
    sched = ChaosSchedule(seed=3, kinds=("rpc_faults",), period_s=0.01,
                          count=1)
    assert inj.inject(sched.events[0]) == {
        "action": "error", "fraction": 1.0, "window_s": 0.3}
    assert rpc_mod._CHAOS_FILTER is not None
    with pytest.raises(ConnectionLost):
        client.call("echo", 1)
    assert inj.faults_injected == 1
    assert not inj.recovered()     # the window is still open
    deadline = time.monotonic() + 5
    while not inj.recovered() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert rpc_mod._CHAOS_FILTER is None   # removed with the window
    assert client.call("echo", 2) == 2


# ------------------------------------------------------------- watchdog


def test_hang_watchdog_attributes_tracked_ops():
    wd = HangWatchdog(limit_s=0.3, poll_s=0.05)
    release = threading.Event()
    entered = threading.Event()

    def parked():
        with wd.track("test-op"):
            entered.set()
            release.wait(5.0)

    t = threading.Thread(target=parked, daemon=True)
    with wd:
        t.start()
        assert entered.wait(5)
        deadline = time.monotonic() + 5
        while not wd.hangs and time.monotonic() < deadline:
            time.sleep(0.05)
    release.set()
    t.join()
    assert wd.hang_count == 1 and "test-op" in wd.hangs[0]
    assert "--- thread" in wd.hangs[0]     # every thread's stack attached
    with pytest.raises(AssertionError):
        wd.assert_no_hangs()


def test_hang_watchdog_quiet_on_bounded_ops():
    wd = HangWatchdog(limit_s=0.5, poll_s=0.05)
    with wd:
        for _ in range(5):
            with wd.track("quick"):
                time.sleep(0.02)
    wd.assert_no_hangs()


# ---------------------------------------------------------- chaos e2e


@pytest.fixture(scope="module")
def cluster():
    saved = dict(GLOBAL_CONFIG._overrides)
    GLOBAL_CONFIG._overrides.update({
        "raylet_heartbeat_period_ms": 100,
        "health_check_period_ms": 200,
        "health_check_failure_threshold": 10,
        # Train workers fork from a template that holds torch.
        "worker_forge_preimports": "ray_tpu_torch.core.worker,numpy,torch",
    })
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    c.wait_for_nodes()
    c.connect()
    try:
        yield c
    finally:
        c.shutdown()
        GLOBAL_CONFIG._overrides.clear()
        GLOBAL_CONFIG._overrides.update(saved)


@ray_tpu_torch.remote
def _hold(release_path):
    while not os.path.exists(release_path):
        time.sleep(0.02)
    return "released"


def test_hang_watchdog_reads_the_runtimes_parked_gets(cluster, tmp_path):
    """A driver `get` is a parked op of the port's runtime: the watchdog
    names it once it outlives the limit, and is quiet after it returns."""
    release = str(tmp_path / "release")
    ref = _hold.remote(release)
    got = []
    getter = threading.Thread(
        target=lambda: got.append(ray_tpu_torch.get(ref, timeout=30)),
        daemon=True)
    with HangWatchdog(limit_s=0.3, poll_s=0.05) as wd:
        getter.start()
        deadline = time.monotonic() + 10
        while not wd.hangs and time.monotonic() < deadline:
            time.sleep(0.05)
        open(release, "w").close()
        getter.join(30)
    assert got == ["released"]
    assert wd.hang_count == 1 and wd.hangs[0].startswith("runtime op 'get")
    assert runtime_mod.parked_ops() == []


def test_worker_kill_under_actor_load(cluster):
    """A restartable actor's worker is SIGKILLed; the fault recovers (the
    actor ALIVE again) within the deadline and callers never hang."""

    @ray_tpu_torch.remote(max_restarts=4)
    class Bumper:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n, os.getpid()

    b = Bumper.remote()
    n, pid = ray_tpu_torch.get(b.bump.remote(), timeout=30)
    assert n == 1
    sched = ChaosSchedule(seed=11, kinds=("worker_kill",), period_s=0.05,
                          count=1, jitter=0.0)
    injector = WorkerKillInjector(cluster, actors_only=True)
    runner = ChaosRunner(cluster, sched, {"worker_kill": injector},
                         recovery_deadline_s=30, poll_s=0.02)
    with HangWatchdog(limit_s=45) as wd:
        with runner:
            assert runner.wait(timeout=60)
        # The restarted actor serves again (from a fresh state).
        n2, pid2 = ray_tpu_torch.get(b.bump.remote(), timeout=30)
    runner.assert_recovered()
    wd.assert_no_hangs()
    (rec,) = runner.records
    assert rec.detail == {"pid": pid, "actor": True}
    assert injector._actor_hex == b._actor_id.hex()
    assert pid2 != pid and n2 == 1
    assert runner.mttr_by_kind()["worker_kill"]["count"] == 1
    ray_tpu_torch.kill(b)


@ray_tpu_torch.remote
def _slow_square(x):
    time.sleep(0.2)
    return x * x


def test_node_kill_with_task_load(cluster):
    """A seeded node kill under retried task load: every result correct,
    the fault recovered (victim DEAD, a replacement alive), the executed
    log equal to the schedule, no hang."""
    node_args = {"num_cpus": 2, "resources": {"churn": 2}}
    for _ in range(2):
        cluster.add_node(**node_args)
    cluster.wait_for_nodes()
    before = {r.node_id.hex() for r in cluster.raylets if not r.is_head}
    sched = ChaosSchedule(seed=42, kinds=("node_kill",), period_s=0.3,
                          count=1, jitter=0.0)
    runner = ChaosRunner(
        cluster, sched,
        {"node_kill": NodeKillInjector(cluster, replace=True,
                                       node_args=node_args)},
        recovery_deadline_s=20, poll_s=0.05)
    opts = {"resources": {"churn": 1}, "max_retries": 8}
    try:
        with HangWatchdog(limit_s=30) as wd:
            with runner:
                results = ray_tpu_torch.get(
                    [_slow_square.options(**opts).remote(i)
                     for i in range(16)], timeout=60)
                assert runner.wait(timeout=30)
        assert results == [i * i for i in range(16)]
        runner.assert_recovered()
        wd.assert_no_hangs()
        assert runner.executed_signatures == sched.signatures()
        (rec,) = runner.records
        assert rec.detail["replaced"] and rec.detail["via"] == "inline"
        victim = [h for h in before if h.startswith(rec.detail["node"])]
        assert len(victim) == 1
        dead = {n["NodeID"] for n in cluster.gcs.handle_get_nodes(None)
                if not n["Alive"]}
        assert victim[0] in dead
    finally:
        for r in [r for r in cluster.raylets if not r.is_head]:
            cluster.remove_node(r)


STEPS, CKPT_STEP = 6, 2


def _gang_loop(config):
    """Names each worker's pid in a file and reports every step; rank 0
    reports a checkpoint at step 2. The first attempt (no checkpoint)
    then runs all-reduce rounds instead of ending, so the run cannot end
    before the fault the driver fires on it; if no fault comes within
    `park_s`, the attempt fails."""
    ckpt = session.get_checkpoint()
    start = 0 if ckpt is None else ckpt.to_dict()["step"] + 1
    rank = session.get_world_rank()
    open(os.path.join(config["pid_dir"], f"{start}-{rank}-{os.getpid()}"),
         "w").close()
    for step in range(start, STEPS):
        session.report(
            {"step": step, "start": start, "pid": os.getpid(), "rank": rank,
             "world": session.get_world_size()},
            checkpoint=Checkpoint.from_dict({"step": step})
            if step == CKPT_STEP and rank == 0 else None)
        if ckpt is None and step == CKPT_STEP:
            # Data-parallel rounds past the checkpoint: a rank whose peer
            # is killed fails in its next all-reduce, as in training.
            one = torch.ones(1)
            deadline = time.monotonic() + config["park_s"]
            while time.monotonic() < deadline:
                dist.all_reduce(one)
                time.sleep(0.02)
            raise RuntimeError("the chaos kill never came")


def test_train_gang_elastic_restart_resumes_from_checkpoint(cluster,
                                                            tmp_path):
    """A gang of two train workers; the driver fires a seeded worker kill
    when it has seen rank 0's checkpoint. The gang restarts as a unit and
    resumes at the step after the checkpoint."""
    runner = ChaosRunner(
        cluster, single_event_schedule(3, "worker_kill", at_s=0.01),
        {"worker_kill": WorkerKillInjector(cluster, actors_only=True)},
        recovery_deadline_s=30, poll_s=0.02)
    pid_dir = tmp_path / "pids"
    pid_dir.mkdir()

    def on_report(metrics):
        if metrics["step"] == CKPT_STEP and metrics["start"] == 0:
            runner.start()    # the event: the checkpoint is registered

    trainer = TorchTrainer(
        _gang_loop, device="cpu",
        train_loop_config={"park_s": 30.0, "pid_dir": str(pid_dir)},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="chaos_gang", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1),
                             callbacks=[on_report]))
    with HangWatchdog(limit_s=60) as wd:
        result = trainer.fit()
    assert runner.wait(timeout=30)
    runner.stop()
    assert result.error is None, result.error
    runner.assert_recovered()
    wd.assert_no_hangs()
    first = [m for m in result.metrics_history if m["start"] == 0]
    resumed = [m for m in result.metrics_history if m["start"] > 0]
    assert [m["step"] for m in first] == [0, 1, 2]
    assert [m["step"] for m in resumed] == [3, 4, 5]
    assert {m["world"] for m in resumed} == {2}
    (rec,) = runner.records
    assert rec.detail["actor"] and rec.recovered
    # The killed process was one of the first attempt's two workers, and
    # the resumed gang runs in two fresh ones.
    pids = {}
    for name in os.listdir(pid_dir):
        start, _rank, pid = map(int, name.split("-"))
        pids.setdefault(start, set()).add(pid)
    assert sorted(pids) == [0, CKPT_STEP + 1]
    assert len(pids[0]) == len(pids[CKPT_STEP + 1]) == 2
    assert rec.detail["pid"] in pids[0]
    assert not pids[0] & pids[CKPT_STEP + 1]
    assert result.checkpoint.to_dict() == {"step": CKPT_STEP}
