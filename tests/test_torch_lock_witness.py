"""The port's lock-order witness (`ray_tpu_torch.util.lock_witness`).

Unit layer: the cases of the JAX package's tests/test_race_harness.py on
the port's witness — an ABBA inversion is flagged even when the
interleaving never deadlocks, a consistent order stays quiet, a release by
a thread that never acquired raises before touching the lock, a three-lock
cycle is found, an RLock under a Condition keeps no phantom edge — plus the
hang watchdog and `discard_cycles`. Integration layer: the port's cluster
workload (tasks, actors, waits, puts) and its Serve workload (handle and
HTTP paths on two replicas) each run under the witness in a fresh
interpreter, installed before the runtime makes its first lock, and must
record no lock-order cycle.
"""

import os
import subprocess
import sys
import threading
import time

import pytest

from ray_tpu_torch.util import lock_witness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def witness():
    """The port's witness installed for one test. Where the JAX package's
    witness is installed for the whole session (RAY_TPU_LOCK_WITNESS=1),
    the cycles these tests make on purpose are taken out of its record
    after them: their lock sites name this file."""
    lock_witness.install()
    lock_witness.reset()
    yield lock_witness
    lock_witness.reset()
    lock_witness.uninstall()
    lock_witness._watchdog_s = None
    if os.environ.get("RAY_TPU_LOCK_WITNESS") == "1":
        from ray_tpu.util import lock_witness as session_witness

        session_witness.discard_cycles(os.path.basename(__file__))


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join()


def test_witness_flags_abba_inversion(witness):
    a = threading.Lock()
    b = threading.Lock()

    def order_ab():
        with a:
            with b:
                pass

    def order_ba():
        with b:
            with a:
                pass

    _in_thread(order_ab)
    _in_thread(order_ba)
    rep = witness.report()
    assert len(rep.cycles) == 1, "ABBA inversion must be reported once"
    assert "lock-order inversion" in rep.cycles[0]
    assert os.path.basename(__file__) in rep.cycles[0]
    assert rep.locks_tracked >= 2 and rep.edges == 2


def test_witness_quiet_on_consistent_order(witness):
    a, b, c = threading.Lock(), threading.Lock(), threading.Lock()

    def ordered():
        with a:
            with b:
                with c:
                    pass

    threads = [threading.Thread(target=ordered) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rep = witness.report()
    assert rep.cycles == []
    assert rep.edges == 3       # a->b, a->c, b->c


def test_witness_mismatched_release_raises(witness):
    """A release by a thread that never recorded the acquire raises before
    the inner lock is touched: the owner can still release it."""
    lock = threading.Lock()
    lock.acquire()
    errors = []

    def rogue_release():
        try:
            lock.release()
        except RuntimeError as e:
            errors.append(e)

    _in_thread(rogue_release)
    assert len(errors) == 1
    assert "never acquired" in str(errors[0])
    assert lock.locked()
    lock.release()
    assert not lock.locked()


def test_witness_three_lock_cycle(witness):
    a, b, c = threading.Lock(), threading.Lock(), threading.Lock()
    for first, second in [(a, b), (b, c), (c, a)]:
        def run(x=first, y=second):
            with x:
                with y:
                    pass
        _in_thread(run)
    rep = witness.report()
    assert len(rep.cycles) == 1, "A->B->C->A cycle must be reported"
    assert rep.cycles[0].count(os.path.basename(__file__)) >= 3


def test_witness_rlock_and_condition(witness):
    lock = threading.RLock()
    cond = threading.Condition(lock)
    waiting = threading.Event()
    done = []

    def waiter():
        with cond:
            waiting.set()
            cond.wait(timeout=5)
            done.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    waiting.wait(5)
    with cond:          # the waiter has released the lock inside wait()
        cond.notify_all()
    t.join()
    assert done == [True]
    assert witness.report().cycles == []


def test_witness_watchdog_dumps_a_blocked_acquire(witness, capfd):
    witness.install(watchdog_s=0.2)
    lock = threading.Lock()
    held, release = threading.Event(), threading.Event()

    def holder():
        with lock:
            held.set()
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(5)
    threading.Timer(0.6, release.set).start()
    t0 = time.monotonic()
    with lock:
        waited = time.monotonic() - t0
    t.join()
    err = capfd.readouterr().err
    assert waited >= 0.5
    assert "[lock_witness] acquire blocked >0.2s" in err
    assert "Thread" in err          # the thread dump follows


def test_witness_discard_cycles_by_site(witness):
    a, b = threading.Lock(), threading.Lock()
    for x, y in ((a, b), (b, a)):
        _in_thread(lambda x=x, y=y: [x.acquire(), y.acquire(),
                                     y.release(), x.release()])
    assert len(witness.report().cycles) == 1
    assert witness.discard_cycles("no-such-file.py") == 0
    assert witness.discard_cycles(os.path.basename(__file__)) == 1
    assert witness.report().cycles == []


def test_witness_locks_made_before_install_are_plain():
    lock_witness.uninstall()
    before = threading.Lock()
    lock_witness.install()
    try:
        after = threading.Lock()
        assert not isinstance(before, lock_witness._WitnessBase)
        assert isinstance(after, lock_witness._WitnessLock)
        assert isinstance(threading.RLock(), lock_witness._WitnessRLock)
    finally:
        lock_witness.uninstall()
    assert threading.Lock is lock_witness._real_lock


_CLUSTER_WORKLOAD = """
import sys
sys.path.insert(0, {repo!r})
from ray_tpu_torch.util import lock_witness
lock_witness.install(watchdog_s=60.0)

import ray_tpu_torch as rt
rt.init(num_cpus=2, num_gpus=1)

@rt.remote
def sq(x):
    return x * x

@rt.remote
class Acc:
    def __init__(self):
        self.total = 0
    def add(self, v):
        self.total += v
        return self.total

refs = [sq.remote(i) for i in range(40)]
ready, rest = rt.wait(refs, num_returns=10, timeout=60)
assert len(ready) == 10
vals = rt.get(refs)
acc = Acc.remote()
outs = rt.get([acc.add.remote(v) for v in vals[:10]])
gpu = Acc.options(num_gpus=1).remote()
assert rt.get(gpu.add.remote(3)) == 3
big = rt.put(list(range(100000)))
assert len(rt.get(big)) == 100000
rt.shutdown()

rep = lock_witness.report()
print("LOCKS", rep.locks_tracked, "EDGES", rep.edges)
for c in rep.cycles:
    print("CYCLE", c)
print("WITNESS DONE", len(rep.cycles))
"""


_SERVE_WORKLOAD = """
import sys
sys.path.insert(0, {repo!r})
from ray_tpu_torch.util import lock_witness
lock_witness.install(watchdog_s=60.0)

import json
import urllib.request

import ray_tpu_torch as rt
from ray_tpu_torch import serve

rt.init(num_cpus=4)

@serve.deployment(num_replicas=2, max_concurrent_queries=8)
class Echo:
    def __call__(self, payload):
        return {{"echo": payload}}

handle = serve.run(Echo.bind())
# Handle path (router reserve/release + reaper) and HTTP path (proxy
# light lane + slot ownership) exercise the serve control plane's locks.
refs = [handle.remote(i) for i in range(60)]
port = serve.http_port()
for i in range(20):
    req = urllib.request.Request(
        f"http://127.0.0.1:{{port}}/Echo", data=json.dumps(i).encode(),
        headers={{"Content-Type": "application/json"}})
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert json.loads(resp.read()) == {{"result": {{"echo": i}}}}
assert len(rt.get(refs)) == 60
serve.shutdown()
rt.shutdown()

rep = lock_witness.report()
print("LOCKS", rep.locks_tracked, "EDGES", rep.edges)
for c in rep.cycles:
    print("CYCLE", c)
print("WITNESS DONE", len(rep.cycles))
"""


@pytest.mark.parametrize("workload", ["cluster", "serve"])
def test_port_control_plane_has_no_lock_order_cycles(workload):
    """A real workload of the port under the witness, in a fresh
    interpreter (patching must precede the runtime's first lock)."""
    script = {"cluster": _CLUSTER_WORKLOAD,
              "serve": _SERVE_WORKLOAD}[workload].format(repo=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, RAY_TPU_TORCH_LOG_LEVEL="WARNING"))
    assert proc.returncode == 0, (proc.stdout[-800:], proc.stderr[-2000:])
    assert "WITNESS DONE 0" in proc.stdout, proc.stdout[-2000:]
    locks = int(proc.stdout.split("LOCKS ")[1].split()[0])
    assert locks > 50, proc.stdout[-500:]     # the runtime's locks, watched
