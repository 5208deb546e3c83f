"""The port's copied services on the CPU: the ray:// client server, the
dashboard, object spilling and the GPU accelerator registry; and three
runtime behaviours run through both packages.

One module-scoped port runtime (4 CPUs and one GPU, which without a card
is a grant only). The client, dashboard and spilling cases are those of
tests/test_client.py, tests/test_cluster_services.py's dashboard test and
tests/test_object_store.py, each under the name of the reference test it
mirrors. `util/accelerators` is held to the reference's GPU constants, its
node shapes to their bundles, and `ScalingConfig(topology=)` to its
workers.

The runtime behaviours (ROADMAP's pinned list) are the reference's, and
each test asserts them for a cluster of each package in this process: a
killed worker's accelerator is granted again before its process has
exited; an actor's own actors outlive it (actors are reaped per job); an
owner that exits leaves the objects it owns in the store.
"""

import importlib
import json
import os
import subprocess
import sys
import textwrap
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.core.ids import JobID, ObjectID, TaskID
from ray_tpu_torch.core.object_store import (ObjectStoreClient,
                                             ObjectStoreFullError,
                                             SharedMemoryStore)
from ray_tpu_torch.train.worker_group import process_exited

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    created = ray_tpu_torch._global_runtime
    yield created
    if ray_tpu_torch._global_runtime is created:
        ray_tpu_torch.shutdown()


# --------------------------------------------------------------------------- #
# tests/test_client.py: ray:// client mode
# --------------------------------------------------------------------------- #

CLIENT_SCRIPT = textwrap.dedent("""
    import json, sys
    import ray_tpu_torch

    ray_tpu_torch.init(address="ray://" + sys.argv[1])

    @ray_tpu_torch.remote
    def square(x):
        return x * x

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start):
            self.n = start
        def bump(self, by=1):
            self.n += by
            return self.n

    out = {}
    out["tasks"] = ray_tpu_torch.get([square.remote(i) for i in range(5)])
    big = ray_tpu_torch.put(list(range(50000)))     # the proxy's put path
    out["big_len"] = len(ray_tpu_torch.get(big))
    c = Counter.options(name="cli-counter").remote(10)
    out["bumps"] = [ray_tpu_torch.get(c.bump.remote()) for _ in range(3)]
    again = ray_tpu_torch.get_actor("cli-counter")
    out["named"] = ray_tpu_torch.get(again.bump.remote(5))
    ready, pending = ray_tpu_torch.wait([square.remote(9)], timeout=30)
    out["wait_ready"] = len(ready)
    try:
        ray_tpu_torch.get(square.remote("nope"), timeout=30)
        out["error"] = "MISSED"
    except TypeError:
        out["error"] = "TypeError"
    out["nodes"] = len([n for n in ray_tpu_torch.nodes() if n["Alive"]])
    out["torch_imported"] = "torch" in sys.modules
    print("RESULT:" + json.dumps(out))
    ray_tpu_torch.shutdown()
""")


def test_client_mode_end_to_end(tmp_path):
    gcs_address = ray_tpu_torch._global_runtime.gcs.address
    script = tmp_path / "client.py"
    script.write_text(CLIENT_SCRIPT)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, str(script), gcs_address],
                          capture_output=True, text=True, timeout=240,
                          env=env)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT:")), None)
    assert line, f"stdout={proc.stdout[-500:]} stderr={proc.stderr[-1500:]}"
    out = json.loads(line[len("RESULT:"):])
    assert out == {"tasks": [0, 1, 4, 9, 16], "big_len": 50000,
                   "bumps": [11, 12, 13], "named": 18, "wait_ready": 1,
                   "error": "TypeError", "nodes": 1,
                   "torch_imported": False}


def _client_server_address():
    from ray_tpu_torch.client.server import CLIENT_SERVER_KV_KEY

    return ray_tpu_torch._global_runtime.gcs.call(
        "kv_get", {"namespace": "cluster",
                   "key": CLIENT_SERVER_KV_KEY})["value"].decode()


def _nap():
    time.sleep(3)
    return "done"


def test_client_cancel_and_sliced_get():
    """A get longer than one server slice still completes (the client
    loops bounded slices)."""
    from ray_tpu_torch.client import ClientRuntime
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.core.common import TaskSpec

    client = ClientRuntime(_client_server_address())
    client._SLICE_S = 1.0  # force several slices
    try:
        fn_id = client.export_function(serialization.dumps(_nap))
        spec = TaskSpec(task_id=TaskID.for_task(client.job_id),
                        job_id=client.job_id, name="nap",
                        function_id=fn_id, function_blob=None,
                        resources={"CPU": 1.0})
        (oid,) = client.submit_task(spec)
        assert client.get([oid], timeout=60) == ["done"]  # > 2 slices
    finally:
        client.shutdown()


def test_client_refs_released_on_disconnect():
    """The server registers refs per client and drops them when the
    client's connection closes."""
    from ray_tpu_torch.client import ClientRuntime

    client = ClientRuntime(_client_server_address())
    oid = client.put([1, 2, 3])
    assert client.get([oid]) == [[1, 2, 3]]
    server = ray_tpu_torch._global_node.client_server
    assert any(oid.binary() in refs
               for refs in server._client_refs.values())
    client.shutdown()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            oid.binary() in refs for refs in server._client_refs.values()):
        time.sleep(0.02)
    assert not any(oid.binary() in refs
                   for refs in server._client_refs.values())


# --------------------------------------------------------------------------- #
# tests/test_cluster_services.py: the dashboard
# --------------------------------------------------------------------------- #


def _fetch(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def test_dashboard_routes():
    from ray_tpu_torch.util.metrics import Gauge

    info = ray_tpu_torch.init(ignore_reinit_error=True)
    url = info["dashboard_url"]
    assert url, "head node did not start a dashboard"
    Gauge("dash_test_gauge", "x").set(11)
    ray_tpu_torch._global_runtime._metrics_pusher.flush()

    nodes = json.loads(_fetch(url + "/api/nodes"))
    assert any(n["Alive"] for n in nodes)
    assert "dash_test_gauge" in _fetch(url + "/metrics").decode()
    snap = json.loads(_fetch(url + "/api/metrics"))
    assert any(m["name"] == "dash_test_gauge"
               for series in snap.values() for m in series)
    assert "ray_tpu_torch cluster" in _fetch(url).decode()
    res = json.loads(_fetch(url + "/api/cluster_resources"))
    assert res["total"]["CPU"] == 4 and res["total"]["GPU"] == 1
    jobs = json.loads(_fetch(url + "/api/jobs"))
    assert jobs["submissions"] == []
    assert ray_tpu_torch._global_runtime.job_id.hex() in [
        j["JobID"] for j in jobs["driver_jobs"] if j["State"] == "RUNNING"]


# --------------------------------------------------------------------------- #
# tests/test_object_store.py: spilling to disk and to a bucket
# --------------------------------------------------------------------------- #


def make_oid(i=1):
    return ObjectID.for_return(TaskID.for_task(JobID.from_int(1)), i)


@pytest.fixture()
def spill_dir(tmp_path):
    return str(tmp_path / "spill")


def test_capacity_and_spill(spill_dir):
    """Past capacity the oldest unpinned objects spill to disk and restore
    on access, byte for byte."""
    oids = [make_oid(i + 1) for i in range(8)]
    small = SharedMemoryStore(f"tsp{np.random.randint(1 << 30)}",
                              capacity_bytes=4 << 20, spill_dir=spill_dir)
    try:
        for i, oid in enumerate(oids):
            small.put_value(oid, np.full(1 << 20, i, dtype=np.uint8))
        assert small.stats()["num_spilled"] >= 4
        assert os.listdir(spill_dir)
        client = ObjectStoreClient(small._session)
        try:
            for i, oid in enumerate(oids):
                assert small.get_buffer(oid) is not None
                got = client.get_value(oid)
                assert got.shape == (1 << 20,) and (got == i).all()
        finally:
            client.close()
    finally:
        small.shutdown()


def test_oversize_object_rejected():
    tiny = SharedMemoryStore(f"tso{np.random.randint(1 << 30)}",
                             capacity_bytes=1 << 20)
    try:
        with pytest.raises(ObjectStoreFullError):
            tiny.put_value(make_oid(), np.zeros(1 << 21, dtype=np.uint8))
    finally:
        tiny.shutdown()


def test_pinned_objects_not_spilled(spill_dir):
    small = SharedMemoryStore(f"tpp{np.random.randint(1 << 30)}",
                              capacity_bytes=3 << 20, spill_dir=spill_dir)
    try:
        a = make_oid(1)
        small.put_value(a, np.zeros(1 << 20, dtype=np.uint8))
        small.pin(a)
        for i in range(2, 5):
            small.put_value(make_oid(i), np.zeros(1 << 20, dtype=np.uint8))
        assert small._objects[a].shm is not None  # still in shared memory
        assert small.stats()["num_spilled"] >= 1
    finally:
        small.shutdown()


def test_spill_to_cloud_storage_roundtrip():
    """Spill targets a bucket URI through the storage backends: evicted
    bytes leave the machine and restore on access."""
    from ray_tpu_torch.train.storage import MemoryBackend

    MemoryBackend.clear()
    store = SharedMemoryStore(f"tcs{np.random.randint(1 << 30)}",
                              capacity_bytes=3 * 1024 * 1024,
                              spill_dir="memory://spillbkt/objs")
    try:
        oids, blobs = [], []
        for i in range(3):
            oid = ObjectID.from_random()
            blob = np.full(1024 * 1024, i, dtype=np.uint8).tobytes()
            buf = store.create(oid, len(blob))
            buf[:] = blob
            store.seal(oid)
            oids.append(oid)
            blobs.append(blob)
        extra = ObjectID.from_random()  # forces the first one out
        buf = store.create(extra, 1024 * 1024)
        buf[:] = b"\xaa" * (1024 * 1024)
        store.seal(extra)
        deadline = time.monotonic() + 10  # the upload runs off the lock
        while time.monotonic() < deadline and \
                not MemoryBackend("spillbkt").list("objs"):
            time.sleep(0.02)
        assert MemoryBackend("spillbkt").list("objs"), \
            "nothing spilled to the bucket"
        assert store.get_bytes(oids[0]) == blobs[0]
        assert store.get_bytes(oids[1]) == blobs[1]
        names_before = MemoryBackend("spillbkt").list("objs")
        for oid in oids + [extra]:
            store.delete(oid)
        assert not MemoryBackend("spillbkt").list("objs"), names_before
    finally:
        store.shutdown()
        MemoryBackend.clear()


def test_default_spill_dir_uses_the_temp_dir(monkeypatch, tmp_path):
    """Without a spill_dir the store spills under the temp dir (the
    reference's under /tmp, shared by every cluster), under the port's
    own name."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    store = SharedMemoryStore(f"tdd{np.random.randint(1 << 30)}",
                              capacity_bytes=2 << 20)
    try:
        for i in range(4):
            store.put_value(make_oid(i + 1), np.zeros(1 << 20, np.uint8))
        assert store.stats()["num_spilled"] >= 2
        assert os.listdir(tmp_path / "ray_tpu_torch_spill")
    finally:
        store.shutdown()


# --------------------------------------------------------------------------- #
# util/accelerators and ScalingConfig.topology
# --------------------------------------------------------------------------- #


def test_gpu_constants_equal_the_reference():
    from ray_tpu.util import accelerators as ref
    from ray_tpu_torch.util import accelerators as acc

    names = [n for n in dir(ref) if n.startswith("NVIDIA_")]
    assert names == sorted(n for n in dir(acc) if n.startswith("NVIDIA_"))
    assert {n: getattr(acc, n) for n in names} == \
        {n: getattr(ref, n) for n in names}
    # Every generation names one of them, as nvidia-smi spells it.
    assert sorted(g.accelerator_type for g in acc.GPU_GENERATIONS.values()) \
        == sorted(getattr(ref, n) for n in names)
    h100 = acc.GPU_GENERATIONS["h100"]
    assert (h100.compute_capability, h100.memory_gb, h100.sms,
            h100.gpus_per_host) == ((9, 0), 80, 132, 8)


@pytest.mark.parametrize("shape,gen,cards,hosts,bundle", [
    ("h100-16", "h100", 16, 2, {"CPU": 1.0, "GPU": 8.0}),
    ("H100-8", "h100", 8, 1, {"CPU": 1.0, "GPU": 8.0}),
    ("h100-1", "h100", 1, 1, {"CPU": 1.0, "GPU": 1.0}),
    ("a100-32", "a100", 32, 4, {"CPU": 1.0, "GPU": 8.0}),
    ("a10g-2", "a10g", 2, 1, {"CPU": 1.0, "GPU": 2.0}),
    ("t4-8", "t4", 8, 2, {"CPU": 1.0, "GPU": 4.0}),
])
def test_node_shapes(shape, gen, cards, hosts, bundle):
    from ray_tpu_torch.util import accelerators as acc

    assert acc.parse_shape(shape) == (gen, cards)
    assert acc.shape_gpu_count(shape) == cards
    assert acc.shape_host_count(shape) == hosts
    assert acc.shape_bundles(shape) == [bundle] * hosts
    assert acc.shape_bundles(shape, cpus_per_host=4)[0]["CPU"] == 4


@pytest.mark.parametrize("bad", ["v4-32", "h100", "h100-12", "h100-0",
                                 "b200-8"])
def test_node_shape_errors(bad):
    from ray_tpu_torch.util import accelerators as acc

    with pytest.raises(ValueError):
        acc.parse_shape(bad)


def test_detect_local_generation(tmp_path):
    """The generation comes from nvidia-smi's card name (a stand-in
    script here); None without nvidia-smi or for an unknown card."""
    from ray_tpu_torch.util import accelerators as acc

    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3'\n"
                    "echo 'NVIDIA H100 80GB HBM3'\n")
    fake.chmod(0o755)
    assert acc.detect_local_generation(str(fake)) == "h100"
    assert acc.detect_local_generation(str(tmp_path / "absent")) is None
    for name, gen in [("Tesla V100-SXM2-32GB", "v100"), ("Tesla T4", "t4"),
                      ("NVIDIA A100-SXM4-80GB", "a100"),
                      ("NVIDIA A10G", "a10g"), ("NVIDIA GH200 480GB", None)]:
        assert acc.generation_of(name) == gen, name
    # It imports no torch: a fresh interpreter asks it.
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; from ray_tpu_torch.util.accelerators import "
         "detect_local_generation as d; d(); print('torch' in sys.modules)"],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert out.stdout.strip() == "False", out.stderr


def test_scaling_config_topology():
    from ray_tpu.train.config import ScalingConfig as RefScalingConfig
    from ray_tpu_torch.train import ScalingConfig

    sc = ScalingConfig(topology="h100-16")
    assert (sc.num_workers, sc.gpus_per_worker, sc.use_gpu,
            sc.placement_strategy) == (2, 8, True, "STRICT_SPREAD")
    assert sc.as_placement_group_bundles() == [{"CPU": 1.0, "GPU": 8.0}] * 2
    # The reference's slice gives the same layout in TPU chips.
    ref = RefScalingConfig(topology="v4-64")
    assert (ref.num_workers, ref.tpus_per_worker, ref.placement_strategy) \
        == (8, 4, "STRICT_SPREAD")
    assert ScalingConfig(topology="h100-4").num_workers == 1
    assert ScalingConfig().topology is None


# --------------------------------------------------------------------------- #
# Runtime behaviours of both packages (ROADMAP's pinned list)
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def packages():
    """Both packages' clusters, up at once: (module, accelerator resource
    option) for each."""
    ray_tpu.init(num_cpus=4, num_tpus=1)
    try:
        yield [(ray_tpu, "num_tpus"), (ray_tpu_torch, "num_gpus")]
    finally:
        ray_tpu.shutdown()


class HeldExit:
    """An actor whose process, once told to exit, waits for a file first
    (as a worker tearing down a large device context does)."""

    def hold_exit(self, release):
        real_exit = os._exit

        def held(code):
            deadline = time.monotonic() + 60
            while not os.path.exists(release) and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            real_exit(code)

        os._exit = held
        return os.getpid()


def _accelerator_task():
    return os.getpid()


def _wait_exited(pid, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not process_exited(pid) and time.monotonic() < deadline:
        time.sleep(0.01)
    return process_exited(pid)


def test_killed_worker_resources_granted_before_it_exits(packages,
                                                        tmp_path):
    for mod, accel in packages:
        release = str(tmp_path / f"release_{mod.__name__}")
        holder = mod.remote(**{accel: 1})(HeldExit).remote()
        pid = mod.get(holder.hold_exit.remote(release), timeout=60)
        mod.kill(holder)
        # The accelerator is granted again while the killed process still
        # lives: its exit waits for `release`, made only after the grant.
        task_pid = mod.get(mod.remote(**{accel: 1})(
            _accelerator_task).remote(), timeout=60)
        assert not process_exited(pid), mod.__name__
        assert task_pid != pid
        open(release, "w").close()
        assert _wait_exited(pid), mod.__name__


class Parent:
    def spawn(self, pkg, name):
        mod = importlib.import_module(pkg)
        self.child = mod.remote(Child).options(name=name).remote()
        assert mod.get(self.child.ping.remote()) == "pong"
        return os.getpid()


class Child:
    def ping(self):
        return "pong"

    def pid(self):
        return os.getpid()


def test_actors_reaped_per_job_not_with_their_owner(packages):
    for mod, _ in packages:
        parent = mod.remote(Parent).remote()
        name = f"gap-child-{mod.__name__}"
        parent_pid = mod.get(parent.spawn.remote(mod.__name__, name),
                             timeout=60)
        mod.kill(parent)
        assert _wait_exited(parent_pid), mod.__name__
        with pytest.raises(Exception):
            mod.get(parent.spawn.remote(mod.__name__, name), timeout=30)
        # The child, owned by the dead actor, lives on in this job.
        child = mod.get_actor(name)
        assert mod.get(child.ping.remote(), timeout=30) == "pong"
        child_pid = mod.get(child.pid.remote(), timeout=30)
        mod.kill(child)
        assert _wait_exited(child_pid), mod.__name__


class Owner:
    def hold(self, pkg):
        mod = importlib.import_module(pkg)
        self.ref = mod.put(np.zeros(1 << 21, dtype=np.uint8))
        return self.ref.binary(), os.getpid()


def test_exited_owner_leaves_its_objects_in_the_store(packages):
    for mod, _ in packages:
        ids = importlib.import_module(f"{mod.__name__}.core.ids")
        owner = mod.remote(Owner).remote()
        oid_b, pid = mod.get(owner.hold.remote(mod.__name__), timeout=60)
        oid = ids.ObjectID(oid_b)
        store = mod._global_node.raylet.store
        assert store.contains(oid), mod.__name__
        owner.__ray_terminate__()  # a graceful exit
        assert _wait_exited(pid), mod.__name__
        raylet = mod._global_node.raylet
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and any(
                h.pid == pid and h.state != "dead"
                for h in list(raylet.pool._workers.values())):
            time.sleep(0.01)
        # A round trip through the cluster after the raylet buried it.
        assert mod.get(mod.remote(_accelerator_task).remote(),
                       timeout=60) != pid
        assert store.contains(oid), mod.__name__
