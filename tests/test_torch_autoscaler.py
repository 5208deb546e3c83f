"""The port's autoscaler (`ray_tpu_torch.autoscaler`): the GCE GPU-VM
provider's REST bodies, its fake clouds, and the reconcile loop's
decisions against the JAX package's.

`GCEGPUNodeProvider` speaks Compute Engine's `instances` API for A3 VMs
(`a3-highgpu-<n>g`, n H100s); the bodies are checked key by key. The
decision tests drive the JAX package's `StandardAutoscaler` and the port's
with the same inputs: a scripted GCS and clock (every branch: launch,
packing, the max, dead-node replacement, the launch grace, idle
scale-down, min_workers), and real clusters of each package under
`LocalNodeProvider` with the same `request_resources` sequence. The
end-to-end cases run on the CPU: in-process raylets behind
`FakeGPUTransport`, and a worker daemon started by the VM's startup
script itself (`SubprocessFakeGPUTransport`, `python -m ray_tpu_torch
start --address=...`).
"""

import os
import subprocess
import sys
import time
import urllib.parse

import pytest

import ray_tpu
import ray_tpu.autoscaler.autoscaler as ref_autoscaler
import ray_tpu.cluster_utils as ref_cluster_utils
import ray_tpu_torch
import ray_tpu_torch.autoscaler.autoscaler as port_autoscaler
import ray_tpu_torch.cluster_utils as port_cluster_utils
from ray_tpu_torch.autoscaler import (
    AutoscalerConfig,
    FakeGPUTransport,
    GCEGPUConfig,
    GCEGPUNodeProvider,
    LocalNodeProvider,
    StandardAutoscaler,
    request_resources,
)
from ray_tpu_torch.autoscaler.gcp import (
    CLUSTER_LABEL,
    TYPE_LABEL,
    GPUNodeHandle,
    SubprocessFakeGPUTransport,
    machine_gpus,
)
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.rpc import RpcClient
from ray_tpu_torch.util.accelerators import GPU_GENERATIONS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
API = "https://compute.googleapis.com/compute/v1/projects/proj-1/zones/" \
      "us-central1-a/instances"


def _config(head_address="10.0.0.2:6379", **kw):
    kw.setdefault("machine_type", "a3-highgpu-8g")
    return GCEGPUConfig(project="proj-1", zone="us-central1-a",
                        cluster_name="rtt", head_address=head_address, **kw)


# ------------------------------------------------------------ REST bodies


@pytest.mark.parametrize("model", ["STANDARD", "SPOT"])
def test_create_node_request_body(model):
    transport = FakeGPUTransport()
    provider = GCEGPUNodeProvider(_config(provisioning_model=model),
                                  transport=transport)
    handle = provider.create_node(provider.node_resources_for())
    assert handle.name.startswith("rtt-worker-")

    (call,) = transport.calls
    assert call["method"] == "POST" and call["url"] == API
    body = call["body"]
    assert sorted(body) == ["disks", "guestAccelerators", "labels",
                            "machineType", "metadata", "name",
                            "networkInterfaces", "scheduling"]
    assert body["name"] == handle.name
    assert body["machineType"] == \
        "zones/us-central1-a/machineTypes/a3-highgpu-8g"
    assert body["guestAccelerators"] == [{
        "acceleratorType":
            "zones/us-central1-a/acceleratorTypes/nvidia-h100-80gb",
        "acceleratorCount": 8}]
    want_sched = {"onHostMaintenance": "TERMINATE",
                  "automaticRestart": model == "STANDARD",
                  "provisioningModel": model}
    if model == "SPOT":
        want_sched["instanceTerminationAction"] = "DELETE"
    assert body["scheduling"] == want_sched
    (disk,) = body["disks"]
    assert disk == {"boot": True, "autoDelete": True, "initializeParams": {
        "sourceImage": _config().source_image, "diskSizeGb": "200",
        "diskType": "zones/us-central1-a/diskTypes/pd-ssd"}}
    assert body["networkInterfaces"] == [
        {"network": "global/networks/default"}]
    assert body["labels"] == {CLUSTER_LABEL: "rtt", TYPE_LABEL: "worker"}
    (item,) = body["metadata"]["items"]
    assert item["key"] == "startup-script"
    assert item["value"] == (
        "#!/bin/bash\npython3 -m ray_tpu_torch start --address=10.0.0.2:6379 "
        f"--host auto --num-gpus 8 --labels gpu-vm-name={handle.name}\n")


def test_terminate_and_list_requests():
    transport = FakeGPUTransport()
    provider = GCEGPUNodeProvider(_config(), transport=transport)
    handle = provider.create_node({})
    nodes = provider.non_terminated_nodes()
    assert [(n.name, n.state) for n in nodes] == [(handle.name, "RUNNING")]
    provider.terminate_node(handle)
    assert provider.non_terminated_nodes() == []

    assert [c["method"] for c in transport.calls] == [
        "POST", "GET", "DELETE", "GET"]
    assert transport.calls[2]["url"] == f"{API}/{handle.name}"
    assert transport.calls[2]["body"] is None
    url = urllib.parse.urlsplit(transport.calls[1]["url"])
    assert url._replace(query="").geturl() == API
    assert urllib.parse.parse_qs(url.query) == {
        "filter": [f"labels.{CLUSTER_LABEL}=rtt"]}


def test_list_drops_instances_that_hold_no_node():
    states = {"a": "PROVISIONING", "b": "RUNNING", "c": "STOPPING",
              "d": "TERMINATED", "e": "SUSPENDED"}

    def transport(method, url, body):
        return {"items": [{"name": n, "status": s}
                          for n, s in states.items()]}

    provider = GCEGPUNodeProvider(_config(), transport=transport)
    assert [(h.name, h.state) for h in provider.non_terminated_nodes()] == [
        ("a", "PROVISIONING"), ("b", "RUNNING")]


def test_provider_adopts_preexisting_nodes():
    """A restarted autoscaler re-discovers VMs it did not create in this
    process: the provider's state is the cloud's."""
    transport = FakeGPUTransport()
    p1 = GCEGPUNodeProvider(_config(), transport=transport)
    handle = p1.create_node({})
    p2 = GCEGPUNodeProvider(_config(), transport=transport)
    assert [n.name for n in p2.non_terminated_nodes()] == [handle.name]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_node_resources_for_follow_the_registry(n):
    provider = GCEGPUNodeProvider(_config(machine_type=f"a3-highgpu-{n}g"),
                                  transport=FakeGPUTransport())
    per_host = GPU_GENERATIONS["h100"].gpus_per_host
    assert per_host % n == 0
    assert provider.node_resources_for() == {"CPU": 26.0 * n,
                                             "GPU": float(n)}
    assert machine_gpus(f"a3-highgpu-{n}g") == n


@pytest.mark.parametrize("bad", ["a3-highgpu-3g", "a3-highgpu-16g",
                                 "a2-highgpu-1g", "n1-standard-8",
                                 "a3-highgpu-g"])
def test_machine_types_outside_the_series_are_refused(bad):
    with pytest.raises(ValueError, match="a3-highgpu"):
        GCEGPUNodeProvider(_config(machine_type=bad),
                           transport=FakeGPUTransport())


def test_resolve_node_id_through_the_vm_label():
    provider = GCEGPUNodeProvider(_config(), transport=FakeGPUTransport())
    view = {"aa": {"labels": {"gpu-vm-name": "rtt-worker-1"}},
            "bb": {"labels": {"tpu-vm-name": "rtt-worker-2"}}}
    assert provider.resolve_node_id(GPUNodeHandle("rtt-worker-1"),
                                    view) == "aa"
    assert provider.resolve_node_id(GPUNodeHandle("rtt-worker-2"),
                                    view) is None
    assert provider.resolve_node_id(
        GPUNodeHandle("x", node_id="cc"), view) == "cc"


# -------------------------------------------- decisions, against the JAX


class _ScriptedGcs:
    """The two reads `update()` makes, from the test's script."""

    def __init__(self, world):
        self.world = world

    def call(self, method, data=None, timeout=None):
        if method == "resource_demand":
            return {"demand": list(self.world.demand),
                    "requests": list(self.world.requests)}
        assert method == "get_resource_view"
        return self.world.view()

    def close(self):
        pass


class _Handle:
    """A VM: its ray node id exists once the script has it join."""

    def __init__(self, world, name):
        self.world, self.name = world, name

    @property
    def node_id(self):
        return f"{self.name:0>8}" if self.name in self.world.joined else None


class _World:
    """A recording provider, a clock and the cluster's view: the head
    plus every live managed node that has joined, each busy, idle or
    dead as the script says."""

    SHAPE = {"CPU": 2.0, "GPU": 1.0}

    def __init__(self):
        self.now = 1000.0
        self.demand, self.requests = [], []
        self.nodes, self.joined, self.busy, self.dead = [], set(), set(), set()
        self.trace = []
        self._count = 0

    def monotonic(self):
        return self.now

    def create_node(self, shape):
        self._count += 1
        h = _Handle(self, str(self._count))
        self.nodes.append(h)
        self.trace.append(("launch", h.name, dict(shape)))
        return h

    def terminate_node(self, handle):
        self.nodes.remove(handle)
        self.trace.append(("terminate", handle.name))

    def non_terminated_nodes(self):
        return list(self.nodes)

    def view(self):
        out = {"head": {"alive": True, "total": {"CPU": 1.0},
                        "available": {"CPU": 1.0}}}
        for h in self.nodes:
            if h.name not in self.joined:
                continue
            avail = dict(self.SHAPE, GPU=0.0) if h.name in self.busy \
                else dict(self.SHAPE)
            out[h.node_id] = {"alive": h.name not in self.dead,
                              "total": dict(self.SHAPE), "available": avail}
        return out


# (seconds since the last tick, demand, requests, joined, busy, dead):
# each tick's inputs; None keeps the previous set.
SCRIPT = [
    (0, [{"GPU": 1.0}] * 3, [], set(), set(), set()),  # min 1 + 3, the max
    (1, [], [], {"1", "2", "3"}, {"1", "2", "3"}, set()),
    (1, [{"GPU": 1.0}] * 5, [], None, None, None),     # at the max: none
    (1, [], [{"CPU": 4.0}], {"1", "2", "3", "4"}, {"1", "2", "3"}, set()),
    (1, [], [], None, {"3"}, {"1"}),                   # 1 dies: replaced
    (1, [], [], {"2", "3", "4", "5"}, {"3"}, set()),   # 4 idle past 2 s
    (3, [], [], None, {"3"}, None),                    # 2, 5 idle out
    (3, [], [], None, set(), None),                    # 3 stays: min 1
    (3, [], [], None, None, None),
    (0, [{"CPU": 8.0}], [{"GPU": 1.0}] * 2, None, None, None),
]


def _run_script(mod, monkeypatch):
    world = _World()
    monkeypatch.setattr(mod, "time", world)
    monkeypatch.setattr(mod, "RpcClient", lambda addr, name: _ScriptedGcs(
        world))
    a = mod.StandardAutoscaler(
        "unused:0", world, mod.AutoscalerConfig(
            min_workers=1, max_workers=4, node_resources=dict(_World.SHAPE),
            idle_timeout_s=2.0, launch_grace_s=5.0, update_period_s=1.0))
    trace = []
    for dt, demand, requests, joined, busy, dead in SCRIPT:
        world.now += dt
        world.demand, world.requests = demand, requests
        world.joined = world.joined if joined is None else joined
        world.busy = world.busy if busy is None else busy
        world.dead = world.dead if dead is None else dead
        world.trace = []
        a.update()
        trace.append((world.trace, a.num_launches, a.num_terminations))
    return trace


def test_decisions_equal_the_reference_on_a_script(monkeypatch):
    ours = _run_script(port_autoscaler, monkeypatch)
    ref = _run_script(ref_autoscaler, monkeypatch)
    assert ours == ref

    def launch(name):
        return ("launch", name, dict(_World.SHAPE))

    assert ours == [
        ([launch("1"), launch("2"), launch("3"), launch("4")], 4, 0),
        ([], 4, 0), ([], 4, 0), ([], 4, 0),
        ([("terminate", "1"), launch("5")], 5, 1),
        ([("terminate", "4")], 5, 2),
        ([("terminate", "2"), ("terminate", "5")], 5, 4),
        ([], 5, 4), ([], 5, 4),
        ([launch("6")], 6, 4)]    # one request unmet; CPU 8 fits no node


def test_queued_demand_that_fits_keeps_an_idle_looking_node(monkeypatch):
    """A node whose lease waits for its GPU worker to start holds no
    resources, so it looks idle; while queued demand fits it, the port's
    autoscaler keeps it, and reaps it once the demand is gone. (The JAX
    package's reaps it at the idle timeout: F7.)"""
    world = _World()
    monkeypatch.setattr(port_autoscaler, "time", world)
    monkeypatch.setattr(port_autoscaler, "RpcClient",
                        lambda addr, name: _ScriptedGcs(world))
    a = port_autoscaler.StandardAutoscaler(
        "unused:0", world, port_autoscaler.AutoscalerConfig(
            min_workers=0, max_workers=2, node_resources=dict(_World.SHAPE),
            idle_timeout_s=1.0, launch_grace_s=0.0, update_period_s=0.2))
    world.demand = [{"GPU": 1.0}]
    a.update()                                   # launches node 1
    world.joined = {"1"}
    trace = []
    for dt, demand in [(0.5, [{"GPU": 1.0}]), (2.0, [{"GPU": 1.0}]),
                       (2.0, [{"CPU": 8.0}]), (2.0, [])]:
        world.now += dt
        world.demand = demand
        world.trace = []
        a.update()
        trace.append(list(world.trace))
    # Kept while a GPU shape is queued, though idle past the timeout; a
    # shape no node fits keeps nothing.
    assert trace == [[], [], [("terminate", "1")], []]
    assert (a.num_launches, a.num_terminations) == (1, 1)


def _local_provider_trace(pkg, cluster_mod, autoscaler_mod):
    """LocalNodeProvider on a real cluster of `pkg`, ticked by hand with a
    sequence of request_resources floors; returns each tick's
    (launches, terminations) and the live node count after it."""
    cluster = cluster_mod.Cluster(initialize_head=True,
                                  head_node_args={"num_cpus": 1})
    try:
        cluster.connect()
        provider = autoscaler_mod.LocalNodeProvider(cluster)
        a = autoscaler_mod.StandardAutoscaler(
            cluster.gcs_address, provider, autoscaler_mod.AutoscalerConfig(
                min_workers=0, max_workers=3,
                node_resources={"CPU": 1, "pool": 1},
                idle_timeout_s=60.0, launch_grace_s=0.0))
        trace = []

        def tick(bundles):
            autoscaler_mod.request_resources(bundles=bundles)
            a.update()
            want = len(provider.non_terminated_nodes()) + 1
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and want != sum(
                    n["Alive"] for n in cluster.gcs.handle_get_nodes(None)):
                time.sleep(0.02)
            trace.append((a.num_launches, a.num_terminations, want - 1))

        tick([{"pool": 1}] * 2)
        tick([{"pool": 1}] * 2)
        tick([{"pool": 1}] * 5)
        a.config.idle_timeout_s = 0.0
        tick([])
        a.stop()
        return trace
    finally:
        cluster.shutdown()
        pkg.shutdown()


def test_local_provider_decisions_equal_the_reference():
    ours = _local_provider_trace(ray_tpu_torch, port_cluster_utils,
                                 port_autoscaler)
    ref = _local_provider_trace(ray_tpu, ref_cluster_utils, ref_autoscaler)
    assert ours == ref == [(2, 0, 2), (2, 0, 2), (3, 0, 3), (3, 3, 0)]


# ------------------------------------------------------------ end to end


@ray_tpu_torch.remote(num_gpus=1)
def _on_a_card(i):
    return i, os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()


def test_fake_cloud_autoscaler_end_to_end():
    """GPU demand -> instances.insert -> fake VMs join as raylets with a
    card each -> the tasks run on them -> idle -> instances.delete."""
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    autoscaler = None
    try:
        cluster.connect()
        transport = FakeGPUTransport(cluster=cluster, gpus_per_vm=1,
                                     cpus_per_vm=2)
        provider = GCEGPUNodeProvider(_config(machine_type="a3-highgpu-1g"),
                                      transport=transport)
        autoscaler = StandardAutoscaler(
            cluster.gcs_address, provider,
            AutoscalerConfig(min_workers=0, max_workers=2,
                             node_resources={"CPU": 2, "GPU": 1},
                             idle_timeout_s=1.0, launch_grace_s=15.0,
                             update_period_s=0.2))
        autoscaler.start()
        out = ray_tpu_torch.get([_on_a_card.remote(i) for i in range(4)],
                                timeout=60)
        assert [i for i, _, _ in out] == list(range(4))
        assert {cards for _, cards, _ in out} == {"0"}
        assert 1 <= autoscaler.num_launches <= 2
        creates = [c for c in transport.calls if c["method"] == "POST"]
        assert len(creates) == autoscaler.num_launches
        assert all(c["body"]["guestAccelerators"][0]["acceleratorCount"] == 1
                   for c in creates)

        # Reaped means the autoscaler has recorded each termination: the
        # provider forgets a VM before the loop's thread counts it.
        deadline = time.monotonic() + 30
        while (provider.non_terminated_nodes() or autoscaler.num_terminations
               < autoscaler.num_launches) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not provider.non_terminated_nodes(), "idle GPU VMs not reaped"
        deletes = [c for c in transport.calls if c["method"] == "DELETE"]
        assert len(deletes) == len(creates)
        assert autoscaler.num_terminations == len(creates)
    finally:
        if autoscaler is not None:
            autoscaler.stop()
        cluster.shutdown()


def test_local_provider_launches_gpu_shapes():
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    try:
        provider = LocalNodeProvider(cluster)
        raylet = provider.create_node({"CPU": 2, "GPU": 2, "extra": 1})
        cluster.wait_for_nodes()
        view = cluster.gcs.handle_get_resource_view(None)
        assert view[raylet.node_id.hex()]["total"] == {
            "CPU": 2.0, "GPU": 2.0, "extra": 1.0,
            **{k: v for k, v in view[raylet.node_id.hex()]["total"].items()
               if k.startswith("node:")}}
        provider.terminate_node(raylet)
        assert provider.non_terminated_nodes() == []
    finally:
        cluster.shutdown()


def test_request_resources_needs_a_driver():
    with pytest.raises(RuntimeError, match="init"):
        request_resources(num_cpus=1)


def test_startup_script_joins_a_real_node(tmp_path):
    """The provider's startup script — the command a GPU VM boots with —
    is EXECUTED and must daemonize a worker node that joins the head's
    GCS with its card count and VM label; the instance's delete stops
    it."""
    env = {"RAY_TPU_TORCH_TMPDIR": str(tmp_path),
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    full_env = {**os.environ, **env}
    head = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--head",
         "--num-cpus", "1", "--num-gpus", "0"],
        env=full_env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=90)
    assert head.returncode == 0, head.stderr
    address = head.stdout.split("started at ")[1].split()[0]
    gcs = RpcClient(address, name="test->gcs")
    try:
        transport = SubprocessFakeGPUTransport(env=env)
        provider = GCEGPUNodeProvider(
            _config(head_address=address, machine_type="a3-highgpu-2g",
                    host="127.0.0.1"), transport=transport)
        handle = provider.create_node(provider.node_resources_for())
        assert [n.name for n in provider.non_terminated_nodes()] == [
            handle.name]
        pid = transport.nodes[handle.name]["pid"]

        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            view = gcs.call("get_resource_view")
            if sum(e["alive"] for e in view.values()) == 2:
                break
            time.sleep(0.05)
        joined = [e for e in view.values() if e["alive"]
                  and e["labels"].get("gpu-vm-name") == handle.name]
        assert len(joined) == 1 and joined[0]["total"]["GPU"] == 2.0
        # A fresh handle (no node id) resolves through the label.
        assert provider.resolve_node_id(GPUNodeHandle(handle.name),
                                        view) is not None

        provider.terminate_node(handle)
        assert provider.non_terminated_nodes() == []
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                os.kill(pid, 0)
                time.sleep(0.05)
            except ProcessLookupError:
                break
        else:
            pytest.fail(f"worker daemon {pid} outlived its instance")
    finally:
        gcs.close()
        subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", "stop", "--force"],
            env=full_env, cwd=str(tmp_path), capture_output=True, timeout=60)
