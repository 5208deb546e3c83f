"""The port's core runtime (`ray_tpu_torch.init` and its tasks, objects,
actors and GPU grants) on the CPU, beside the JAX package's.

One module-scoped cluster with 2 CPUs and 2 GPUs, the GPUs faked (no card
is needed: a grant only sets the worker's CUDA_VISIBLE_DEVICES). Its
`direct_pipeline_depth` is 1, so that two submitted tasks take two
workers instead of queueing on one. The last test runs the same task
graph and actor under `ray_tpu` and `ray_tpu_torch` with both clusters up
at once.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.core.common import GPU_GRANT
from ray_tpu_torch.core.node import detect_gpus
from ray_tpu_torch.core.worker_forge import WorkerForge
from ray_tpu_torch.exceptions import RayActorError, RayTaskError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def cluster():
    ray_tpu_torch.init(num_cpus=2, num_gpus=2,
                       _system_config={"direct_pipeline_depth": 1})
    yield ray_tpu_torch._global_node
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def square(x):
    return x * x


@ray_tpu_torch.remote
def add(a, b):
    return a + b


@ray_tpu_torch.remote
def total(arr):
    return int(arr.sum())


@ray_tpu_torch.remote
def unwrap(refs):
    return sum(ray_tpu_torch.get(refs))


@ray_tpu_torch.remote
def slow_square(x, hold_s):
    time.sleep(hold_s)
    return x * x


@ray_tpu_torch.remote
def fail():
    raise KeyError("the cause")


@ray_tpu_torch.remote
def visible():
    return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()


@ray_tpu_torch.remote(num_gpus=1)
def gpu_visible(rendezvous, me, other):
    """Announce `me` as a file in the directory `rendezvous`, then wait up
    to 60 s for `other` to announce itself: two such tasks return only if
    they ran at once, however long their workers took to spawn."""
    start = time.monotonic()
    open(os.path.join(rendezvous, me), "w").close()
    while not os.path.exists(os.path.join(rendezvous, other)):
        if time.monotonic() - start > 60:
            raise TimeoutError(f"{other} did not run beside {me} in 60 s")
        time.sleep(0.01)
    return os.environ.get("CUDA_VISIBLE_DEVICES"), start, time.monotonic()


@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def inc(self, by=1):
        self.n += by
        return self.n


@ray_tpu_torch.remote(num_gpus=1)
class GpuActor:
    def cards(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def test_tasks_objects_and_wait():
    assert ray_tpu_torch.get([square.remote(i) for i in range(8)]) == [
        i * i for i in range(8)]
    assert ray_tpu_torch.get(add.remote(square.remote(3), 4)) == 13
    ref = ray_tpu_torch.put({"a": 1})
    assert ray_tpu_torch.get(ref) == {"a": 1}
    # Refs nested in a list are passed as refs, not values.
    inner = [square.remote(i) for i in range(4)]
    assert ray_tpu_torch.get(unwrap.remote(inner)) == 14
    ready, pending = ray_tpu_torch.wait(inner, num_returns=4, timeout=30)
    assert len(ready) == 4 and not pending
    res = ray_tpu_torch.cluster_resources()
    assert res["CPU"] == 2 and res["GPU"] == 2


def test_nested_refs_of_running_tasks_are_waited_for_not_lost():
    # `unwrap` runs on the second CPU while the inner task still runs on
    # the first: the borrower registers the inner ref before its task
    # finishes, so the directory knows the id but holds no copy yet. That
    # is pending, not lost (it raised ObjectLostError).
    for hold_s in (1.0, 0.5):
        inner = [slow_square.remote(3, hold_s)]
        assert ray_tpu_torch.get(unwrap.remote(inner)) == 9


def test_64_mib_array_through_shared_memory():
    arr = np.arange(64 << 20, dtype=np.uint8)
    ref = ray_tpu_torch.put(arr)
    back = ray_tpu_torch.get(ref)
    assert back.nbytes == 64 << 20 and np.array_equal(back, arr)
    assert ray_tpu_torch.get(total.remote(ref)) == int(arr.sum())


def test_actors_named_actors_kill_and_task_errors():
    c = Counter.remote(10)
    assert ray_tpu_torch.get([c.inc.remote() for _ in range(3)]) == [11, 12,
                                                                      13]
    named = Counter.options(name="port-counter").remote()
    named.inc.remote(5)
    same = ray_tpu_torch.get_actor("port-counter")
    assert ray_tpu_torch.get(same.inc.remote()) == 6
    ray_tpu_torch.kill(named)
    with pytest.raises(RayActorError):
        ray_tpu_torch.get(named.inc.remote(), timeout=30)
    with pytest.raises(RayTaskError) as err:
        ray_tpu_torch.get(fail.remote())
    assert isinstance(err.value.cause, KeyError)
    assert "the cause" in str(err.value)


def test_gpu_grants_see_their_own_cards_and_a_cpu_task_none(tmp_path):
    assert ray_tpu_torch.get(visible.remote())[0] == ""
    # Two concurrent one-GPU tasks: two workers, each with its own card.
    # They meet at a rendezvous (each waits for the other's file), so a
    # scheduler that ran them one after the other would fail at its 60 s.
    (a, s1, e1), (b, s2, e2) = ray_tpu_torch.get(
        [gpu_visible.remote(str(tmp_path), "a", "b"),
         gpu_visible.remote(str(tmp_path), "b", "a")])
    assert max(s1, s2) < min(e1, e2), "the two tasks did not overlap"
    assert {a, b} == {"0", "1"}
    # Actors hold their card for life; a killed actor's card is reused.
    first = GpuActor.remote()
    second = GpuActor.remote()
    cards = ray_tpu_torch.get([first.cards.remote(), second.cards.remote()])
    assert sorted(cards) == ["0", "1"]
    ray_tpu_torch.kill(first)
    third = GpuActor.remote()
    assert ray_tpu_torch.get(third.cards.remote(), timeout=60) == cards[0]
    ray_tpu_torch.kill(second)
    ray_tpu_torch.kill(third)


def test_detect_gpus_counts_cards_without_torch(tmp_path):
    # Without nvidia-smi the card nodes are counted; with it, its list of
    # cards wins (a container may hold nodes of cards it cannot use).
    dev = tmp_path / "dev"
    dev.mkdir()
    for name in ("nvidia0", "nvidia6", "nvidiactl", "nvidia-uvm"):
        (dev / name).touch()
    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho 'GPU 0: NVIDIA H100 80GB HBM3 (UUID: x)'\n")
    smi.chmod(0o755)
    code = (
        "import os, sys\n"
        "os.environ.pop('CUDA_VISIBLE_DEVICES', None)\n"
        "os.environ.pop('RAY_TPU_TORCH_NUM_GPUS', None)\n"
        "from ray_tpu_torch.core.node import detect_gpus\n"
        f"print(detect_gpus({str(dev)!r}, {str(tmp_path / 'none')!r}),\n"
        f"      detect_gpus({str(dev)!r}, {str(smi)!r}),\n"
        "      'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.split() == ["2", "1", "False"], out.stderr
    os.environ["RAY_TPU_TORCH_NUM_GPUS"] = "3"
    try:
        assert detect_gpus(str(dev)) == 3
    finally:
        del os.environ["RAY_TPU_TORCH_NUM_GPUS"]


def test_import_leaves_torch_unimported():
    code = ("import sys, ray_tpu_torch\n"
            "assert callable(ray_tpu_torch.init)\n"
            "print('torch' in sys.modules, 'jax' in sys.modules)\n"
            "ray_tpu_torch.resolve_device\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.split() == ["False", "False", "True"], out.stderr


def test_forge_template_has_cuda_uninitialised_and_refuses_gpu_grants(
        cluster):
    forge = cluster.raylet.forge
    assert forge is not None and forge.wait_ready(60)
    st = forge.status()
    assert st["threads"] == 1 and st["cuda_initialized"] is False
    assert "ray_tpu_torch.core.worker" in st["preimported"]
    assert not WorkerForge.compatible({GPU_GRANT: "1"})
    assert WorkerForge.compatible({})


# The same graph and actor in both packages, both clusters up at once.
def _graph(rt, square_fn, add_fn, counter_cls):
    refs = [square_fn.remote(i) for i in range(5)]
    out = rt.get(add_fn.remote(refs[2], refs[4]))
    c = counter_cls.remote(100)
    counts = rt.get([c.inc.remote(i) for i in range(4)])
    return out, rt.get(refs), counts


ref_square = ray_tpu.remote(square.func)
ref_add = ray_tpu.remote(add.func)
ref_counter = ray_tpu.remote(Counter._cls)


def test_same_graph_same_values_in_both_packages():
    ray_tpu.init(num_cpus=2)
    try:
        assert ray_tpu_torch.is_initialized()
        want = _graph(ray_tpu, ref_square, ref_add, ref_counter)
        got = _graph(ray_tpu_torch, square, add, Counter)
        assert got == want == (20, [0, 1, 4, 9, 16], [100, 101, 103, 106])
        # Each package reached its own cluster.
        assert ray_tpu.cluster_resources().get("GPU") is None
        assert ray_tpu_torch.cluster_resources()["GPU"] == 2
    finally:
        ray_tpu.shutdown()
