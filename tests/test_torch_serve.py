"""The port's Serve tier (`ray_tpu_torch.serve`) on the CPU.

The scenarios of tests/test_serve.py, each named after the reference test
it mirrors, on one module-scoped port cluster: every test tears its
deployments down with `serve.shutdown()` and keeps the cluster. The last
test runs one deployment graph under `ray_tpu.serve` and
`ray_tpu_torch.serve` at once and holds the two to the same responses and
the same `serve.status()` keys.
"""

import asyncio
import json
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module", autouse=True)
def cluster():
    ray_tpu_torch.init(num_cpus=8)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def app():
    yield
    serve.shutdown()


# An importable application for the schema test (`import_path`).
@serve.deployment
class Doubler:
    def __call__(self, x):
        return 2 * x


@serve.deployment
class Pipeline:
    def __init__(self, inner, bonus):
        self.inner = inner
        self.bonus = bonus

    def __call__(self, x):
        return ray_tpu_torch.get(self.inner.remote(x)) + self.bonus


pipeline = Pipeline.bind(Doubler.bind(), 5)


def _post(port, path, payload, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def test_deploy_and_call(app):
    # test_serve.py::test_deploy_and_call
    @serve.deployment(num_replicas=2)
    class Echo:
        def __init__(self, prefix):
            self._prefix = prefix

        def __call__(self, payload):
            return f"{self._prefix}:{payload}"

    handle = serve.run(Echo.bind("echo"))
    results = ray_tpu_torch.get([handle.remote(i) for i in range(8)])
    assert results == [f"echo:{i}" for i in range(8)]
    st = serve.status()
    assert st["Echo"]["target"] == 2
    assert len(st["Echo"]["replicas"]) == 2


def test_function_deployment_and_methods(app):
    # test_serve.py::test_function_deployment_and_methods
    @serve.deployment
    def double(payload):
        return payload * 2

    handle = serve.run(double.bind())
    assert ray_tpu_torch.get(handle.remote(21)) == 42

    @serve.deployment
    class Multi:
        def __call__(self, x):
            return ("call", x)

        def other(self, x):
            return ("other", x)

    h2 = serve.run(Multi.bind())
    assert ray_tpu_torch.get(h2.remote(1)) == ("call", 1)
    assert ray_tpu_torch.get(h2.other.remote(2)) == ("other", 2)


def test_batching_collects_concurrent_requests(app):
    # test_serve.py::test_batching_collects_concurrent_requests
    @serve.deployment(max_concurrent_queries=16)
    class Batcher:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
        async def __call__(self, items):
            return [len(items)] * len(items)

    handle = serve.run(Batcher.bind())
    sizes = ray_tpu_torch.get([handle.remote(i) for i in range(8)])
    assert max(sizes) > 1


def test_replica_failure_recovers(app):
    # test_serve.py::test_replica_failure_recovers
    @serve.deployment(num_replicas=1)
    class Fragile:
        def __call__(self, payload):
            return payload

        def pid(self, _=None):
            import os

            return os.getpid()

    handle = serve.run(Fragile.bind())
    pid = ray_tpu_torch.get(handle.pid.remote(None))
    replica = ray_tpu_torch.get_actor("SERVE_REPLICA::Fragile#0",
                                      namespace="serve")
    ray_tpu_torch.kill(replica)
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            new_pid = ray_tpu_torch.get(handle.pid.remote(None), timeout=5.0)
            if new_pid != pid:
                break
        except Exception:
            time.sleep(0.2)
    else:
        pytest.fail("replica was not replaced after kill")


def test_autoscaling_up_and_down(app):
    # test_serve.py::test_autoscaling_up_and_down
    @serve.deployment(
        max_concurrent_queries=2,
        autoscaling_config=serve.AutoscalingConfig(
            min_replicas=1, max_replicas=3, target_ongoing_requests=1.0,
            upscale_delay_s=0.2, downscale_delay_s=1.0))
    class Slow:
        def __call__(self, payload):
            time.sleep(0.4)
            return payload

    handle = serve.run(Slow.bind())
    assert serve.status()["Slow"]["target"] == 1
    refs = [handle.remote(i) for i in range(16)]
    deadline = time.time() + 20
    while time.time() < deadline:
        if serve.status()["Slow"]["target"] > 1:
            break
        time.sleep(0.1)
    else:
        pytest.fail("deployment did not scale up under load")
    assert ray_tpu_torch.get(refs) == list(range(16))
    deadline = time.time() + 20
    while time.time() < deadline:
        if serve.status()["Slow"]["target"] == 1:
            break
        time.sleep(0.2)
    else:
        pytest.fail("deployment did not scale back down when idle")


def test_http_proxy_round_trip(app):
    # test_serve.py::test_http_proxy_round_trip
    @serve.deployment(num_replicas=2, route_prefix="/math")
    class Adder:
        def __call__(self, payload):
            return {"sum": payload["a"] + payload["b"]}

    serve.run(Adder.bind())
    port = serve.http_port()
    assert _post(port, "/math", {"a": 2, "b": 3}) == {"result": {"sum": 5}}
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
    assert err.value.code == 404


def test_handle_composition_between_deployments(app):
    # test_serve.py::test_handle_composition_between_deployments
    @serve.deployment
    class Inner:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Outer:
        def __init__(self, inner):
            self._inner = inner

        def __call__(self, x):
            return ray_tpu_torch.get(self._inner.remote(x)) * 10

    serve.run(Inner.bind())
    outer = serve.run(Outer.bind(serve.get_deployment_handle("Inner")))
    assert ray_tpu_torch.get(outer.remote(4)) == 50


@serve.deployment
class GraphDoubler:
    def __call__(self, x):
        return 2 * x


@serve.deployment
class GraphAdder:
    def __init__(self, offset):
        self.offset = offset

    def __call__(self, x):
        return x + self.offset


@serve.deployment
class GraphDriver:
    def __init__(self, doubler, adder):
        self.doubler = doubler
        self.adder = adder

    def __call__(self, x):
        return ray_tpu_torch.get(self.adder.remote(
            ray_tpu_torch.get(self.doubler.remote(x))))


def test_deployment_graph_composition(app):
    # test_serve.py::test_deployment_graph_composition and
    # ::test_graph_init_args_pass_through_untouched
    import collections

    handle = serve.run(GraphDriver.bind(GraphDoubler.bind(),
                                        GraphAdder.bind(100)))
    assert ray_tpu_torch.get(handle.remote(7)) == 114
    with pytest.raises(ValueError):
        serve.run(GraphDriver.options(name="D2").bind(
            GraphAdder.bind(1), GraphAdder.bind(2)))

    @serve.deployment
    class Ensemble:
        def __init__(self, models):
            self.models = models

        def __call__(self, x):
            return sum(ray_tpu_torch.get(m.remote(x)) for m in self.models)

    ens = serve.run(Ensemble.bind([
        GraphAdder.options(name="AddA").bind(1),
        GraphAdder.options(name="AddB").bind(2)]))
    assert ray_tpu_torch.get(ens.remote(10)) == 23

    @serve.deployment
    class KeepsDefaultDict:
        def __init__(self, counts):
            self.counts = counts

        def __call__(self, key):
            self.counts[key].append(1)
            return len(self.counts[key])

    h = serve.run(KeepsDefaultDict.bind(collections.defaultdict(list)))
    assert ray_tpu_torch.get(h.remote("a")) == 1
    assert ray_tpu_torch.get(h.remote("a")) == 2

    @serve.deployment
    class SetEnsemble:
        def __init__(self, models):
            self.models = models

    with pytest.raises(ValueError, match="un-substituted"):
        serve.run(SetEnsemble.bind({GraphAdder.bind(1), GraphAdder.bind(2)}))


def test_schema_build_validate_deploy(app):
    # test_serve.py::test_schema_build_validate_deploy
    from ray_tpu_torch.serve.schema import (
        build,
        deploy_config,
        validate_config,
    )

    cfg = build(pipeline)
    deps = {d["name"] for d in cfg["applications"][0]["deployments"]}
    assert deps == {"Doubler", "Pipeline"}
    config = {"applications": [{
        "name": "default", "import_path": "test_torch_serve:pipeline",
        "deployments": [{"name": "Doubler", "num_replicas": 2,
                         "max_concurrent_queries": 16}]}]}
    validate_config(config)
    handle = deploy_config(config)
    assert ray_tpu_torch.get(handle.remote(10)) == 25
    assert serve.status()["Doubler"]["target"] == 2
    assert Doubler.config.num_replicas == 1  # the module's object unchanged
    with pytest.raises(ValueError, match="unknown deployment option"):
        validate_config({"applications": [{
            "import_path": "test_torch_serve:pipeline",
            "deployments": [{"name": "Doubler", "replicas": 2}]}]})
    with pytest.raises(ValueError, match="import_path"):
        validate_config({"applications": [{"name": "x"}]})


def test_controller_crash_recovery(app):
    # test_serve.py::test_controller_crash_recovery
    from ray_tpu_torch.serve import _get_or_create_controller

    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, payload):
            return f"echo:{payload}"

    handle = serve.run(Echo.bind())
    assert ray_tpu_torch.get(handle.remote("a")) == "echo:a"
    ray_tpu_torch.kill(_get_or_create_controller(create=False))
    deadline = time.monotonic() + 60
    status = {}
    while time.monotonic() < deadline:
        try:
            status = serve.status()
            reps = status.get("Echo", {}).get("replicas", {})
            if sum(1 for s in reps.values() if s == "RUNNING") >= 2:
                break
        except Exception:
            pass
        time.sleep(0.2)
    reps = status.get("Echo", {}).get("replicas", {})
    assert sum(1 for s in reps.values() if s == "RUNNING") >= 2, status
    h2 = serve.get_deployment_handle("Echo")
    assert ray_tpu_torch.get(h2.remote("b"), timeout=60) == "echo:b"


def test_batch_queue_stop_fails_pending_and_cancels_flusher():
    # test_serve.py::test_batch_queue_stop_fails_pending_and_cancels_flusher
    from ray_tpu_torch.serve.batching import _BatchQueue

    async def main():
        started = asyncio.Event()
        release = asyncio.Event()

        async def fn(items):
            started.set()
            await release.wait()
            return items

        q = _BatchQueue(fn, max_batch_size=2, batch_wait_timeout_s=10.0)
        t1 = asyncio.ensure_future(q.submit(1))
        t2 = asyncio.ensure_future(q.submit(2))
        await started.wait()
        flusher = q._flusher
        assert q.stop() == 2
        for t in (t1, t2):
            with pytest.raises(RuntimeError, match="shut down"):
                await t
        for _ in range(5):
            await asyncio.sleep(0)
        assert flusher.done()
        with pytest.raises(RuntimeError, match="stopped"):
            await q.submit(3)

    asyncio.run(main())


def test_replica_teardown_stops_batch_queue_and_runs_shutdown_hook():
    # test_serve.py::
    #   test_replica_teardown_stops_batch_queue_and_runs_shutdown_hook
    from ray_tpu_torch.serve.replica import Replica

    events = []

    class User:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=30.0)
        async def __call__(self, items):
            return items

        def __serve_shutdown__(self):
            events.append("shutdown")

    async def main():
        rep = Replica("D", User, (), {})
        task = asyncio.ensure_future(rep.handle_request("__call__", (1,), {}))
        await asyncio.sleep(0.05)
        await rep.prepare_shutdown(timeout_s=0.2)
        with pytest.raises(RuntimeError, match="shut down"):
            await task
        assert events == ["shutdown"]

    asyncio.run(main())


def test_serve_imports_no_torch_in_the_control_plane():
    # The controller and proxy are CPU actors forked from the worker
    # template: nothing they import may load torch (or CUDA).
    import subprocess
    import sys

    code = ("import sys, ray_tpu_torch.serve.controller, "
            "ray_tpu_torch.serve.proxy, ray_tpu_torch.serve.replica, "
            "ray_tpu_torch.serve.grpc_proxy, ray_tpu_torch.shardgroup; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ray_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_same_graph_under_both_packages(app):
    # One deployment graph under the JAX package's Serve and the port's,
    # both clusters up at once in this process: the same responses over
    # handles and HTTP, and the same keys in serve.status().
    import ray_tpu
    from ray_tpu import serve as jserve

    def graph(s, get):
        @s.deployment
        class Square:
            def __call__(self, x):
                return x * x

        @s.deployment(num_replicas=2, route_prefix="/sum")
        class SumOf:
            def __init__(self, square):
                self.square = square

            def __call__(self, payload):
                return {"sum": sum(get(self.square.remote(x))
                                   for x in payload["xs"])}

        return SumOf.bind(Square.bind())

    ray_tpu.init(num_cpus=4)
    try:
        handles = {"jax": jserve.run(graph(jserve, ray_tpu.get)),
                   "port": serve.run(graph(serve, ray_tpu_torch.get))}
        gets = {"jax": ray_tpu.get, "port": ray_tpu_torch.get}
        ports = {"jax": jserve.http_port(), "port": serve.http_port()}
        assert ports["jax"] != ports["port"]
        answers = {k: gets[k]([h.remote({"xs": [1, 2, 3]}),
                               h.remote({"xs": [4]})])
                   for k, h in handles.items()}
        assert answers["jax"] == answers["port"] == [{"sum": 14},
                                                     {"sum": 16}]
        over_http = {k: _post(p, "/sum", {"xs": [5, 6]})
                     for k, p in ports.items()}
        assert over_http["jax"] == over_http["port"] == {
            "result": {"sum": 61}}
        st = {"jax": jserve.status(), "port": serve.status()}
        assert set(st["jax"]) == set(st["port"]) == {"Square", "SumOf"}
        for name in ("Square", "SumOf"):
            assert set(st["jax"][name]) == set(st["port"][name])
            assert st["jax"][name]["target"] == st["port"][name]["target"]
    finally:
        try:
            jserve.shutdown()
        finally:
            ray_tpu.shutdown()
