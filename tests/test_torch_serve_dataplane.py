"""The port's Serve data plane, tenancy admission and gRPC ingress on the
CPU.

The tests of tests/test_serve_dataplane.py, tests/test_tenancy.py (those
not marked slow) and tests/test_serve_grpc.py on `ray_tpu_torch`, each
naming the reference test it mirrors, on one module-scoped port cluster:
each test that deploys tears its deployments down with `serve.shutdown()`.
The gRPC tests skip only where `grpc` is not installed.
"""

import asyncio
import concurrent.futures
import json
import time
import urllib.error
import urllib.request

import msgpack
import pytest

try:
    import grpc
except ImportError:  # the gRPC tests skip
    grpc = None

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve import dataplane
from ray_tpu_torch.tenancy import (
    QuotaExceeded,
    TenantSpec,
    TokenBucket,
    WfqScheduler,
)


@pytest.fixture(scope="module", autouse=True)
def cluster():
    ray_tpu_torch.init(num_cpus=8)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture()
def serve_cluster():
    yield
    serve.shutdown()


def _post(port, path, payload, timeout=30):
    data = payload if isinstance(payload, (bytes, bytearray)) \
        else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def _proxy_counters():
    proxy = ray_tpu_torch.get_actor("SERVE_PROXY", namespace="serve")
    return ray_tpu_torch.get(proxy.counters.remote(), timeout=10)


# ------------------------------------------------------------------ codec


def test_frame_codec_roundtrip():
    # test_serve_dataplane.py::test_frame_codec_roundtrip
    meta = {"v": 1, "reqs": [{"k": "http", "n": 3}, {"k": "call", "n": 0},
                             {"k": "http", "n": 5}]}
    parts = dataplane.encode_frame(meta, [b"abc", b"hello"])
    buf = b"".join(bytes(p) for p in parts)
    out_meta, region = dataplane.decode_frame(buf)
    assert out_meta == meta
    bodies = dataplane.slice_bodies(region,
                                    [r["n"] for r in out_meta["reqs"]])
    assert [bytes(b) for b in bodies] == [b"abc", b"", b"hello"]


def test_error_frame_roundtrip():
    # test_serve_dataplane.py::test_error_frame_roundtrip
    buf = b"".join(bytes(p) for p in
                   dataplane.encode_error_frame(ValueError("boom")))
    meta, region = dataplane.decode_frame(buf)
    assert meta["err"] == "ValueError: boom"
    assert region.nbytes == 0


# --------------------------------------------------------- pick semantics


class _Handle:
    def __init__(self, name):
        self.name = name


def _router_with(entry, local_node="node-a"):
    from ray_tpu_torch.serve.router import Router

    router = Router.__new__(Router)  # no threads, no controller
    router._local_node = local_node
    router._inflight = {}
    return router, entry


def test_pick_prefers_colocated_pack_first():
    # test_serve_dataplane.py::test_pick_prefers_colocated_pack_first
    entry = {"max_concurrent_queries": 2,
             "replicas": [("a", _Handle("a")), ("b", _Handle("b")),
                          ("c", _Handle("c"))],
             "nodes": {"a": "node-a", "b": "node-a", "c": "node-b"},
             "depths": {}}
    router, entry = _router_with(entry)
    first = router._pick(entry)
    assert first[2] is True  # co-located
    router._inflight[first[0]] = 1
    second = router._pick(entry)
    # Pack-first: the loaded co-located replica wins while under limit.
    assert second[:2] == first[:2]
    router._inflight[first[0]] = 2  # saturated: spill to the other local
    third = router._pick(entry)
    assert third[2] is True and third[0] != first[0]
    # All co-located saturated -> the remote replica (not co-located).
    router._inflight[third[0]] = 2
    fourth = router._pick(entry)
    assert fourth[0] == "c" and fourth[2] is False


def test_pick_p2c_uses_pushed_depth_and_exclude():
    # test_serve_dataplane.py::test_pick_p2c_uses_pushed_depth_and_exclude
    entry = {"max_concurrent_queries": 8,
             "replicas": [("r1", _Handle("r1")), ("r2", _Handle("r2"))],
             "nodes": {"r1": "node-b", "r2": "node-c"},
             "depths": {"r1": 6, "r2": 0}}
    router, entry = _router_with(entry, local_node="node-a")
    # Two candidates: p2c compares both every draw -> always the lighter.
    for _ in range(10):
        assert router._pick(entry)[0] == "r2"
    # Excluding the winner forces the heavier one.
    assert router._pick(entry, exclude={"r2"})[0] == "r1"
    # Saturation is respected even when excluded set empties the field.
    router._inflight["r1"] = 8
    assert router._pick(entry, exclude={"r2"}) is None


def test_pick_never_routes_outside_the_table():
    # test_serve_dataplane.py::test_pick_never_routes_outside_the_table
    # DEAD/draining replicas are removed from the table by the
    # controller; _pick can only ever return a listed (RUNNING) replica.
    entry = {"max_concurrent_queries": 4,
             "replicas": [("live", _Handle("live"))],
             "nodes": {}, "depths": {}}
    router, entry = _router_with(entry, local_node=None)
    for _ in range(20):
        assert router._pick(entry)[0] == "live"


# ------------------------------------------------- replica frame dispatch


def _run_replica_frame(user_cls, reqs, bodies):
    from ray_tpu_torch.serve.replica import Replica

    replica = Replica("D", user_cls, (), {}, "D#0")
    frame = b"".join(
        bytes(p) for p in dataplane.encode_frame({"v": 1, "reqs": reqs},
                                                 [b for b in bodies if b]))

    async def main():
        return await replica.__serve_raw_dispatch__(memoryview(frame))

    out = b"".join(bytes(p) for p in asyncio.run(main()))
    meta, region = dataplane.decode_frame(out)
    chunks = dataplane.slice_bodies(region,
                                    [r["n"] for r in meta["resps"]])
    return meta["resps"], [bytes(c) for c in chunks], replica


def test_coalesced_frame_isolates_per_request_errors():
    # test_serve_dataplane.py::test_coalesced_frame_isolates_per_request_errors
    class Flaky:
        def __call__(self, payload):
            if payload == "bad":
                raise ValueError("poisoned request")
            return {"ok": payload}

    reqs = [{"k": "http", "m": "POST", "n": len(b)} for b in
            (b'"good"', b'"bad"', b'"also-good"')]
    resps, chunks, _ = _run_replica_frame(
        Flaky, reqs, [b'"good"', b'"bad"', b'"also-good"'])
    assert "err" not in resps[0] and json.loads(chunks[0]) == {
        "result": {"ok": "good"}}
    assert "poisoned request" in resps[1]["err"]
    assert resps[1].get("code") == 500
    assert "err" not in resps[2] and json.loads(chunks[2]) == {
        "result": {"ok": "also-good"}}


def test_draining_replica_refuses_frames_as_retriable():
    # test_serve_dataplane.py::test_draining_replica_refuses_frames_as_retriable
    class Echo:
        def __call__(self, payload):
            return payload

    from ray_tpu_torch.serve.replica import Replica

    replica = Replica("D", Echo, (), {}, "D#0")
    replica._draining = True
    frame = b"".join(bytes(p) for p in dataplane.encode_frame(
        {"v": 1, "reqs": [{"k": "http", "m": "GET", "n": 0}]}, []))

    async def main():
        return await replica.__serve_raw_dispatch__(memoryview(frame))

    meta, _ = dataplane.decode_frame(
        b"".join(bytes(p) for p in asyncio.run(main())))
    entry = meta["resps"][0]
    assert entry["retriable"] is True and "draining" in entry["err"]


def test_batched_method_gangs_one_frame():
    # test_serve_dataplane.py::test_batched_method_gangs_one_frame
    sizes = []

    class Batched:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        async def __call__(self, items):
            sizes.append(len(items))
            return [i * 2 for i in items]

    reqs = [{"k": "http", "m": "POST", "n": 1} for _ in range(4)]
    resps, chunks, _ = _run_replica_frame(
        Batched, reqs, [b"1", b"2", b"3", b"4"])
    assert [json.loads(c)["result"] for c in chunks] == [2, 4, 6, 8]
    # One coalesced frame -> ONE gang batch (single flusher wakeup).
    assert sizes == [4]


# ------------------------------------------------------------- end to end


def test_fastpath_echo_is_pickle_free(serve_cluster):
    # test_serve_dataplane.py::test_fastpath_echo_is_pickle_free
    @serve.deployment(num_replicas=2, max_concurrent_queries=32)
    class Echo:
        def __call__(self, payload):
            return payload

    serve.run(Echo.bind())
    port = serve.http_port()
    c0 = _proxy_counters()
    n = 30
    for i in range(n):
        status, body = _post(port, "/Echo", i)
        assert status == 200 and json.loads(body) == {"result": i}
    # Non-JSON payloads ride raw too: a str result returns as raw text.
    status, body = _post(port, "/Echo", b"not json at all")
    assert status == 200 and body == b"not json at all"
    c1 = _proxy_counters()
    assert c1["raw_requests"] - c0["raw_requests"] == n + 1
    assert c1["fallback_requests"] == c0["fallback_requests"]
    # Replica side saw the same requests as raw frames.
    got = 0
    for rid in ("Echo#0", "Echo#1"):
        rep = ray_tpu_torch.get_actor(f"SERVE_REPLICA::{rid}", namespace="serve")
        got += ray_tpu_torch.get(rep.stats.remote())["fastpath"]["requests"]
    assert got >= n + 1


def test_fastpath_bytes_response_raw(serve_cluster):
    # test_serve_dataplane.py::test_fastpath_bytes_response_raw
    @serve.deployment(num_replicas=1)
    class Blob:
        def __call__(self, payload):
            return b"\x00\x01binary"

    serve.run(Blob.bind())
    port = serve.http_port()
    status, body = _post(port, "/Blob", {"x": 1})
    assert status == 200 and body == b"\x00\x01binary"


def test_fastpath_generator_streams_chunks(serve_cluster):
    # test_serve_dataplane.py::test_fastpath_generator_streams_chunks
    @serve.deployment(num_replicas=1)
    class Gen:
        def __call__(self, payload):
            def produce():
                for i in range(5):
                    yield f"tok{i} "
            return produce()

    serve.run(Gen.bind())
    port = serve.http_port()
    c0 = _proxy_counters()
    status, body = _post(port, "/Gen", {"go": 1})
    assert status == 200
    assert body == b"tok0 tok1 tok2 tok3 tok4 "
    c1 = _proxy_counters()
    assert c1["stream_pulls"] > c0["stream_pulls"]


def test_replica_death_mid_request_retries_once(serve_cluster):
    # test_serve_dataplane.py::test_replica_death_mid_request_retries_once
    @serve.deployment(num_replicas=2, max_concurrent_queries=4)
    class Slow:
        def __call__(self, payload):
            time.sleep(0.8)
            return {"done": payload}

    serve.run(Slow.bind())
    port = serve.http_port()
    _post(port, "/Slow", -1)  # warm both the route and a connection

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        futs = [pool.submit(_post, port, "/Slow", i, 60) for i in range(8)]
        time.sleep(0.3)  # both replicas now hold in-flight requests
        victim = ray_tpu_torch.get_actor("SERVE_REPLICA::Slow#0",
                                   namespace="serve")
        ray_tpu_torch.kill(victim)
        results = [f.result() for f in futs]
    # Every request completed exactly once despite the mid-flight death:
    # the lost frame's requests were re-routed to the surviving replica.
    assert all(status == 200 for status, _ in results)
    assert _proxy_counters()["retries"] >= 1


def test_draining_requests_reroute_e2e(serve_cluster):
    # test_serve_dataplane.py::test_draining_requests_reroute_e2e
    @serve.deployment(num_replicas=2, max_concurrent_queries=16)
    class Echo:
        def __call__(self, payload):
            return payload

    serve.run(Echo.bind())
    port = serve.http_port()
    _post(port, "/Echo", 0)
    # Put one replica into draining out from under the router: the fast
    # lane must treat its refusal as retriable and re-route, so no
    # request is ever served by (or failed on) a draining replica.
    rep = ray_tpu_torch.get_actor("SERVE_REPLICA::Echo#0", namespace="serve")
    ray_tpu_torch.get(rep.prepare_shutdown.remote(0.1))
    for i in range(6):
        status, body = _post(port, "/Echo", i)
        assert status == 200 and json.loads(body) == {"result": i}


def test_scale_to_zero_round_trip(serve_cluster):
    # test_serve_dataplane.py::test_scale_to_zero_round_trip
    @serve.deployment(
        max_concurrent_queries=8,
        autoscaling_config=serve.AutoscalingConfig(
            min_replicas=0, max_replicas=2, target_ongoing_requests=4.0,
            upscale_delay_s=0.2, downscale_delay_s=0.6),
    )
    class Cold:
        def __call__(self, payload):
            return {"served": payload}

    serve.run(Cold.bind())
    port = serve.http_port()
    # Deploys PARKED: route exists, zero replicas.
    st = serve.status()["Cold"]
    assert st["target"] == 0 and not st["replicas"]

    # First request cold-starts a replica through the wake path. The
    # bound is deliberately generous for tier-1 (the bench captures the
    # real number); correctness is "buffered, then served".
    t0 = time.monotonic()
    status, body = _post(port, "/Cold", 1, timeout=40)
    cold_ms = (time.monotonic() - t0) * 1e3
    assert status == 200 and json.loads(body) == {"result": {"served": 1}}
    assert cold_ms < 30_000
    st = serve.status()["Cold"]
    assert st["cold_start_ms"] is not None

    # Idle long enough -> parked again (scale back to zero).
    deadline = time.time() + 30
    while time.time() < deadline:
        st = serve.status()["Cold"]
        if st["target"] == 0 and not st["replicas"]:
            break
        time.sleep(0.2)
    else:
        pytest.fail("deployment did not scale back to zero when idle")

    # And the next request wakes it again.
    status, body = _post(port, "/Cold", 2, timeout=40)
    assert status == 200 and json.loads(body) == {"result": {"served": 2}}


def test_handle_path_scale_to_zero(serve_cluster):
    # test_serve_dataplane.py::test_handle_path_scale_to_zero
    @serve.deployment(
        autoscaling_config=serve.AutoscalingConfig(
            min_replicas=0, max_replicas=1, upscale_delay_s=0.2,
            downscale_delay_s=5.0),
    )
    class Cold:
        def __call__(self, payload):
            return payload + 1

    handle = serve.run(Cold.bind())
    # Python handles wake parked deployments through the same router.
    assert ray_tpu_torch.get(handle.remote(41), timeout=40) == 42


def test_park_buffer_byte_cap(monkeypatch):
    # test_serve_dataplane.py::test_park_buffer_byte_cap
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    class _StubRouter:
        _version = 0

        def reserve_fast(self, deployment, exclude=None, model_id=None):
            return None

        def deployment_state(self, deployment):
            return "parked"

        def live_tenants(self):
            return set()

        def entry_snapshot(self, deployment):
            return None

        def wake(self, deployment):
            pass

        def has_replicas(self, deployment):
            return False

        def live_replica_ids(self):
            return set()

        def release(self, replica_id):
            pass

    monkeypatch.setattr(GLOBAL_CONFIG, "serve_park_max_bytes", 8)
    monkeypatch.setattr(GLOBAL_CONFIG, "serve_park_timeout_s", 0.2)
    lane = dataplane.FastLane(_StubRouter(), runtime=None)

    async def main():
        loop = asyncio.get_running_loop()
        with pytest.raises(dataplane.ParkBufferFull):
            await lane.dispatch(loop, "D", {"k": "http"}, b"x" * 64)
        # Under the cap the request buffers, then times out unserved.
        with pytest.raises(TimeoutError):
            await lane.dispatch(loop, "D", {"k": "http"}, b"xx")
        assert lane._park_bytes == {}  # accounting drained on both paths

    asyncio.run(main())
    assert dataplane.COUNTERS["park_rejected"] >= 1


def test_grpc_rides_the_same_fastpath(serve_cluster):
    # test_serve_dataplane.py::test_grpc_rides_the_same_fastpath
    pytest.importorskip("grpc")

    @serve.deployment(num_replicas=1)
    class Echo:
        def __call__(self, payload):
            return {"via": payload}

    serve.run(Echo.bind())
    port = serve.grpc_port()
    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    call = ch.unary_unary("/ray_tpu_torch.serve/Echo")
    out = msgpack.unpackb(call(msgpack.packb("grpc"), timeout=30))
    assert out == {"via": "grpc"}
    gp = ray_tpu_torch.get_actor("SERVE_GRPC_PROXY", namespace="serve")
    counters = ray_tpu_torch.get(gp.counters.remote())
    # Shared-path proof: the gRPC ingress dispatched through the SAME
    # raw fast lane as HTTP (raw counter moved, no pickle fallback).
    assert counters["raw_requests"] >= 1
    assert counters["fallback_requests"] == 0
    ch.close()


def _post_h(port, path, payload, timeout=30):
    data = json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read(), dict(resp.headers)


# ---------------------------------------------------------------- registry


def test_tenant_spec_tier_defaults():
    # test_tenancy.py::test_tenant_spec_tier_defaults
    gold = TenantSpec(name="acme", tier="gold")
    assert gold.weight == 8
    bronze = TenantSpec(name="smol", tier="bronze", rps_limit=10)
    assert bronze.weight == 1
    assert bronze.burst == 10.0          # defaults to 1s of rps
    override = TenantSpec(name="w", tier="bronze", weight=3)
    assert override.weight == 3
    with pytest.raises(ValueError):
        TenantSpec(name="x", tier="platinum")
    with pytest.raises(ValueError):
        TenantSpec(name="")
    # Wire round trip (the routing table pushes qos dicts).
    assert TenantSpec(**gold.qos()) == gold


# ------------------------------------------------------------ token bucket


def test_token_bucket_admits_burst_then_meters():
    # test_tenancy.py::test_token_bucket_admits_burst_then_meters
    b = TokenBucket(rate=10.0, burst=5.0, now=0.0)
    assert all(b.take(now=0.0) == 0.0 for _ in range(5))
    wait = b.take(now=0.0)
    assert wait == pytest.approx(0.1)    # 1 token / 10 rps
    # Refill: 0.25s later there are 2.5 tokens.
    assert b.take(now=0.25) == 0.0
    assert b.take(now=0.25) == 0.0
    assert b.take(now=0.25) > 0.0
    # Never banks beyond burst.
    assert b.take(now=100.0) == 0.0
    b2 = TokenBucket(rate=0.0, burst=1.0, now=0.0)
    b2.take(now=0.0)
    assert b2.take(now=0.0) == float("inf")


def test_admission_bucket_survives_unrelated_republish():
    # test_tenancy.py::test_admission_bucket_survives_unrelated_republish
    """A re-pushed entry with the SAME qos_version (depth moves, other
    tenants registering) must not rebuild the token bucket — a rebuild
    hands the tenant a full burst of fresh tokens. Only a bumped
    per-tenant version (a real spec update) rebuilds."""
    from ray_tpu_torch.tenancy.admission import TenantAdmission

    adm = TenantAdmission()
    entry = {"qos": TenantSpec(name="t", rps_limit=2, burst=2).qos(),
             "qos_version": 5}
    st = adm.resolve(entry)
    for _ in range(2):
        adm.admit(st)
        adm.release(st)
    with pytest.raises(QuotaExceeded):
        adm.admit(adm.resolve(entry))
    # Same version re-pushed (fresh dict, as a table push delivers it):
    # the drained bucket stays drained.
    with pytest.raises(QuotaExceeded):
        adm.admit(adm.resolve(
            {"qos": dict(entry["qos"]), "qos_version": 5}))
    # A true update (bumped per-tenant version) rebuilds.
    adm.admit(adm.resolve(
        {"qos": dict(entry["qos"]), "qos_version": 6}))


# -------------------------------------------------------------------- WFQ


def test_wfq_drains_by_weight_without_starvation():
    # test_tenancy.py::test_wfq_drains_by_weight_without_starvation
    """16 gold (weight 8) + 16 bronze (weight 1) waiters contend for a
    trickle of capacity: the first 9 admissions split ~8:1 by weight,
    and full capacity drains EVERY waiter (no starvation)."""

    async def main():
        loop = asyncio.get_running_loop()
        wfq = WfqScheduler()
        capacity = {"slots": 0}
        served = []

        def make_try(tag):
            def try_reserve():
                if capacity["slots"] > 0:
                    capacity["slots"] -= 1
                    served.append(tag)
                    return (tag, None, False)
                return None
            return try_reserve

        tasks = []
        for _ in range(16):
            tasks.append(asyncio.ensure_future(wfq.acquire(
                loop, "gold", 8, make_try("g"), 5.0)))
            tasks.append(asyncio.ensure_future(wfq.acquire(
                loop, "bronze", 1, make_try("b"), 5.0)))
        await asyncio.sleep(0.02)        # everyone parked
        assert wfq.queued() == 32
        capacity["slots"] = 9
        while len(served) < 9:
            await asyncio.sleep(0.005)
        first = served[:9]
        assert first.count("g") == 8 and first.count("b") == 1, first
        capacity["slots"] = 10_000
        await asyncio.gather(*tasks)
        assert len(served) == 32         # nobody starved
        await asyncio.sleep(0.01)        # pump exits; state resets
        assert not wfq.has_waiters()

    asyncio.run(main())


def test_wfq_timeout_and_head_of_line():
    # test_tenancy.py::test_wfq_timeout_and_head_of_line
    """A waiter whose deployment never frees times out; a different
    tenant's head targeting a deployment WITH capacity is not blocked
    behind it (no cross-deployment head-of-line blocking)."""

    async def main():
        loop = asyncio.get_running_loop()
        wfq = WfqScheduler()
        stuck = asyncio.ensure_future(wfq.acquire(
            loop, "stuck", 8, lambda: None, 0.15, deployment="A"))
        ok = asyncio.ensure_future(wfq.acquire(
            loop, "other", 1, lambda: ("r", None, False), 5.0,
            deployment="B"))
        assert await ok == ("r", None, False)
        with pytest.raises(TimeoutError):
            await stuck

    asyncio.run(main())


def test_wfq_same_tenant_no_cross_deployment_blocking():
    # test_tenancy.py::test_wfq_same_tenant_no_cross_deployment_blocking
    """Queues key by (tenant, deployment): the SAME tenant's waiter for
    a deployment with free capacity is never stuck behind its earlier
    waiter for a saturated one (and neither is the untenanted pool)."""

    async def main():
        loop = asyncio.get_running_loop()
        wfq = WfqScheduler()
        blocked = asyncio.ensure_future(wfq.acquire(
            loop, None, 1, lambda: None, 0.3, deployment="sat"))
        await asyncio.sleep(0.01)   # "sat" waiter queued first
        ok = asyncio.ensure_future(wfq.acquire(
            loop, None, 1, lambda: ("r", None, False), 5.0,
            deployment="free"))
        assert await ok == ("r", None, False)
        with pytest.raises(TimeoutError):
            await blocked

    asyncio.run(main())


def test_wfq_cancelled_waiter_returns_its_grant():
    # test_tenancy.py::test_wfq_cancelled_waiter_returns_its_grant
    """A grant racing the waiter's cancellation (client disconnect)
    carries an already-reserved router slot: it must be handed to
    on_drop, never silently discarded (that slot would leak forever)."""

    async def main():
        loop = asyncio.get_running_loop()
        wfq = WfqScheduler()
        dropped = []
        task = asyncio.ensure_future(wfq.acquire(
            loop, None, 1, lambda: None, 5.0, deployment="d",
            on_drop=dropped.append))
        await asyncio.sleep(0.01)
        # The pump grants in the same tick the client disconnects.
        wfq._queues[("", "d")][0].fut.set_result(("slot", None, False))
        task.cancel()
        try:
            result = await task
            # py < 3.12: wait_for returns the completed result despite
            # the cancel — the grant is consumed normally, no drop.
            assert result == ("slot", None, False)
            assert dropped == []
        except asyncio.CancelledError:
            # py >= 3.12: the cancellation wins; the grant (and its
            # reserved slot) must be handed back, never discarded.
            assert dropped == [("slot", None, False)]

    asyncio.run(main())


def test_wfq_idle_deployment_bypasses_other_pools_backlog():
    # test_tenancy.py::test_wfq_idle_deployment_bypasses_other_pools_backlog
    """has_waiters_for: a backlog on one deployment must not force an
    idle deployment's requests through the pump (and its backoff)."""

    async def main():
        loop = asyncio.get_running_loop()
        wfq = WfqScheduler()
        blocked = asyncio.ensure_future(wfq.acquire(
            loop, None, 1, lambda: None, 0.3, deployment="sat"))
        await asyncio.sleep(0.01)
        assert wfq.has_waiters()
        assert wfq.has_waiters_for("sat")
        assert not wfq.has_waiters_for("idle")   # the dispatch bypass
        with pytest.raises(TimeoutError):
            await blocked

    asyncio.run(main())


def test_wfq_waiter_exits_on_deployment_state_change():
    # test_tenancy.py::test_wfq_waiter_exits_on_deployment_state_change
    """A fair-queued waiter whose deployment is deleted (or parked)
    mid-wait leaves the queue immediately and falls back through the
    dispatch loop's state handling — never polls a dead closure to the
    60s request timeout."""
    from ray_tpu_torch.serve import dataplane

    class _Router:
        _version = 0

        def __init__(self):
            self.state = "active"

        def reserve_fast(self, d, exclude=None, model_id=None):
            return None          # always saturated

        def deployment_state(self, d):
            return self.state

        def entry_snapshot(self, d):
            return {"max_concurrent_queries": 1, "replicas": [("r", None)]}

        def live_tenants(self):
            return set()

        def live_replica_ids(self):
            return set()

        def release(self, rid):
            pass

    async def main():
        loop = asyncio.get_running_loop()
        router = _Router()
        lane = dataplane.FastLane(router, runtime=None)
        task = asyncio.ensure_future(
            lane.dispatch(loop, "D", {"k": "http"}, b"x"))
        await asyncio.sleep(0.05)            # parked in the fair queue
        assert lane._wfq.has_waiters()
        router.state = "unknown"             # deployment deleted
        t0 = time.monotonic()
        assert await task is None            # classic lane owns it now
        assert time.monotonic() - t0 < 2.0   # not the 60s timeout

    asyncio.run(main())


# ------------------------------------------------------------- e2e quotas


def test_over_quota_answers_429_with_retry_after(serve_cluster):
    # test_tenancy.py::test_over_quota_answers_429_with_retry_after
    serve.register_tenant("smol", tier="bronze", rps_limit=5, burst=5)

    @serve.deployment(num_replicas=1, max_concurrent_queries=8,
                      tenant="smol")
    class Echo:
        def __call__(self, payload):
            return payload

    serve.run(Echo.bind())
    port = serve.http_port()
    statuses, retry_after = [], None
    for i in range(30):
        try:
            status, _, _ = _post_h(port, "/Echo", {"i": i})
        except urllib.error.HTTPError as e:
            status = e.code
            if status == 429:
                retry_after = e.headers.get("Retry-After")
                body = json.loads(e.read())
                assert "quota" in body["error"]
        statuses.append(status)
    assert statuses.count(200) >= 5          # the burst was admitted
    assert statuses.count(429) >= 10         # the blast was rejected
    assert retry_after is not None and float(retry_after) > 0
    # Over-quota rejections never reached a replica (fast 429 at the
    # proxy door): the engine-side processed count equals the 200s.
    proxy = ray_tpu_torch.get_actor("SERVE_PROXY", namespace="serve")
    counters = ray_tpu_torch.get(proxy.counters.remote(), timeout=10)
    assert counters["quota_rejected"] >= 10


def test_unmetered_tenant_unaffected_by_neighbour_quota(serve_cluster):
    # test_tenancy.py::test_unmetered_tenant_unaffected_by_neighbour_quota
    serve.register_tenant("noisy", tier="bronze", rps_limit=2, burst=2)
    serve.register_tenant("calm", tier="gold")

    @serve.deployment(num_replicas=1, tenant="noisy")
    class Noisy:
        def __call__(self, payload):
            return payload

    @serve.deployment(num_replicas=1, tenant="calm")
    class Calm:
        def __call__(self, payload):
            return payload

    serve.run(Noisy.bind())
    serve.run(Calm.bind())
    port = serve.http_port()
    noisy_429 = 0
    for i in range(10):
        try:
            _post_h(port, "/Noisy", {"i": i})
        except urllib.error.HTTPError as e:
            assert e.code == 429
            noisy_429 += 1
        status, _, _ = _post_h(port, "/Calm", {"i": i})
        assert status == 200                 # calm tenant never throttled
    assert noisy_429 >= 5


def test_deploy_with_unknown_tenant_fails_fast(serve_cluster):
    # test_tenancy.py::test_deploy_with_unknown_tenant_fails_fast
    @serve.deployment(tenant="ghost")
    class Echo:
        def __call__(self, payload):
            return payload

    with pytest.raises(Exception, match="unregistered tenant"):
        serve.run(Echo.bind())


def test_tenant_registry_roundtrip_and_unregister(serve_cluster):
    # test_tenancy.py::test_tenant_registry_roundtrip_and_unregister
    serve.register_tenant("acme", tier="gold", rps_limit=100,
                          max_inflight=32)
    specs = serve.tenants()
    assert specs["acme"]["tier"] == "gold"
    assert specs["acme"]["weight"] == 8

    @serve.deployment(tenant="acme")
    class Echo:
        def __call__(self, payload):
            return payload

    serve.run(Echo.bind())
    with pytest.raises(Exception, match="still owns"):
        serve.unregister_tenant("acme")
    serve.delete("Echo")
    serve.unregister_tenant("acme")
    assert "acme" not in serve.tenants()


# ------------------------------------------- sharded reconciler + restore


def _deploy_zoo(n, tenants=("gold-t", "silver-t", "bronze-t")):
    @serve.deployment
    class ZooEcho:
        def __call__(self, payload):
            return payload

    for i, tier in enumerate(("gold", "silver", "bronze")):
        serve.register_tenant(tenants[i], tier=tier, rps_limit=500)
    for i in range(n):
        serve.run(ZooEcho.options(
            name=f"zoo{i:03d}", tenant=tenants[i % len(tenants)],
            autoscaling_config=serve.AutoscalingConfig(
                min_replicas=0, max_replicas=1)).bind())


def _controller_stats():
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME, SERVE_NAMESPACE

    c = ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
    return ray_tpu_torch.get(c.reconcile_stats.remote(), timeout=10)


def test_reconciler_skips_parked_deployments(serve_cluster):
    # test_tenancy.py::test_reconciler_skips_parked_deployments
    """With a mostly-parked zoo the per-tick scan set stays near the
    anti-entropy shard size — NOT the deployment count."""
    _deploy_zoo(24)

    @serve.deployment(num_replicas=1)
    class Live:
        def __call__(self, payload):
            return payload

    serve.run(Live.bind())
    deadline = time.time() + 10
    while time.time() < deadline:
        stats = _controller_stats()
        if stats["ticks"] > 5 and stats["last_scanned"] <= 8:
            break
        time.sleep(0.2)
    assert stats["deployments"] == 25
    # 24 parked + 1 active: a tick scans the active deployment plus
    # ceil(24/16) = 2 anti-entropy picks, never the whole zoo.
    assert stats["last_scanned"] <= 8, stats
    assert stats["last_parked_skipped"] >= 16, stats
    # Parked deployments still wake: first request cold-starts.
    port = serve.http_port()
    status, body, _ = _post_h(port, "/zoo003", {"x": 1}, timeout=60)
    assert status == 200 and json.loads(body) == {"result": {"x": 1}}


# ------------------------------------------------------------------ gRPC


@pytest.fixture()
def grpc_serve():
    pytest.importorskip("grpc")

    @serve.deployment(num_replicas=1)
    class Echo:
        def __call__(self, payload):
            return {"echo": payload}

    @serve.deployment(route_prefix="/Boomer")
    class Boomer:
        def __call__(self, payload):
            raise RuntimeError("deliberate grpc failure")

    @serve.deployment(route_prefix="/Raw")
    class Raw:
        def __call__(self, payload):
            # Opaque-bytes passthrough: payload arrives as bytes when not
            # msgpack, and a bytes result returns verbatim.
            assert isinstance(payload, bytes)
            return payload[::-1]

    serve.run(Echo.bind())
    serve.run(Boomer.bind())
    serve.run(Raw.bind())
    port = serve.grpc_port()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        yield channel
    finally:
        channel.close()
        serve.shutdown()


def _call(channel, deployment: str, body: bytes, timeout=30) -> bytes:
    method = channel.unary_unary(f"/ray_tpu_torch.serve/{deployment}")
    return method(body, timeout=timeout)


def test_grpc_echo_msgpack_roundtrip(grpc_serve):
    # test_serve_grpc.py::test_grpc_echo_msgpack_roundtrip
    for payload in [{"x": 1, "s": "hi"}, [1, 2, 3], 42, "text"]:
        out = msgpack.unpackb(
            _call(grpc_serve, "Echo", msgpack.packb(payload)), raw=False)
        assert out == {"echo": payload}


def test_grpc_opaque_bytes_passthrough(grpc_serve):
    # test_serve_grpc.py::test_grpc_opaque_bytes_passthrough
    # 0xc1 is never valid msgpack, so the body stays bytes end to end.
    blob = b"\xc1raw-bytes-body"
    assert _call(grpc_serve, "Raw", blob) == blob[::-1]


def test_grpc_deployment_error_is_internal(grpc_serve):
    # test_serve_grpc.py::test_grpc_deployment_error_is_internal
    with pytest.raises(grpc.RpcError) as err:
        _call(grpc_serve, "Boomer", msgpack.packb({}))
    assert err.value.code() == grpc.StatusCode.INTERNAL
    assert "deliberate grpc failure" in err.value.details()


def test_grpc_generator_deployment_unimplemented(grpc_serve):
    # test_serve_grpc.py::test_grpc_generator_deployment_unimplemented
    @serve.deployment(route_prefix="/Gen")
    class Gen:
        def __call__(self, payload):
            def gen():
                yield 1
            return gen()

    serve.run(Gen.bind())
    with pytest.raises(grpc.RpcError) as err:
        _call(grpc_serve, "Gen", msgpack.packb({}))
    assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
    assert "HTTP proxy" in err.value.details()


def test_grpc_unknown_deployment_not_found(grpc_serve):
    # test_serve_grpc.py::test_grpc_unknown_deployment_not_found
    with pytest.raises(grpc.RpcError) as err:
        _call(grpc_serve, "Nope", msgpack.packb({}))
    assert err.value.code() == grpc.StatusCode.NOT_FOUND


def test_grpc_and_http_share_deployments(grpc_serve):
    # test_serve_grpc.py::test_grpc_and_http_share_deployments
    import json
    import urllib.request

    http = serve.http_port()
    req = urllib.request.Request(
        f"http://127.0.0.1:{http}/Echo", data=json.dumps({"via": "http"}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert json.loads(resp.read()) == {"result": {"echo": {"via": "http"}}}
    out = msgpack.unpackb(
        _call(grpc_serve, "Echo", msgpack.packb({"via": "grpc"})), raw=False)
    assert out == {"echo": {"via": "grpc"}}
