"""The port's host collective plane (`ray_tpu_torch.collective`) on the CPU.

Port counterparts of the 13 tests of tests/test_collective.py, each under
the name of the reference test it mirrors, on one module-scoped port
cluster of four raylets (a head of 1 CPU and three nodes of 1 CPU). Most
drive ranks as threads over those raylets (RayletTransport: the GCS
control plane and the chunked transfer plane, no worker processes); the
runtime transport is covered with rank actors and with two `TorchTrainer`
workers that allreduce through `session.get_collective()`. Allreduce is
held to numpy's sums for numpy trees and for CPU torch trees, and the
port's PackedTree to the JAX package's for the same numpy trees. Where the
reference sleeps to let a rank park, these tests wait until the GCS record
shows it parked.
"""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.collective import CollectiveGroup, RayletTransport
from ray_tpu_torch.collective.buffer import PackedTree, tree_index
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.exceptions import CollectiveError
from ray_tpu_torch.util.collective import (StarCollectiveGroup,
                                           _RendezvousActor)

CHUNK = 256 * 1024
STALL_S = 10.0
WORLD = 4


@pytest.fixture(scope="module", autouse=True)
def cluster():
    """4 raylets, tiny chunks, short stall timeout; the driver connected
    to the head for the actor tests."""
    saved = dict(GLOBAL_CONFIG._overrides)
    GLOBAL_CONFIG._overrides.update({
        "object_transfer_chunk_bytes": CHUNK,
        "collective_stall_timeout_s": STALL_S,
        "collective_ring_min_bytes": 64 * 1024,
        "rpc_connect_timeout_s": 2.0,
    })
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    for _ in range(WORLD - 1):
        c.add_node(num_cpus=1)
    c.wait_for_nodes()
    c.connect()
    try:
        yield c
    finally:
        c.shutdown()
        GLOBAL_CONFIG._overrides.clear()
        GLOBAL_CONFIG._overrides.update(saved)


def _run_ranks(cluster, fn, world=WORLD, join_s=90.0, name="t",
               raylets=None):
    """fn(rank, group) on one thread per rank; returns (results, errors)."""
    raylets = raylets or cluster.raylets
    results, errors = [None] * world, [None] * world

    def run(rank):
        try:
            group = CollectiveGroup(
                name, world, rank, transport=RayletTransport(raylets[rank]))
            try:
                results[rank] = fn(rank, group)
            finally:
                if rank == 0:
                    group.destroy()
                else:
                    group.leave()
        except Exception as e:  # noqa: BLE001 — asserted by callers
            errors[rank] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(join_s)
    return results, errors


def _group_record(cluster, name="t"):
    return cluster.raylets[0].gcs.call("collective_get", {"name": name})


def _wait_record(cluster, name, pred, what, timeout=30.0):
    """Wait until the GCS record of group `name` satisfies `pred`."""
    deadline = time.monotonic() + timeout
    while True:
        rec = _group_record(cluster, name)
        if rec.get("known") and pred(rec):
            return rec
        if time.monotonic() > deadline:
            raise AssertionError(f"group {name!r} never {what}: {rec}")
        time.sleep(0.01)


def _parked(rec) -> int:
    """Ranks parked on a mailbox take."""
    return sum(waiters for _, _, _, waiters in rec["mailbox"])


# --------------------------------------------------------------------------- #
# Numeric parity
# --------------------------------------------------------------------------- #


def _tree(rng, i, kind):
    tree = {"w": rng.standard_normal((1000, 200)).astype(np.float32),
            "b": rng.standard_normal(17),
            "step": np.int64(i + 1),
            "nested": [rng.standard_normal(63).astype(np.float32)]}
    if kind == "torch":
        tree = {k: ([torch.from_numpy(x) for x in v] if isinstance(v, list)
                    else torch.as_tensor(v)) for k, v in tree.items()}
        tree["h"] = torch.from_numpy(
            rng.standard_normal(300).astype(np.float32)).to(torch.bfloat16)
    return tree


def _np(x):
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_ring_allreduce_matches_numpy_on_pytrees(cluster, kind):
    """Ring allreduce (payload >> ring threshold) of a mixed-dtype pytree
    equals the numpy reference on every rank, for sum/max/mean; a torch
    tree comes back as tensors of its own dtypes (bfloat16 summed in
    float32 and rounded once)."""
    rng = np.random.default_rng(7)
    values = [_tree(rng, i, kind) for i in range(WORLD)]

    def fn(rank, group):
        return {"sum": group.allreduce(values[rank], op="sum"),
                "max": group.allreduce(values[rank], op="max"),
                "mean": group.allreduce(values[rank], op="mean")}

    results, errors = _run_ranks(cluster, fn)
    assert not any(errors), errors
    want_w = sum(_np(v["w"]) for v in values)
    want_b = sum(_np(v["b"]) for v in values)
    max_w = np.maximum.reduce([_np(v["w"]) for v in values])
    for out in results:
        np.testing.assert_allclose(_np(out["sum"]["w"]), want_w, atol=1e-4)
        np.testing.assert_allclose(_np(out["sum"]["b"]), want_b, rtol=1e-12)
        assert int(out["sum"]["step"]) == sum(range(1, WORLD + 1))
        np.testing.assert_array_equal(_np(out["max"]["w"]), max_w)
        np.testing.assert_allclose(_np(out["mean"]["w"]), want_w / WORLD,
                                   atol=1e-4)
        np.testing.assert_allclose(
            _np(out["sum"]["nested"][0]),
            sum(_np(v["nested"][0]) for v in values), atol=1e-4)
        if kind == "torch":
            assert isinstance(out["sum"]["w"], torch.Tensor)
            assert out["sum"]["h"].dtype == torch.bfloat16
            assert out["sum"]["step"].dtype == torch.int64
            want_h = sum(_np(v["h"]) for v in values)
            # One bf16 rounding of a float32 sum: within one bf16 ulp.
            np.testing.assert_allclose(_np(out["sum"]["h"]), want_h,
                                       rtol=2 ** -7, atol=1e-6)
    # Identical results on every rank, bit for bit (they all hold the same
    # reduced segments after the all-gather phase).
    for out in results[1:]:
        np.testing.assert_array_equal(_np(out["sum"]["w"]),
                                      _np(results[0]["sum"]["w"]))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_small_payload_inline_path_and_mailbox_drains(cluster, kind):
    """Tiny payloads ride the GCS mailbox inline (fan-in path, no store
    objects); the refcounted mailbox is empty after every op. Sum and mean,
    numpy and torch leaves."""
    def fn(rank, group):
        if kind == "torch":
            value = {"loss": torch.tensor(float(rank)),
                     "n": torch.tensor(rank)}
        else:
            value = {"loss": float(rank), "n": np.int64(rank)}
        out = group.allreduce(value)
        mean = group.allreduce(value, op="mean")
        # Every allreduce (fan-in included) ends with a group sync, so all
        # takes have drained by the time any rank returns. The barrier
        # below fences the record check against a faster rank's teardown
        # (leave/destroy would GC the record under us).
        rec = _group_record(cluster)
        assert rec["known"] and rec["mailbox_keys"] == 0, rec
        group.barrier()
        return out, mean

    results, errors = _run_ranks(cluster, fn)
    assert not any(errors), errors
    for out, mean in results:
        assert float(out["loss"]) == sum(range(WORLD))
        assert int(out["n"]) == sum(range(WORLD))
        assert float(mean["loss"]) == sum(range(WORLD)) / WORLD
    # Graceful leave of every member GC'd the record.
    assert _group_record(cluster) == {"known": False}


def test_allgather_broadcast_reducescatter(cluster):
    rng = np.random.default_rng(3)
    big = rng.integers(0, 255, size=3 * CHUNK + 123,
                       dtype=np.uint8)  # multi-chunk broadcast payload

    def fn(rank, group):
        gathered = group.allgather({"rank": rank})
        bcast = group.broadcast(big if rank == 2 else None, src_rank=2)
        rows = group.reducescatter(
            np.full((WORLD * 3, 5), float(rank), dtype=np.float64))
        trows = group.reducescatter(torch.full((WORLD * 2, 3), float(rank)))
        return gathered, bcast, rows, trows

    results, errors = _run_ranks(cluster, fn)
    assert not any(errors), errors
    want_rows = np.full((3, 5), float(sum(range(WORLD))))
    for rank, (gathered, bcast, rows, trows) in enumerate(results):
        assert [g["rank"] for g in gathered] == list(range(WORLD))
        np.testing.assert_array_equal(np.asarray(bcast), big)
        np.testing.assert_array_equal(rows, want_rows)
        assert torch.equal(trows, torch.full((2, 3), float(sum(range(WORLD)))))


def test_reducescatter_remainder_raises(cluster):
    """shape[0] % world_size != 0 must raise a clear ValueError, not
    silently drop the remainder rows (regression)."""
    def fn(rank, group):
        with pytest.raises(ValueError, match="not divisible"):
            group.reducescatter(np.ones((WORLD * 3 + 1, 4)))
        return True

    results, errors = _run_ranks(cluster, fn)
    assert not any(errors), errors
    assert all(results)
    # The same validation, directly on the helper the star path shares.
    with pytest.raises(ValueError, match="not divisible"):
        tree_index({"x": np.ones((5, 2))}, rank=0, world=4)


def test_packed_tree_roundtrip_unit():
    """Packing layer alone: mixed dtypes, padding, segment reduce; torch
    leaves come back as tensors of their dtype."""
    value = {"a": np.arange(10, dtype=np.float32).reshape(2, 5),
             "b": [np.float64(2.5), np.arange(3, dtype=np.int64)],
             "t": torch.arange(6, dtype=torch.float32).reshape(3, 2)}
    packed = PackedTree(value, segments=4)
    out = packed.unpack()
    np.testing.assert_array_equal(out["a"], value["a"])
    assert float(out["b"][0]) == 2.5
    np.testing.assert_array_equal(out["b"][1], value["b"][1])
    assert torch.equal(out["t"], value["t"])
    other = PackedTree(value, segments=4)
    for s in range(4):
        joined = b"".join(bytes(p) for p in other.segment_parts(s))
        packed.reduce_segment(s, joined, np.add)
    doubled = packed.unpack()
    np.testing.assert_array_equal(doubled["a"], value["a"] * 2)
    assert torch.equal(doubled["t"], value["t"] * 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_tree_matches_reference(seed):
    """For the same numpy tree, the port packs the JAX package's bytes:
    the same per-dtype buffers, layout and wire segments, and the same
    leaves unpacked (with and without the mean divisor). The JAX
    package is imported here, not at module level: rank actors import
    this module and need none of it."""
    from ray_tpu.collective.buffer import PackedTree as RefPackedTree

    rng = np.random.default_rng(seed)
    value = {"w": rng.standard_normal((7, 13)).astype(np.float32),
             "z": [rng.integers(-50, 50, size=11),
                   rng.standard_normal(5).astype(np.float16)],
             "a": np.float64(rng.standard_normal()),
             "c": (rng.integers(0, 9, size=(2, 3)).astype(np.int32),)}
    segments = int(rng.integers(1, 6))
    port, ref = PackedTree(value, segments), RefPackedTree(value, segments)
    assert port.layout == ref.layout and port.seg_elems == ref.seg_elems
    assert port.total_bytes == ref.total_bytes
    assert port.segment_nbytes == ref.segment_nbytes
    for got, want in zip(port.buffers, ref.buffers):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for s in range(segments):
        assert [bytes(p) for p in port.segment_parts(s)] == \
            [bytes(p) for p in ref.segment_parts(s)]
    for divisor in (None, 3):
        got = PackedTree(value, segments).unpack(mean_divisor=divisor)
        want = RefPackedTree(value, segments).unpack(mean_divisor=divisor)
        for g, w in zip([got["w"], *got["z"], got["a"], got["c"][0]],
                        [want["w"], *want["z"], want["a"], want["c"][0]]):
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------- #
# Membership validation
# --------------------------------------------------------------------------- #


def test_world_size_mismatch_raises(cluster):
    g = CollectiveGroup("m1", 4, 0,
                        transport=RayletTransport(cluster.raylets[0]))
    try:
        with pytest.raises(ValueError, match="world_size=4"):
            CollectiveGroup("m1", 3, 1,
                            transport=RayletTransport(cluster.raylets[1]))
    finally:
        g.destroy()


def test_rank_taken_and_rejoin_after_destroy(cluster):
    g0 = CollectiveGroup("m2", 4, 0,
                         transport=RayletTransport(cluster.raylets[0]))
    with pytest.raises(ValueError, match="already held"):
        CollectiveGroup("m2", 4, 0,
                        transport=RayletTransport(cluster.raylets[1]))
    g0.destroy()
    # Fresh epoch: the name is reusable, even with a different world size.
    g1 = CollectiveGroup("m2", 2, 0,
                         transport=RayletTransport(cluster.raylets[1]))
    assert g1.epoch > g0.epoch
    g1.destroy()


# --------------------------------------------------------------------------- #
# Failure semantics
# --------------------------------------------------------------------------- #


def test_member_death_aborts_survivors_with_rank(cluster):
    """Removing one member's node mid-op makes every surviving rank raise a
    CollectiveError naming the dead rank, well inside the stall timeout —
    never a hang. Rank 3 lives on a node of its own, added for this test;
    the node goes once the survivors are parked inside round 2."""
    doomed = cluster.add_node(num_cpus=1)
    cluster.wait_for_nodes()
    raylets = cluster.raylets[:3] + [doomed]
    payload = np.ones(2 * CHUNK, dtype=np.float32)
    round_one = threading.Barrier(WORLD, timeout=60)
    errors = [None] * WORLD
    abort_s = [None] * WORLD

    def run(rank):
        try:
            group = CollectiveGroup(
                "d", WORLD, rank, transport=RayletTransport(raylets[rank]))
            group.allreduce(payload)
            round_one.wait()
            if rank == 3:
                return  # goes silent; its raylet is removed below
            t0 = time.monotonic()
            try:
                group.allreduce(payload)
            finally:
                abort_s[rank] = time.monotonic() - t0
        except Exception as e:  # noqa: BLE001
            errors[rank] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in range(WORLD)]
    for t in threads:
        t.start()
    threads[3].join(60)
    # Each survivor parks on a take that rank 3 feeds, directly or through
    # a parked peer.
    _wait_record(cluster, "d", lambda rec: _parked(rec) == WORLD - 1,
                 "had its survivors parked")
    cluster.remove_node(doomed)
    for t in threads[:3]:
        t.join(60)

    for rank in range(3):
        err = errors[rank]
        assert isinstance(err, CollectiveError), (rank, err)
        assert "rank 3" in str(err), err
        assert 3 in err.dead_ranks, err.dead_ranks
        assert abort_s[rank] < STALL_S, (
            f"rank {rank} took {abort_s[rank]:.1f}s to abort — the death "
            "push did not fire, only the stall timeout would have")
    cluster.raylets[0].gcs.call("collective_destroy", {"name": "d"})


def test_barrier_reusable_across_rounds(cluster):
    """Three barrier rounds on one group, with a straggler each round:
    nobody leaves a barrier before the straggler arrives, and the per-seq
    barrier state is GC'd after each round. The straggler arrives only
    once the GCS shows every other rank arrived at that round's barrier,
    and no rank leaves (rank 0 then destroys the group) before every rank
    has read the record."""
    crossings = []
    lock = threading.Lock()
    checked = threading.Barrier(WORLD, timeout=60)

    def fn(rank, group):
        for rnd in range(3):
            if rank == rnd:  # a different straggler each round
                seq = f"user:{group._seq + 1}"
                _wait_record(
                    cluster, "t",
                    lambda rec: len(rec["barrier_arrivals"].get(seq, ()))
                    == WORLD - 1, f"had {WORLD - 1} ranks at {seq}")
                with lock:
                    crossings.append(("late", rnd, rank))
            group.barrier()
            with lock:
                crossings.append(("crossed", rnd, rank))
        rec = _group_record(cluster)
        checked.wait()
        assert rec["pending_barriers"] == 0, rec
        return True

    results, errors = _run_ranks(cluster, fn)
    assert not any(errors), errors
    assert all(results)
    for rnd in range(3):
        late = crossings.index(("late", rnd, rnd))
        first_cross = min(i for i, c in enumerate(crossings)
                          if c[0] == "crossed" and c[1] == rnd)
        assert late < first_cross, (
            f"round {rnd}: a rank crossed the barrier before the "
            f"straggler arrived: {crossings}")


def test_rendezvous_actor_slots_drain_unit():
    """Regression for the unbounded `_results`/`_events` growth: after
    every member fetched a key, its slot is deleted."""
    actor = _RendezvousActor(world_size=2)
    for i in range(5):
        key = f"ar:{i}"
        actor.contribute(key, 0, 1.0, "sum")
        actor.contribute(key, 1, 2.0, "sum")
        assert actor.fetch(key, timeout=5) == actor.fetch(key, timeout=5) == 3.0
    assert actor._results == {}
    assert actor._events == {}
    assert actor._fetches == {}
    assert actor._round == {}


# --------------------------------------------------------------------------- #
# Runtime transport (real rank actors) + star path
# --------------------------------------------------------------------------- #


class _RankActor:
    def __init__(self, rank, world, group_name="actors", backend="ring"):
        from ray_tpu_torch.util.collective import init_collective_group

        self.group = init_collective_group(
            world, rank, group_name=group_name, backend=backend)

    def allreduce_value(self, value):
        return self.group.allreduce(value)

    def allreduce_size(self, n_bytes):
        import numpy as _np

        value = _np.full(max(1, n_bytes // 4), float(self.group.rank + 1),
                         dtype=_np.float32)
        self.group.allreduce(value)
        return True


def test_runtime_transport_actors_and_death(cluster):
    """Worker-process ranks over the runtime transport: results match, and
    killing one member's process aborts the peer with the dead rank —
    membership fate-shares with the worker's GCS connection."""
    actor_cls = ray_tpu_torch.remote(_RankActor)
    a0 = actor_cls.options(max_concurrency=2).remote(0, 2)
    a1 = actor_cls.options(max_concurrency=2).remote(1, 2)
    arr = np.arange(CHUNK, dtype=np.float64)  # > inline, exercises the store
    r0 = a0.allreduce_value.remote({"g": arr})
    r1 = a1.allreduce_value.remote({"g": arr * 2})
    out0, out1 = ray_tpu_torch.get([r0, r1], timeout=120)
    np.testing.assert_allclose(np.asarray(out0["g"]), arr * 3)
    np.testing.assert_allclose(np.asarray(out1["g"]), arr * 3)

    pending = a0.allreduce_value.remote({"g": arr})  # a1 never joins this op
    _wait_record(cluster, "actors", lambda rec: _parked(rec) == 1,
                 "had rank 0 parked")
    ray_tpu_torch.kill(a1)
    with pytest.raises(CollectiveError, match="rank 1"):
        ray_tpu_torch.get(pending, timeout=60)
    ray_tpu_torch.kill(a0)


def test_star_attach_validates_world_size(cluster):
    """get_if_exists on a namesake rendezvous actor with a different
    world_size must raise instead of deadlocking every op."""
    group = StarCollectiveGroup("star_ws", 2, 0)
    try:
        with pytest.raises(ValueError, match="world_size=2"):
            StarCollectiveGroup("star_ws", 3, 1)
    finally:
        group.destroy()


class _PerfRankActor:
    """One rank of both planes: the star group and the ring group."""

    def __init__(self, rank, world):
        from ray_tpu_torch.util.collective import init_collective_group

        self.groups = {backend: init_collective_group(
            world, rank, group_name=f"perf_{backend}", backend=backend)
            for backend in ("star", "ring")}

    def allreduce_size(self, backend, n_bytes):
        import numpy as _np

        group = self.groups[backend]
        value = _np.full(max(1, n_bytes // 4), float(group.rank + 1),
                         dtype=_np.float32)
        group.allreduce(value)
        return True

    def destroy(self):
        for group in self.groups.values():
            group.destroy()
        return True


def test_ring_beats_star_under_modeled_links(cluster):
    """The reference's perf story at a sixteenth of its size, both planes
    joined by the same rank actors pinned one per node: under a modeled
    per-host link (`_chunk_serve_bw_bps` serializes each node's chunk
    egress) the star funnels O(W x bytes) through the hub's one link,
    while the ring moves 2(W-1)/W x bytes per link, spread over every
    node. Held, as the reference holds it, on the wall time, and on the
    busiest link's modeled busy time (its bytes over the link's rate).
    The link is a quarter of the reference's 25 MB/s, so that at 4 MiB
    the modeled transfer (about 2.7 s for the star, 1.0 s for the ring)
    still outweighs the ring's extra round trips on a loaded host. Each
    pull takes its object from one source, the object's first holder, so
    each link carries the algorithm's own traffic and no relay the
    transfer plane chose."""
    saved = {k: GLOBAL_CONFIG._overrides.get(k) for k in (
        "object_transfer_chunk_bytes",
        "object_transfer_refetch_location_chunks",
        "object_transfer_max_peers")}
    GLOBAL_CONFIG._overrides.update({
        "object_transfer_chunk_bytes": 2 << 20,
        "object_transfer_refetch_location_chunks": 2,
        "object_transfer_max_peers": 1,
    })
    mb, bw = 4, 25e6 / 4
    # num_cpus=1 on 1-CPU nodes: exactly one rank actor per node.
    ranks = [ray_tpu_torch.remote(_PerfRankActor).options(
        num_cpus=1).remote(r, WORLD) for r in range(WORLD)]

    def measure(backend):
        """(busiest link's busy seconds, wall seconds) of one allreduce."""
        # Warm-up op outside the measured window (connections); payloads
        # are created rank-locally, like real gradients.
        ray_tpu_torch.get([a.allreduce_size.remote(backend, 1024)
                           for a in ranks], timeout=120)
        served = [r._chunk_bytes_served for r in cluster.raylets]
        for raylet in cluster.raylets:
            raylet._chunk_serve_bw_bps = bw
        try:
            t0 = time.perf_counter()
            ray_tpu_torch.get([a.allreduce_size.remote(backend, mb << 20)
                               for a in ranks], timeout=120)
            wall = time.perf_counter() - t0
        finally:
            for raylet in cluster.raylets:
                raylet._chunk_serve_bw_bps = 0.0
        link = max(r._chunk_bytes_served - b
                   for r, b in zip(cluster.raylets, served)) / bw
        return link, wall

    try:
        star_link, star_s = measure("star")
        ring_link, ring_s = measure("ring")
    finally:
        try:
            ray_tpu_torch.get(ranks[0].destroy.remote(), timeout=30)
        finally:
            for a in ranks:
                ray_tpu_torch.kill(a)
            for k, v in saved.items():
                if v is None:
                    GLOBAL_CONFIG._overrides.pop(k, None)
                else:
                    GLOBAL_CONFIG._overrides[k] = v
    msg = (f"ring (busiest link {ring_link:.2f}s, wall {ring_s:.2f}s) "
           f"should beat the star actor (busiest link {star_link:.2f}s, "
           f"wall {star_s:.2f}s) on a {mb} MiB allreduce over "
           f"{bw / 1e6:g} MB/s links")
    assert ring_link < star_link * 0.75, msg
    assert ring_s < star_s * 0.75, msg


# --------------------------------------------------------------------------- #
# The trainer's host collective
# --------------------------------------------------------------------------- #


def _collective_loop(config):
    from ray_tpu_torch.train import session

    rank = session.get_world_rank()
    group = session.get_collective()
    grads = {"w": torch.full((300, 300), float(rank + 1)),
             "b": np.arange(4, dtype=np.float64) * (rank + 1)}
    summed = group.allreduce(grads)
    mean = group.allreduce({"loss": float(rank)}, op="mean")
    group.barrier()
    session.report({"w": float(summed["w"][0, 0]),
                    "w_is_tensor": isinstance(summed["w"], torch.Tensor),
                    "b": summed["b"].tolist(), "loss": float(mean["loss"]),
                    "group": group.name, "world": group.world_size})


def test_trainer_loop_allreduces_through_session_collective(cluster, tmp_path):
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchTrainer,
                                     session)

    result = TorchTrainer(
        _collective_loop, device="cpu",
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     cpus_per_worker=1.0),
        run_config=RunConfig(name="coll", storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    m = result.metrics
    assert m["w"] == 3.0 and m["w_is_tensor"]   # 1 + 2, a tensor again
    assert m["b"] == [0.0, 3.0, 6.0, 9.0]
    assert m["loss"] == 0.5 and m["world"] == 2
    assert m["group"].startswith("train:coll:")
    # The run's workers left the group (finish()), which GC'd its record.
    assert _group_record(cluster, m["group"]) == {"known": False}
    # Outside a WorkerGroup there are no peers.
    with pytest.raises(RuntimeError):
        session.get_collective()
