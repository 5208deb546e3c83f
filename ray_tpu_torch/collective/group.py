"""Host collective plane: ring/tree collectives over the transfer plane.

The port's copy of `ray_tpu/collective/group.py`. Equivalent of the
reference's `python/ray/util/collective` (GroupManager + NCCL/Gloo
communicators) for cross-host exchange through host memory — weight
broadcast to serve replicas, metric reduction, loops without a
torch.distributed group. Collectives between cards run over
torch.distributed (NCCL) instead.

Architecture (the JAX package's docs/COLLECTIVE.md):

- **Control plane**: GCS-registered named groups (epoch + world_size
  validated on attach) and a refcounted mailbox/barrier surface whose
  blocking calls park at the GCS and are failed the moment a member dies
  — every surviving rank raises a rank-attributed ``CollectiveError``
  instead of hanging to an RPC timeout.
- **Data plane**: payloads move as *raw-bytes objects* through the object
  store and the pipelined chunk-transfer plane (windowed multi-source
  pulls, partial-location serving). The mailbox only ever carries object
  ids and small inline values; no tensor byte crosses an actor or the GCS
  above ``collective_inline_max_bytes``.
- **Algorithms**: bandwidth-optimal ring allreduce (reduce-scatter +
  all-gather over flat per-dtype buffers: each rank sends
  ``2(W-1)/W × bytes`` regardless of world size) above
  ``collective_ring_min_bytes``; direct fan-in below it (latency-bound
  regime); broadcast posts ONE object that the transfer plane fans out as
  a tree via partial locations and busy/redirect hints.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.exceptions import (
    CollectiveError,
    GetTimeoutError,
    ObjectLostError,
    RaySystemError,
)

from ray_tpu_torch.collective.buffer import (
    PackedTree,
    REDUCE_UFUNCS,
    tree_index,
)
from ray_tpu_torch.observability import tracing as _tracing

logger = logging.getLogger(__name__)


class RuntimeTransport:
    """Data plane bound to this process's CoreRuntime (drivers/workers):
    raw-bytes puts/gets ride `put_raw`/`get_raw`, membership rides the
    runtime's GCS connection (so the member fate-shares with the
    process)."""

    def __init__(self, runtime=None):
        if runtime is None:
            import ray_tpu_torch

            runtime = ray_tpu_torch._require_runtime()
        self.rt = runtime

    @property
    def gcs(self):
        return self.rt.gcs

    @property
    def node_hex(self) -> Optional[str]:
        nid = getattr(self.rt, "node_id", None)
        return nid.hex() if nid is not None else None

    def put_bytes(self, parts) -> ObjectID:
        return self.rt.put_raw(parts)

    def get_bytes(self, oid: ObjectID, timeout: float) -> memoryview:
        return self.rt.get_raw(oid, timeout)

    def free(self, oids: List[ObjectID]) -> None:
        self.rt.free_raw(oids)

    def release(self, oids: List[ObjectID]) -> None:
        """Drop this process's segment attachments for consumed pulls —
        the raylet unlinks freed segments, but a worker-side mapping left
        open would pin the pages for the process lifetime (thousands of
        training steps = thousands of dead 16 MB mappings)."""
        for oid in oids:
            try:
                self.rt.store.release(oid)
            except Exception:  # noqa: BLE001 — release is best-effort
                pass


class RayletTransport:
    """Data plane bound directly to an in-process Raylet — ranks as
    threads over a simulated multi-node Cluster (tests/bench drive the
    full GCS + transfer-plane path without spawning worker processes)."""

    def __init__(self, raylet):
        self.raylet = raylet

    @property
    def gcs(self):
        return self.raylet.gcs

    @property
    def node_hex(self) -> str:
        return self.raylet.node_id.hex()

    def put_bytes(self, parts) -> ObjectID:
        oid = ObjectID.from_random()
        self.raylet.store.put_serialized(oid, list(parts))
        self.gcs.call("object_location_add",
                      {"object_id": oid, "node_id": self.raylet.node_id,
                       "size": self.raylet.store.local_size(oid)}, timeout=10)
        return oid

    def get_bytes(self, oid: ObjectID, timeout: float) -> memoryview:
        store = self.raylet.store
        buf = store.get_buffer(oid)
        if buf is not None:
            return buf
        entry = self.gcs.call("object_locations_get", {"object_id": oid},
                              timeout=10)
        if not self.raylet._pull_object_pipelined(oid, entry):
            raise ObjectLostError(oid)
        buf = store.get_buffer(oid)
        if buf is None:
            raise ObjectLostError(oid)
        return buf

    def free(self, oids: List[ObjectID]) -> None:
        try:
            self.gcs.call("free_objects", {"object_ids": list(oids)},
                          timeout=10)
        except Exception:  # noqa: BLE001 — cleanup is best-effort
            pass

    def release(self, oids: List[ObjectID]) -> None:
        pass  # raylet-store deletes close their own segment mappings


class CollectiveGroup:
    """One rank's handle on a named host-collective group.

    Ops are bulk-synchronous and must be called in the same order on
    every rank (the per-handle sequence number is the op identity).
    Object lifetime: store objects an op creates are freed at the start
    of the NEXT op — safe because every store-involving op ends with a
    group-internal barrier, so op N's payloads are fully drained before
    any rank reaches op N+1.
    """

    def __init__(self, name: str, world_size: int, rank: int,
                 transport=None, stall_timeout_s: Optional[float] = None):
        self.name = name
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.transport = transport if transport is not None \
            else RuntimeTransport()
        self._stall = float(stall_timeout_s
                            or GLOBAL_CONFIG.collective_stall_timeout_s)
        self._seq = 0
        self._held: List[ObjectID] = []     # store objects of the current op
        self._taken: List[ObjectID] = []    # pulled objects of the current op
        self._broken: Optional[CollectiveError] = None
        resp = self.transport.gcs.call(
            "collective_join",
            {"name": name, "world_size": self.world_size, "rank": self.rank,
             "node_id": self.transport.node_hex}, timeout=30)
        status = resp.get("status")
        if status == "mismatch":
            raise ValueError(
                f"collective group '{name}' already exists with "
                f"world_size={resp['expected']} (epoch {resp['epoch']}); "
                f"attach requested world_size={self.world_size}. Destroy the "
                "group (destroy_collective_group) before re-creating it with "
                "a different size.")
        if status == "rank_taken":
            raise ValueError(f"rank {self.rank} of collective group '{name}' "
                             "is already held by a live member")
        if status == "bad_rank":
            raise ValueError(f"rank {self.rank} out of range for "
                             f"world_size={self.world_size}")
        if status == "dead":
            raise CollectiveError(
                f"collective group '{name}' is broken: "
                + self._fmt_dead(resp.get("dead")),
                resp.get("dead"), name)
        if status != "ok":
            raise RaySystemError(f"collective join failed: {resp}")
        self.epoch = resp["epoch"]

    # ----------------------------------------------------------- internals

    @staticmethod
    def _fmt_dead(dead: Optional[Dict[int, str]]) -> str:
        if not dead:
            return "member(s) died"
        return "dead member(s): " + "; ".join(
            f"rank {r} ({reason})" for r, reason in sorted(dead.items()))

    def _fail(self, err: CollectiveError) -> CollectiveError:
        self._broken = err
        return err

    def _abort_from_state(self, what: str,
                          cause: Optional[Exception] = None) -> CollectiveError:
        """A wait timed out or a payload pull failed: attribute it — dead
        members first, else a stall — and break the group handle."""
        dead: Dict[int, str] = {}
        try:
            info = self.transport.gcs.call("collective_get",
                                           {"name": self.name}, timeout=10)
            if info.get("known") and info.get("epoch") == self.epoch:
                dead = info.get("dead") or {}
        except Exception:  # noqa: BLE001 — GCS unreachable: report the stall
            pass
        if dead:
            msg = (f"collective '{self.name}' {what} aborted on rank "
                   f"{self.rank}: {self._fmt_dead(dead)}")
        else:
            msg = (f"collective '{self.name}' {what} stalled on rank "
                   f"{self.rank} for {self._stall:.0f}s "
                   f"(collective_stall_timeout_s)"
                   + (f": {cause}" if cause is not None else ""))
        return self._fail(CollectiveError(msg, dead, self.name))

    def _check(self, resp: Dict[str, Any], what: str) -> Dict[str, Any]:
        status = resp.get("status")
        if status == "ok":
            return resp
        if status == "dead":
            raise self._fail(CollectiveError(
                f"collective '{self.name}' {what} aborted on rank "
                f"{self.rank}: " + self._fmt_dead(resp.get("dead")),
                resp.get("dead"), self.name))
        if status == "destroyed":
            raise self._fail(CollectiveError(
                f"collective '{self.name}' was destroyed during {what}",
                None, self.name))
        raise self._fail(CollectiveError(
            f"collective '{self.name}' {what} failed: {resp}",
            None, self.name))

    def _op_span(self, name: str, seq: int, **attrs):
        """Span for one collective op on this rank (no-op singleton when
        tracing is off); a stalled/aborted op shows up as an errored span
        with the group/rank/seq attribution."""
        if not _tracing._ENABLED:
            return _tracing.NOOP_SPAN
        # Factory: every caller uses the result as a context manager.
        return _tracing.get_tracer().start_span(  # raylint: disable=RL008
            name, attrs={"group": self.name, "rank": self.rank,
                         "seq": seq, **attrs})

    def _call(self, method: str, data: Dict[str, Any], what: str,
              timeout: float) -> Dict[str, Any]:
        data = {"name": self.name, "epoch": self.epoch, **data}
        try:
            resp = self.transport.gcs.call(method, data, timeout=timeout)
        except TimeoutError as e:
            raise self._abort_from_state(what, e)
        return self._check(resp, what)

    def _begin_op(self) -> int:
        if self._broken is not None:
            raise self._broken
        self._seq += 1
        # The previous op's payloads are fully drained (every
        # store-involving op ends with _sync): drop our attachments for
        # consumed pulls and free the objects we created.
        consumed, self._taken = self._taken, []
        if consumed:
            self.transport.release(consumed)
        done, self._held = self._held, []
        if done:
            self.transport.free(done)
        return self._seq

    def _sync(self, seq: int):
        """Group-internal barrier ending every store-involving op: all
        ranks have drained op `seq`'s payloads once this returns, which is
        what makes the free-on-next-op lifetime rule safe."""
        self._call("collective_barrier",
                   {"seq": f"sync:{seq}", "rank": self.rank},
                   "barrier", self._stall)

    # ------------------------------------------------------------- mailbox

    def _post(self, key: str, parts: List, nbytes: int, consumers: int):
        """Hand `parts` to `consumers` takers: tiny payloads inline in the
        mailbox, everything else as a raw object pulled over the transfer
        plane (the mailbox then carries 20-odd bytes of object id)."""
        if nbytes <= GLOBAL_CONFIG.collective_inline_max_bytes:
            value = {"k": "i", "v": b"".join(bytes(p) for p in parts)}
        else:
            oid = self.transport.put_bytes(parts)
            self._held.append(oid)
            value = {"k": "o", "v": oid.binary()}
        self._call("collective_post",
                   {"key": key, "value": value, "consumers": consumers},
                   f"post {key}", self._stall)

    def _take(self, key: str) -> memoryview:
        resp = self._call("collective_take", {"key": key}, f"take {key}",
                          self._stall)
        value = resp["value"]
        if value["k"] == "i":
            return memoryview(value["v"])
        oid = ObjectID(value["v"])
        try:
            view = self.transport.get_bytes(oid, self._stall)
        except (GetTimeoutError, ObjectLostError, RaySystemError) as e:
            raise self._abort_from_state(f"pull of {key}", e)
        self._taken.append(oid)
        return view

    def _post_value(self, key: str, value: Any, consumers: int):
        blob = serialization.dumps_ctrl(value)
        self._post(key, [blob], len(blob), consumers)

    def _take_value(self, key: str) -> Any:
        return serialization.loads(bytes(self._take(key)))

    # ------------------------------------------------- point-to-point

    # P2P rides the same mailbox as the collectives but OUTSIDE the
    # bulk-synchronous op sequence: each (src, dst, tag) channel numbers
    # its own messages, so a pipeline stage pair can stream activations
    # while the group's collectives (barrier at a checkpoint, a grad
    # allreduce) interleave freely — the key namespaces never collide.
    # Object lifetime cannot ride the free-on-next-op rule (there is no
    # group barrier between p2p messages): object-path sends stay held
    # until the receiver's windowed drain ack
    # (collective_p2p_ack_window), inline sends hold nothing.

    def _p2p_state(self):
        if not hasattr(self, "_p2p_lock"):
            self._p2p_lock = threading.Lock()
            self._p2p_cv = threading.Condition(self._p2p_lock)
            self._p2p_send_seq: Dict[tuple, int] = {}
            self._p2p_recv_seq: Dict[tuple, int] = {}
            # (dst, tag) -> next seq allowed to POST on the channel
            self._p2p_post_turn: Dict[tuple, int] = {}
            # (dst, tag) -> [(seq, oid)] object-path sends not yet acked
            self._p2p_pending: Dict[tuple, List] = {}

    def _p2p_reserve(self, dst: int, tag: str) -> int:
        """Claim the next seq on the (self, dst, tag) channel. Done in
        the CALLER's thread (send and isend both) so message order on a
        channel is the order of the send calls, never the scheduling of
        isend's background threads."""
        if self._broken is not None:
            raise self._broken
        if not 0 <= dst < self.world_size or dst == self.rank:
            raise ValueError(f"bad p2p destination {dst} "
                             f"(rank {self.rank} of {self.world_size})")
        self._p2p_state()
        chan = (dst, tag)
        with self._p2p_lock:
            self._p2p_send_seq[chan] = seq = \
                self._p2p_send_seq.get(chan, 0) + 1
        return seq

    def send(self, value: Any, dst: int, tag: str = "p2p") -> None:
        """Post one message to `dst` on channel `tag` (any picklable
        pytree). Returns once the payload is visible to the receiver;
        blocks only when the per-peer ack window is full (receiver more
        than `collective_p2p_ack_window` object-path messages behind)."""
        self._send_seq(value, dst, tag, self._p2p_reserve(dst, tag))

    def _send_seq(self, value: Any, dst: int, tag: str, seq: int) -> None:
        chan = (dst, tag)
        window = max(1, GLOBAL_CONFIG.collective_p2p_ack_window)
        key = f"p2p:{self.rank}>{dst}:{tag}:{seq}"
        # Serialize + store-write FIRST, unordered: this is the bulk of
        # an isend and overlaps fine across racing background threads.
        blob = serialization.dumps_ctrl(value)
        oid = None
        if len(blob) <= GLOBAL_CONFIG.collective_inline_max_bytes:
            payload = {"k": "i", "v": bytes(blob)}
        else:
            oid = self.transport.put_bytes([blob])
            payload = {"k": "o", "v": oid.binary()}
        # POSTS must leave in seq order. Not for delivery (the receiver
        # takes by seq key) but for the ack window: if seq k posts while
        # seq k-1 is still parked in the window drain below, a thread
        # can block on the drain ack of a LATER message than the
        # receiver — who drains strictly in order — can ever reach, and
        # the channel deadlocks (isend threads race; seen in tests).
        deadline = time.monotonic() + self._stall
        with self._p2p_cv:
            while self._p2p_post_turn.get(chan, 1) != seq:
                if not self._p2p_cv.wait(deadline - time.monotonic()):
                    raise self._abort_from_state(
                        f"isend turn {key}",
                        TimeoutError(f"post turn for seq {seq} never came "
                                     f"(channel head still "
                                     f"{self._p2p_post_turn.get(chan, 1)})"))
        try:
            # Window drain: free the oldest in-flight payload once the
            # receiver acks having drained it. The blocking ack take
            # runs OUTSIDE the p2p lock — a stage thread parked here
            # must not wedge the same handle's recv of the opposite-
            # direction channel (1F1B sends activations forward while
            # grads stream back).
            while True:
                with self._p2p_lock:
                    pending = self._p2p_pending.setdefault(chan, [])
                    if len(pending) < window:
                        if oid is not None:
                            pending.append((seq, oid))
                        break
                    old_seq, old_oid = pending.pop(0)
                self._take(f"p2pa:{self.rank}>{dst}:{tag}:{old_seq}")
                self.transport.free([old_oid])
            with self._op_span("collective.send", seq, dst=dst, tag=tag,
                               nbytes=len(blob)):
                self._call("collective_post",
                           {"key": key, "value": payload, "consumers": 1},
                           f"send {key}", self._stall)
        finally:
            # Always hand the turn on — a failed post must not hang the
            # channel's later sends on the condition (they surface their
            # own errors against the now-broken group).
            with self._p2p_cv:
                self._p2p_post_turn[chan] = seq + 1
                self._p2p_cv.notify_all()

    def isend(self, value: Any, dst: int, tag: str = "p2p"):
        """`send` posted on a background thread so the store write + GCS
        round trip overlap the caller's compute (the 1F1B steady state
        posts each stage boundary while the next microbatch runs). The
        channel seq is reserved HERE, in the caller — two isends on one
        channel deliver in call order even when their threads race.
        Returns a handle; `.wait()` joins and re-raises any send error."""
        seq = self._p2p_reserve(dst, tag)
        err: List[BaseException] = []

        def run():
            try:
                self._send_seq(value, dst, tag, seq)
            except BaseException as e:  # noqa: BLE001 — re-raised in wait
                err.append(e)

        thread = threading.Thread(target=run, daemon=True)
        thread.start()

        class _Handle:
            def wait(self, timeout: Optional[float] = None):
                thread.join(timeout)
                if err:
                    raise err[0]
                if thread.is_alive():
                    raise TimeoutError(f"isend to {dst} still in flight")

        return _Handle()

    def recv(self, src: int, tag: str = "p2p") -> Any:
        """Take the next message from `src` on channel `tag` (blocking,
        `collective_stall_timeout_s` abort horizon). Messages on one
        channel arrive in send order; object payloads are drained and
        acked so the sender's window can advance."""
        if self._broken is not None:
            raise self._broken
        if not 0 <= src < self.world_size or src == self.rank:
            raise ValueError(f"bad p2p source {src} "
                             f"(rank {self.rank} of {self.world_size})")
        self._p2p_state()
        chan = (src, tag)
        with self._p2p_lock:
            self._p2p_recv_seq[chan] = seq = \
                self._p2p_recv_seq.get(chan, 0) + 1
        key = f"p2p:{src}>{self.rank}:{tag}:{seq}"
        with self._op_span("collective.recv", seq, src=src, tag=tag):
            resp = self._call("collective_take", {"key": key},
                              f"recv {key}", self._stall)
            value = resp["value"]
            if value["k"] == "i":
                return serialization.loads(bytes(value["v"]))
            oid = ObjectID(value["v"])
            try:
                view = self.transport.get_bytes(oid, self._stall)
            except (GetTimeoutError, ObjectLostError, RaySystemError) as e:
                raise self._abort_from_state(f"pull of {key}", e)
            out = serialization.loads(bytes(view))
            self.transport.release([oid])
            # Drain ack: the sender frees this payload and advances its
            # window once it takes this.
            self._call("collective_post",
                       {"key": f"p2pa:{src}>{self.rank}:{tag}:{seq}",
                        "value": {"k": "i", "v": b"1"}, "consumers": 1},
                       f"ack {key}", self._stall)
            return out

    def _release_p2p(self):
        if not hasattr(self, "_p2p_lock"):
            return
        with self._p2p_lock:
            pending = [oid for chan in self._p2p_pending.values()
                       for _, oid in chan]
            self._p2p_pending.clear()
        if pending:
            try:
                self.transport.free(pending)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass

    # ------------------------------------------------------------- the ops

    def allreduce(self, value: Any, op: str = "sum") -> Any:
        """Elementwise reduction of a pytree across all ranks. `op` in
        sum|product|min|max|mean (mean divides the sum by world_size)."""
        mean = op == "mean"
        ufunc = REDUCE_UFUNCS["sum" if mean else op]  # KeyError: bad op
        seq = self._begin_op()
        packed = PackedTree(value, self.world_size)
        if self.world_size == 1:
            return packed.unpack()
        with self._op_span("collective.allreduce", seq,
                           nbytes=packed.total_bytes, op=op):
            if packed.total_bytes < GLOBAL_CONFIG.collective_ring_min_bytes:
                self._allreduce_fanin(seq, packed, ufunc)
            else:
                self._allreduce_ring(seq, packed, ufunc)
            # Every allreduce ends with the fence — including the
            # all-inline fan-in: ops are bulk-synchronous by contract, and
            # a rank that returned (and may destroy()/leave()) while a
            # peer's take is still parked would abort that peer mid-op.
            self._sync(seq)
        return packed.unpack(mean_divisor=self.world_size if mean else None)

    def _allreduce_fanin(self, seq: int, packed: PackedTree, ufunc):
        """Small-payload path: every rank publishes its whole (packed)
        buffer and reduces the other W-1 — one mailbox round instead of
        2(W-1) dependent ring steps."""
        self._post(f"{seq}:fi:{self.rank}", packed.whole_parts(),
                   packed.total_bytes, consumers=self.world_size - 1)
        for peer in range(self.world_size):
            if peer != self.rank:
                packed.reduce_whole(self._take(f"{seq}:fi:{peer}"), ufunc)

    def _allreduce_ring(self, seq: int, packed: PackedTree, ufunc):
        """Bandwidth-optimal reduce-scatter ring + object all-gather.

        Reduce-scatter runs as the classic W-1 ring steps (each rank
        accumulates one segment from its predecessor — inherently
        sequential, the reduction chains). The all-gather half does NOT
        relay hop by hop: a fully-reduced segment is an immutable sealed
        object, so each rank posts its segment ONCE (consumers=W-1) and
        pulls the other W-1 directly — the transfer plane stripes and
        tree-forms those concurrent pulls (partial locations, redirect
        hints), one wave of latency instead of W-1, and the send side
        serves every peer zero-copy from the same store segment. Per-rank
        traffic stays 2(W-1)/W of the payload."""
        world, rank = self.world_size, self.rank
        pred = (rank - 1) % world
        post_err: List[BaseException] = []

        def _post_bg(key, parts, nbytes, consumers) -> threading.Thread:
            # My post feeds my SUCCESSOR; my own take doesn't depend on it
            # — so the post's store write + GCS round trip overlaps the
            # predecessor wait instead of preceding it.
            def run():
                try:
                    self._post(key, parts, nbytes, consumers)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    post_err.append(e)

            thread = threading.Thread(target=run, daemon=True)
            thread.start()
            return thread

        pending: Optional[threading.Thread] = None
        for t in range(world - 1):
            send_seg = (rank - t) % world
            pending = _post_bg(f"{seq}:rs:{t}:{rank}",
                               packed.segment_parts(send_seg),
                               packed.segment_nbytes, consumers=1)
            packed.reduce_segment((rank - t - 1) % world,
                                  self._take(f"{seq}:rs:{t}:{pred}"), ufunc)
            pending.join()  # wave t+1's post content depends on this reduce
            if post_err:
                raise post_err[0]
        # Rank r now owns fully-reduced segment (r+1) % world: publish it
        # once and pull the other W-1 concurrently, in a rotated order so
        # at each step the W pullers hit W distinct source nodes.
        self._post(f"{seq}:seg:{rank}",
                   packed.segment_parts((rank + 1) % world),
                   packed.segment_nbytes, consumers=world - 1)
        peers = [(rank + off) % world for off in range(1, world)]
        errs: List[BaseException] = []

        def fetch_peer(peer: int):
            try:
                packed.set_segment((peer + 1) % world,
                                   self._take(f"{seq}:seg:{peer}"))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errs.append(e)

        threads = [threading.Thread(target=fetch_peer, args=(p,), daemon=True)
                   for p in peers[1:]]
        for thread in threads:
            thread.start()
        fetch_peer(peers[0])
        for thread in threads:
            thread.join()
        if errs:
            raise errs[0]

    def allgather(self, value: Any) -> List[Any]:
        seq = self._begin_op()
        if self.world_size == 1:
            return [value]
        with self._op_span("collective.allgather", seq):
            self._post_value(f"{seq}:ag:{self.rank}", value,
                             consumers=self.world_size - 1)
            out = [value if peer == self.rank
                   else self._take_value(f"{seq}:ag:{peer}")
                   for peer in range(self.world_size)]
            self._sync(seq)
        return out

    def broadcast(self, value: Any, src_rank: int = 0) -> Any:
        """Root posts ONE object; the transfer plane fans it out as a tree
        (partial-location serving + busy/redirect hints), so the root's
        NIC is not the bottleneck at any world size."""
        seq = self._begin_op()
        if self.world_size == 1:
            return value
        with self._op_span("collective.broadcast", seq, src=src_rank):
            if self.rank == src_rank:
                self._post_value(f"{seq}:bc", value,
                                 consumers=self.world_size - 1)
                out = value
            else:
                out = self._take_value(f"{seq}:bc")
            self._sync(seq)
        return out

    def reducescatter(self, value: Any, op: str = "sum") -> Any:
        """Reduce across ranks, then row-slice every leaf so rank r keeps
        rows [r·n/W, (r+1)·n/W) — the legacy API contract. Leading
        dimensions must divide world_size (ValueError otherwise, raised
        BEFORE any communication so one rank's bad shape cannot strand its
        peers mid-op)."""
        tree_index(value, self.rank, self.world_size)  # validate shapes
        return tree_index(self.allreduce(value, op), self.rank,
                          self.world_size)

    def barrier(self) -> None:
        seq = self._begin_op()
        with self._op_span("collective.barrier", seq):
            self._call("collective_barrier",
                       {"seq": f"user:{seq}", "rank": self.rank},
                       "barrier", self._stall)

    # ------------------------------------------------------------ teardown

    def leave(self) -> None:
        """Graceful departure: peers draining their last op are not
        aborted (unlike a member death)."""
        self._release_objects()
        try:
            self.transport.gcs.call(
                "collective_leave",
                {"name": self.name, "epoch": self.epoch, "rank": self.rank},
                timeout=10)
        except Exception:  # noqa: BLE001 — the disconnect path cleans up
            pass

    def destroy(self) -> None:
        """Tear the whole group down; parked peers get CollectiveError.
        Scoped to this handle's epoch: a straggling destroy can never kill
        a newer incarnation of the name."""
        self._release_objects()
        try:
            self.transport.gcs.call("collective_destroy",
                                    {"name": self.name, "epoch": self.epoch},
                                    timeout=10)
        except Exception:  # noqa: BLE001
            pass

    def _release_objects(self):
        self._release_p2p()
        taken, self._taken = self._taken, []
        if taken:
            self.transport.release(taken)
        oids, self._held = self._held, []
        if oids:
            try:
                self.transport.free(oids)
            except Exception:  # noqa: BLE001
                pass
