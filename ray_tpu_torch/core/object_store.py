"""Per-node shared-memory object store (plasma equivalent).

The reference runs a plasma store inside each raylet: an mmap'd shared-memory
arena with create/seal/get, LRU eviction, and disk spilling
(`src/ray/object_manager/plasma/*`, `store_runner.h:56`,
`object_lifecycle_manager.h`, `eviction_policy.h`). Here each sealed object
lives in its own POSIX shm segment (`/dev/shm`), named by object id, giving
zero-copy cross-process reads via pickle-5 out-of-band buffers. Small objects
bypass shm and travel inline through the control plane (the reference's
in-process memory store, `store_provider/memory_store/memory_store.h:43`).

GPU note: device tensors never transit this store — only host-RAM data
(batches, checkpoint metadata, numpy). CUDA tensors are moved to the host
before put; `get` returns numpy views that torch can copy to the card.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.exceptions import RaySystemError

logger = logging.getLogger(__name__)


# The store owns segment lifetimes (delete() unlinks; shutdown sweeps).
# Python's resource_tracker assumes one register/unregister pair per name per
# process; our create/attach/adopt patterns break that (its cache is a set),
# producing daemon-side KeyErrors. Exclude rtpu segments from tracking.
_orig_register = resource_tracker.register
_orig_unregister = resource_tracker.unregister


def _filtered_register(name, rtype):
    if rtype == "shared_memory" and "rtt_" in name:
        return
    _orig_register(name, rtype)


def _filtered_unregister(name, rtype):
    if rtype == "shared_memory" and "rtt_" in name:
        return
    _orig_unregister(name, rtype)


resource_tracker.register = _filtered_register
resource_tracker.unregister = _filtered_unregister


class _AttachedSharedMemory(shared_memory.SharedMemory):
    """Reader-side attachment whose close() tolerates live zero-copy views.

    Values deserialized zero-copy (numpy arrays aliasing shm pages) may
    outlive the client; closing the mmap then raises BufferError. Readers may
    safely leave the mapping open — the kernel reclaims it at process exit.
    """

    def close(self):
        try:
            super().close()
        except BufferError:
            pass


def _untrack(shm: shared_memory.SharedMemory):
    """Detach this handle from the resource tracker: the creating store owns
    the segment's lifetime; attaching processes must not unlink it at exit."""
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:  # noqa: BLE001 — CPython-internal API; shape varies
        logger.debug("resource_tracker detach failed", exc_info=True)


def _segment_name(session_suffix: str, object_id: ObjectID) -> str:
    # Full 28-byte id in the name keeps segments collision-free per session.
    return f"rtt_{session_suffix}_{object_id.hex()}"


# --- staging: a segment is only attachable by name once it is COMPLETE ------
#
# ObjectStoreClient readers attach segments by name with no seal check (a
# same-node read must not round-trip through the raylet), so the name
# itself must be the seal: writers (puts, raylet pulls, spill restores)
# create the segment under a staging name, fill it, and atomically rename
# it to the final name (os.rename inside /dev/shm — invisible to existing
# mappings, the SegmentPool's own trick). Before this, a driver polling
# its store mid-pull could attach the raylet's half-filled buffer and
# deserialize torn bytes — the lineage-reconstruction-under-node-death
# chaos storm hit exactly that window.

_SHM_DIR = "/dev/shm"
_STAGING = os.path.isdir(_SHM_DIR)


def _staging_name(session_suffix: str, object_id: ObjectID) -> str:
    return _segment_name(session_suffix, object_id) + "_stg"


def _writer_name(session_suffix: str, object_id: ObjectID) -> str:
    """The name a writer creates a fresh segment under (staging when the
    platform supports the rename publish, final otherwise)."""
    if _STAGING:
        return _staging_name(session_suffix, object_id)
    return _segment_name(session_suffix, object_id)


def _rename_segment(shm: shared_memory.SharedMemory, new_name: str):
    """Rename a live segment's backing file and patch the handle so later
    close()/unlink() target the new name. Mappings are unaffected."""
    os.rename(os.path.join(_SHM_DIR, shm.name),
              os.path.join(_SHM_DIR, new_name))
    # SharedMemory tracks a leading slash on POSIX; keep its convention.
    shm._name = ("/" + new_name) if shm._name.startswith("/") \
        else new_name  # type: ignore[attr-defined]


def _promote_segment(shm: shared_memory.SharedMemory, final_name: str):
    """Publish a fully-written staged segment under its final name."""
    if _STAGING and shm.name != final_name:
        _rename_segment(shm, final_name)


def _swallow(fn, *args):
    try:
        fn(*args)
    except Exception:  # noqa: BLE001 — background cleanup only
        pass


class SegmentPool:
    """Warm shm segments recycled across an owner's puts.

    A fresh tmpfs segment pays a page fault + page zeroing per 4 KiB on
    first touch, capping cold put bandwidth 3-5x below memcpy; the
    reference sidesteps this by carving objects out of plasma's one big
    pre-faulted arena (`src/ray/object_manager/plasma/store_runner.h:56`).
    The equivalent here keeps per-object segments (same-node
    readers attach them by name, zero-copy) but recycles the *files*:
    when the owner's last reference drops, the segment is renamed back to
    a pool name — `os.rename` inside /dev/shm is atomic and invisible to
    existing mappings — re-attached and pre-faulted OFF the put path, so
    the next same-size put writes through a warm mapping at memcpy speed.

    Safety: a segment is reclaimed only after the global refcount hits
    zero AND this process holds no buffer exports on it (the caller's
    `can_reuse` probe). As with plasma, zero-copy views that outlive
    their ObjectRef are undefined.
    """

    # Below this size pooling is not worth the per-free directory round
    # trip it forces (small puts stay on the batched free path).
    MIN_SEGMENT_BYTES = 1024 * 1024

    def __init__(self, session_suffix: str, max_bytes: int):
        self._session = session_suffix
        self._max = max_bytes
        self._enabled = max_bytes > 0 and os.path.isdir("/dev/shm")
        # size -> stack of (attached, pre-faulted) segments of exactly size.
        self._free: Dict[int, List[shared_memory.SharedMemory]] = {}
        self._bytes = 0
        # oid bytes -> size: live pool-capable puts (reclaim candidates).
        self._tracked: Dict[bytes, int] = {}
        self._seq = 0
        self._lock = threading.Lock()
        # Attach+prefault of reclaimed segments runs here, off the
        # caller's (free/destructor) path — touching every page of a big
        # segment on the thread dropping a ref would stall it.
        self._warmer: Optional[Any] = None

    @property
    def enabled(self) -> bool:
        return self._enabled

    def acquire(self, object_id: ObjectID, size: int
                ) -> Optional[shared_memory.SharedMemory]:
        """Claim a warm segment for `object_id`: renames the pooled file
        to the object's STAGING name (it still holds the previous
        object's stale bytes — publishing it under the final name before
        the copy would let a same-node reader attach and deserialize the
        wrong object) and returns the (still warm) mapping; the writer
        promotes it to the final name after the copy. None when no
        exact-size segment is pooled."""
        if not self._enabled:
            return None
        with self._lock:
            lst = self._free.get(size)
            if not lst:
                return None
            shm = lst.pop()
            self._bytes -= size
        try:
            _rename_segment(shm, _writer_name(self._session, object_id))
        except OSError:
            _swallow(shm.close)
            return None
        return shm

    def track(self, object_id: ObjectID, size: int):
        """Record a live put whose segment may be reclaimed on free."""
        if self._enabled and size >= self.MIN_SEGMENT_BYTES:
            with self._lock:
                self._tracked[object_id.binary()] = size

    def is_tracked(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id.binary() in self._tracked

    def forget(self, object_id: ObjectID):
        with self._lock:
            self._tracked.pop(object_id.binary(), None)

    def reclaim(self, object_id: ObjectID, can_reuse) -> bool:
        """Object freed everywhere: pull its segment back into the pool.
        `can_reuse()` must confirm this process holds no live exports on
        it. Only the rename runs on the caller; the attach + pre-fault
        (touches every page) happen on the pool's warmer thread so a ref
        drop never stalls on segment-sized page walks."""
        with self._lock:
            size = self._tracked.pop(object_id.binary(), None)
            full = self._bytes + (size or 0) > self._max
        if size is None or full or not can_reuse():
            return False
        obj_name = _segment_name(self._session, object_id)
        with self._lock:
            self._seq += 1
            pool_name = f"rtt_{self._session}_pool{os.getpid()}_{self._seq}"
        try:
            os.rename("/dev/shm/" + obj_name, "/dev/shm/" + pool_name)
        except OSError:
            return False  # store already unlinked it (benign race)
        with self._lock:
            self._bytes += size  # reserve against the cap now
        self._warm_async(pool_name, size)
        return True

    def _warm_async(self, pool_name: str, size: int):
        if self._warmer is None:
            from concurrent.futures import ThreadPoolExecutor

            with self._lock:
                if self._warmer is None:
                    self._warmer = ThreadPoolExecutor(
                        1, thread_name_prefix="segment-pool-warm")
        self._warmer.submit(self._warm_one, pool_name, size)

    def _warm_one(self, pool_name: str, size: int):
        try:
            shm = shared_memory.SharedMemory(name=pool_name)
            _untrack(shm)
        except OSError:
            with self._lock:
                self._bytes -= size
            _swallow(os.unlink, "/dev/shm/" + pool_name)
            return
        try:
            self._prefault(shm, size)
        except Exception:  # noqa: BLE001 — warmth is best-effort
            pass
        with self._lock:
            self._free.setdefault(size, []).append(shm)

    @staticmethod
    def _prefault(shm: shared_memory.SharedMemory, size: int):
        import numpy as np  # deferred: keeps worker cold-start numpy-free

        from ray_tpu_torch._native import get_lib

        lib = get_lib()
        if lib is not None:
            import ctypes

            addr = np.frombuffer(shm.buf, dtype=np.uint8).ctypes.data
            lib.rtpu_prefault(ctypes.cast(addr, ctypes.c_char_p), size)
        else:
            # One touch per page maps the existing tmpfs pages (minor
            # faults) so the put-path copy never faults.
            view = np.frombuffer(shm.buf, dtype=np.uint8)
            view[::4096] = view[::4096]

    def close(self):
        warmer = self._warmer
        if warmer is not None:
            warmer.shutdown(wait=True)
            self._warmer = None
        with self._lock:
            segs = [s for lst in self._free.values() for s in lst]
            self._free.clear()
            self._tracked.clear()
            self._bytes = 0
        for shm in segs:
            _swallow(shm.close)
            _swallow(shm.unlink)


@dataclass
class _LocalObject:
    object_id: ObjectID
    size: int
    sealed: bool = False
    shm: Optional[shared_memory.SharedMemory] = None
    spilled_path: Optional[str] = None
    pin_count: int = 0
    last_access: float = field(default_factory=time.monotonic)
    # Cloud spill in flight: bytes held until the background upload lands
    # (restores read from here without a network round trip; keeps the
    # store lock free of WAN latency).
    pending_spill: Optional[bytes] = None
    # Cloud restore in flight: set by the thread that owns the WAN download
    # (performed OFF-lock, mirroring the spill side); other readers wait on
    # it instead of stacking duplicate downloads.
    restoring: Optional[threading.Event] = None


class ObjectStoreFullError(RaySystemError):
    pass


class SharedMemoryStore:
    """Create/seal/get over per-object shm segments with LRU spill-to-disk.

    One instance runs inside each raylet process; clients (workers/driver on
    the same node) use `ObjectStoreClient` which attaches segments by name —
    reads never involve the raylet once the location is known.
    """

    def __init__(self, session_suffix: str, capacity_bytes: int = 0, spill_dir: str | None = None):
        self._session = session_suffix
        if capacity_bytes <= 0:
            capacity_bytes = GLOBAL_CONFIG.object_store_memory_bytes
        if capacity_bytes <= 0:
            try:
                import psutil

                capacity_bytes = int(psutil.virtual_memory().total * 0.3)
            except Exception:  # noqa: BLE001 — capacity probe is best-effort
                logger.debug("psutil capacity probe failed; defaulting to "
                             "2 GiB", exc_info=True)
                capacity_bytes = 2 << 30
        self.capacity = capacity_bytes
        self._spill_dir = spill_dir or GLOBAL_CONFIG.object_spill_dir or \
            os.path.join(tempfile.gettempdir(), "ray_tpu_torch_spill")
        self._lock = threading.RLock()
        self._objects: "OrderedDict[ObjectID, _LocalObject]" = OrderedDict()
        self._used = 0

    # -- creation ------------------------------------------------------------

    def create(self, object_id: ObjectID, size: int) -> memoryview:
        with self._lock:
            if object_id in self._objects:
                raise RaySystemError(f"Object {object_id} already exists in store")
            self._ensure_capacity(size)
            try:
                # Created under the STAGING name: same-node clients attach
                # by the final name, which only exists once seal() renames
                # the complete segment into place — an in-progress pull's
                # buffer is invisible to them.
                shm = shared_memory.SharedMemory(
                    name=_writer_name(self._session, object_id),
                    create=True, size=max(size, 1)
                )
            except FileExistsError:
                raise RaySystemError(f"shm segment for {object_id} already exists")
            entry = _LocalObject(object_id, size, sealed=False, shm=shm)
            self._objects[object_id] = entry
            self._used += size
            return shm.buf[:size]

    def adopt(self, object_id: ObjectID, size: int):
        """Track a segment created and sealed by another local process
        (driver/worker `put`) or hardlinked in by the raylet's same-host
        attach: attach it and account for its memory. Capacity is
        ensured BEFORE attaching so a full store never leaks the
        mapping."""
        with self._lock:
            if object_id in self._objects:
                return
            self._ensure_capacity(size)
            # Attach registers with the resource tracker (3.12 behavior); the
            # eventual unlink() in delete() unregisters — keep them balanced.
            shm = shared_memory.SharedMemory(name=_segment_name(self._session, object_id))
            self._objects[object_id] = _LocalObject(object_id, size, sealed=True, shm=shm)
            self._used += size

    def seal(self, object_id: ObjectID):
        with self._lock:
            entry = self._objects.get(object_id)
            if entry is None:
                raise RaySystemError(f"seal of unknown object {object_id}")
            if not entry.sealed and entry.shm is not None:
                # Atomic publish: the final name appears only now, with
                # the bytes complete (see the staging block above).
                _promote_segment(entry.shm,
                                 _segment_name(self._session, object_id))
            entry.sealed = True

    def put_serialized(self, object_id: ObjectID, parts: List[memoryview | bytes]) -> int:
        from ray_tpu_torch._native import gather_copy

        total = serialization.serialized_size(parts)
        buf = self.create(object_id, total)
        # Native memcpy gather (GIL released); numpy-view fallback.
        gather_copy(buf, parts)
        self.seal(object_id)
        return total

    def put_value(self, object_id: ObjectID, value: Any) -> int:
        return self.put_serialized(object_id, serialization.serialize(value))

    # -- reads ---------------------------------------------------------------

    def get_buffer(self, object_id: ObjectID) -> Optional[memoryview]:
        while True:
            wait_ev = None
            fetch_key = None
            with self._lock:
                entry = self._objects.get(object_id)
                if entry is None or not entry.sealed:
                    return None
                entry.last_access = time.monotonic()
                self._objects.move_to_end(object_id)
                if entry.shm is not None:
                    return entry.shm.buf[: entry.size]
                if entry.spilled_path is None:
                    return None
                needs_wan = (entry.pending_spill is None
                             and entry.spilled_path.startswith(self._URI_MARK))
                if not needs_wan:
                    return self._restore(entry)
                # Cloud restore: the download must NOT run under the store
                # lock (it would stall every store op on the node for the
                # WAN round trip — the spill side moves uploads off-lock for
                # the same reason). First reader claims the fetch; others
                # park on the event and re-check.
                if entry.restoring is not None:
                    wait_ev = entry.restoring
                else:
                    entry.restoring = threading.Event()
                    fetch_key = entry.spilled_path[len(self._URI_MARK):]
            if wait_ev is not None:
                wait_ev.wait(timeout=60)
                continue
            data = None
            try:
                backend, _ = self._cloud_spill_backend()
                data = backend.get(fetch_key)
            finally:
                with self._lock:
                    ev, entry.restoring = entry.restoring, None
                    if ev is not None:
                        ev.set()
                    if data is not None:
                        cur = self._objects.get(object_id)
                        if (cur is entry and entry.spilled_path ==
                                self._URI_MARK + fetch_key):
                            # Stage the bytes so _restore's fast path (and
                            # any parked readers) use them; a concurrent
                            # delete already unlinked the bucket object —
                            # then the bytes are simply dropped.
                            entry.pending_spill = data

    def get_bytes(self, object_id: ObjectID) -> Optional[bytes]:
        buf = self.get_buffer(object_id)
        return bytes(buf) if buf is not None else None

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            e = self._objects.get(object_id)
            return e is not None and e.sealed

    def local_size(self, object_id: ObjectID) -> int:
        """Sealed local object's byte size (0 when absent) — feeds the
        scheduler's data-locality scoring without a GCS round trip."""
        with self._lock:
            e = self._objects.get(object_id)
            return e.size if e is not None and e.sealed else 0

    def pin(self, object_id: ObjectID):
        with self._lock:
            e = self._objects.get(object_id)
            if e:
                e.pin_count += 1

    def unpin(self, object_id: ObjectID):
        with self._lock:
            e = self._objects.get(object_id)
            if e and e.pin_count > 0:
                e.pin_count -= 1

    # -- deletion / eviction / spilling -------------------------------------

    def delete(self, object_id: ObjectID, skip_unlink: bool = False):
        """skip_unlink: the owner will recycle the segment file into its
        SegmentPool (it renames it away); only drop our mapping."""
        with self._lock:
            entry = self._objects.pop(object_id, None)
            if entry is None:
                return
            self._used -= entry.size
            if entry.shm is not None:
                # Close and unlink independently: close() raises BufferError
                # while zero-copy exports of the segment are still alive
                # (e.g. a chunk send draining), but the NAME must still be
                # unlinked — a leaked name would make any later create()
                # of the same object fail forever with FileExistsError.
                try:
                    entry.shm.close()
                except (BufferError, OSError):
                    pass  # exports still draining; unlink below regardless
                if not skip_unlink:
                    try:
                        entry.shm.unlink()
                    except OSError:
                        pass  # already unlinked (racing delete)
            if entry.spilled_path:
                path, entry.spilled_path = entry.spilled_path, None
                entry.pending_spill = None  # uploader sees the tombstone
                try:
                    self._unlink_spilled(path)
                except Exception:  # noqa: BLE001
                    pass

    def _ensure_capacity(self, size: int):
        if size > self.capacity:
            raise ObjectStoreFullError(
                f"Object of {size} bytes exceeds store capacity {self.capacity}"
            )
        # LRU spill of sealed, unpinned objects until the new object fits.
        while self._used + size > self.capacity:
            victim = None
            for oid, e in self._objects.items():
                if e.sealed and e.pin_count == 0 and e.shm is not None:
                    victim = e
                    break
            if victim is None:
                raise ObjectStoreFullError(
                    f"Store full ({self._used}/{self.capacity} bytes) and no spillable objects"
                )
            self._spill(victim)

    _URI_MARK = "uri:"

    def _cloud_spill_backend(self):
        """(backend, key_prefix) when spill_dir is a bucket URI — on cloud
        VMs local disk dies with the VM, so spilled objects can target
        gs:///s3:// through the storage seam (reference
        external_storage.py:445 ExternalStorageSmartOpenImpl)."""
        from ray_tpu_torch.train import storage

        if not storage.is_cloud_uri(self._spill_dir):
            return None
        return storage.get_backend(self._spill_dir)

    def _spill(self, entry: _LocalObject):
        # NOTE: never bind entry.shm.buf slices to a local — a live
        # exported view makes shm.close() raise BufferError.
        cloud = self._cloud_spill_backend()
        if cloud is not None:
            # Only the memcpy happens under the store lock; the WAN upload
            # runs on a background thread (a multi-MB put over the network
            # under self._lock would stall every store operation on the
            # node). Until it lands, restores serve from pending_spill.
            backend, prefix = cloud
            key = (f"{prefix.rstrip('/')}/" if prefix else "") + \
                f"{self._session}_{entry.object_id.hex()}"
            entry.pending_spill = bytes(entry.shm.buf[: entry.size])
            entry.spilled_path = self._URI_MARK + key
            threading.Thread(target=self._upload_spill,
                             args=(entry, backend, key),
                             name="spill-upload", daemon=True).start()
        else:
            os.makedirs(self._spill_dir, exist_ok=True)
            path = os.path.join(
                self._spill_dir, f"{self._session}_{entry.object_id.hex()}")
            with open(path, "wb") as f:
                f.write(entry.shm.buf[: entry.size])
            entry.spilled_path = path
        entry.shm.close()
        entry.shm.unlink()
        entry.shm = None
        self._used -= entry.size

    def _upload_spill(self, entry: _LocalObject, backend, key: str):
        mark = self._URI_MARK + key
        with self._lock:
            payload = entry.pending_spill
            if payload is None or entry.spilled_path != mark:
                return  # restored or deleted before the upload started
        try:
            backend.put(key, payload)
        except Exception:  # noqa: BLE001 — bytes stay in pending_spill;
            logger.warning("cloud spill upload of %s failed; keeping "
                           "bytes in memory", entry.object_id,
                           exc_info=True)
            return
        with self._lock:
            if entry.spilled_path == mark:
                entry.pending_spill = None
                return
        # Deleted (or restored) while the put was in flight: don't leak
        # the bucket object.
        try:
            backend.delete(key)
        except Exception:  # noqa: BLE001
            pass

    def _unlink_spilled(self, spilled_path: str):
        if spilled_path.startswith(self._URI_MARK):
            cloud = self._cloud_spill_backend()
            if cloud is not None:
                # Callers hold the store lock; a WAN delete must not stall
                # the node's store ops (same rationale as _upload_spill).
                key = spilled_path[len(self._URI_MARK):]
                threading.Thread(
                    target=lambda: _swallow(cloud[0].delete, key),
                    name="spill-delete", daemon=True).start()
            return
        os.unlink(spilled_path)

    def _restore(self, entry: _LocalObject) -> memoryview:
        self._ensure_capacity(entry.size)
        # Staged like every other write: a client attaching by final name
        # mid-restore would otherwise read a half-filled buffer.
        shm = shared_memory.SharedMemory(
            name=_writer_name(self._session, entry.object_id),
            create=True, size=max(entry.size, 1)
        )
        try:
            if entry.pending_spill is not None:
                # Cloud bytes: upload still in flight, upload failed, or
                # staged by get_buffer's off-lock WAN download (the only
                # route here for uri: paths).
                shm.buf[: entry.size] = entry.pending_spill
            else:
                with open(entry.spilled_path, "rb") as f:
                    f.readinto(shm.buf[: entry.size])
            _promote_segment(
                shm, _segment_name(self._session, entry.object_id))
        except BaseException:
            # A transient fetch failure must not leak the named segment —
            # the next read retries _restore, and a stale segment would
            # make its SharedMemory(create=True) fail forever.
            try:
                shm.close()
                shm.unlink()
            except Exception:  # noqa: BLE001
                pass
            raise
        try:
            self._unlink_spilled(entry.spilled_path)
        except Exception:  # noqa: BLE001 — bytes already restored; a
            pass           # failed cloud delete only leaks bucket bytes
        entry.pending_spill = None
        entry.spilled_path = None
        entry.shm = shm
        self._used += entry.size
        return shm.buf[: entry.size]

    # -- stats ---------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "num_objects": len(self._objects),
                "used_bytes": self._used,
                "capacity_bytes": self.capacity,
                "num_spilled": sum(1 for e in self._objects.values() if e.spilled_path),
                # Unsealed buffers belong to in-flight creates/pulls; a
                # steady-state nonzero value means a failed pull leaked its
                # buffer (the transfer tests assert this drains to 0).
                "num_unsealed": sum(
                    1 for e in self._objects.values() if not e.sealed),
            }

    def shutdown(self):
        with self._lock:
            for oid in list(self._objects):
                self.delete(oid)


class ObjectStoreClient:
    """Same-node client: attach sealed segments by name, zero-copy deserialize.

    Keeps attached segments open for the lifetime of any values deserialized
    from them (numpy arrays may alias the shm pages).
    """

    def __init__(self, session_suffix: str):
        self._session = session_suffix
        self._attached: Dict[ObjectID, shared_memory.SharedMemory] = {}
        self._lock = threading.Lock()

    def get_value(self, object_id: ObjectID, zero_copy: bool = True) -> Any:
        buf = self.get_buffer(object_id)
        if buf is None:
            raise KeyError(object_id)
        return serialization.deserialize(buf, zero_copy=zero_copy)

    def get_buffer(self, object_id: ObjectID) -> Optional[memoryview]:
        with self._lock:
            shm = self._attached.get(object_id)
            if shm is None:
                try:
                    shm = _AttachedSharedMemory(
                        name=_segment_name(self._session, object_id))
                except FileNotFoundError:
                    return None
                _untrack(shm)
                self._attached[object_id] = shm
            return shm.buf

    def contains(self, object_id: ObjectID) -> bool:
        return self.get_buffer(object_id) is not None

    def release(self, object_id: ObjectID):
        with self._lock:
            shm = self._attached.pop(object_id, None)
            if shm is not None:
                try:
                    shm.close()
                except (BufferError, OSError):
                    pass  # live exports keep the mapping; tracker is dropped

    def release_if_unused(self, object_id: ObjectID) -> bool:
        """Detach iff no deserialized value still aliases the segment.

        mmap refuses to close while buffer exports exist (zero-copy numpy
        views) — that BufferError IS the liveness probe: the SegmentPool
        may only recycle a segment this process cannot see views of."""
        with self._lock:
            shm = self._attached.get(object_id)
            if shm is None:
                return True
            try:
                # Bypass _AttachedSharedMemory.close(), which swallows the
                # BufferError this probe exists to observe.
                shared_memory.SharedMemory.close(shm)
            except BufferError:
                return False
            except Exception:  # noqa: BLE001 — already closed etc.
                pass
            self._attached.pop(object_id, None)
            return True

    def close(self):
        with self._lock:
            for shm in self._attached.values():
                try:
                    shm.close()
                except (BufferError, OSError):
                    pass  # process exit reclaims the mapping anyway
            self._attached.clear()
