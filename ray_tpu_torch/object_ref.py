"""ObjectRef: a future for a value in the distributed object store.

Equivalent of `ray.ObjectRef` (`python/ray/_raylet.pyx` ObjectRef): compares
and hashes by id, picklable (passing one to a task makes that task a
borrower), supports `future()`-style callbacks via the owning runtime.
"""

from __future__ import annotations

import threading
from typing import Optional

from ray_tpu_torch.core.ids import ObjectID

# Active during task-arg serialization: ObjectRefs pickled INSIDE argument
# values (nested refs) are recorded here so the owner can pin them until
# the executing worker registers its borrow (reference: "contained object
# ids" collected by the serialization context, serialization.py).
_capture = threading.local()


class _NestedRefCapture:
    def __enter__(self):
        self._prev = getattr(_capture, "ids", None)
        _capture.ids = []
        return _capture.ids

    def __exit__(self, *exc):
        _capture.ids = self._prev


# Active during value DEserialization: refs reconstructed inside one
# pickle.loads register their borrows in a single batched GCS call at
# scope exit instead of one blocking round trip per ref (a value holding
# 1,000 refs would otherwise pay 1,000 RPCs before user code runs).
_borrow_scope = threading.local()


class _BorrowScope:
    def __enter__(self):
        self._outermost = getattr(_borrow_scope, "ids", None) is None
        if self._outermost:
            _borrow_scope.ids = []
        return self

    def __exit__(self, *exc):
        if not self._outermost:
            return
        ids, _borrow_scope.ids = _borrow_scope.ids, None
        if ids:
            rt = _current_runtime()
            if rt is not None:
                rt.on_refs_deserialized(ids)


class ObjectRef:
    __slots__ = ("object_id", "_owner_hint", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_hint: Optional[str] = None):
        self.object_id = object_id
        self._owner_hint = owner_hint
        rt = _current_runtime()
        if rt is not None:
            rt.register_ref(object_id)

    def binary(self) -> bytes:
        return self.object_id.binary()

    def hex(self) -> str:
        return self.object_id.hex()

    def task_id(self):
        return self.object_id.task_id()

    def __hash__(self):
        return hash(self.object_id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.object_id == self.object_id

    def __repr__(self):
        return f"ObjectRef({self.object_id.hex()})"

    def __reduce__(self):
        ids = getattr(_capture, "ids", None)
        if ids is not None:
            ids.append(self.object_id)
        return (_reconstruct_ref, (self.object_id.binary(), self._owner_hint))

    def __del__(self):
        try:
            rt = _current_runtime()
            if rt is not None:
                rt.deregister_ref(self.object_id)
        except Exception:
            pass

    def __await__(self):
        """Allow `await ref` inside async actors."""
        import asyncio

        async def _poll():
            import ray_tpu_torch
            from ray_tpu_torch.core import runtime as _rt

            # Unbounded by API contract (await has no deadline parameter)
            # — registered as ONE parked op for its whole duration so the
            # chaos HangWatchdog sees a wedged await as a hang, not as an
            # innocuous stream of 0-timeout polls.
            with _rt._ParkedOp(f"await {self.object_id.hex()[:12]}"):
                while True:
                    ready, _ = ray_tpu_torch.wait([self], timeout=0)
                    if ready:
                        return ray_tpu_torch.get(self)
                    await asyncio.sleep(0.002)

        return _poll().__await__()

    def future(self):
        """A concurrent.futures.Future resolving to the value."""
        import concurrent.futures
        import threading

        import ray_tpu_torch

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def run():
            try:
                fut.set_result(ray_tpu_torch.get(self))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True).start()
        return fut


def _current_runtime():
    import ray_tpu_torch

    return getattr(ray_tpu_torch, "_global_runtime", None)


def _reconstruct_ref(binary: bytes, owner_hint):
    # Deserializing a ref makes this process a borrower: the object must
    # survive the owner's free until this process drops it (reference
    # reference_count.h borrower protocol). Inside a _BorrowScope the
    # registration batches; bare reconstructions register one-by-one.
    ref = ObjectRef(ObjectID(binary), owner_hint)
    ids = getattr(_borrow_scope, "ids", None)
    if ids is not None:
        ids.append(ref.object_id)
        return ref
    rt = _current_runtime()
    if rt is not None:
        rt.on_refs_deserialized([ref.object_id])
    return ref
