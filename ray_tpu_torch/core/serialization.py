"""Serialization: cloudpickle + pickle protocol 5 out-of-band buffers.

Equivalent of the reference's `SerializationContext`
(`python/ray/_private/serialization.py:108`) + vendored cloudpickle: values are
pickled with protocol 5; large contiguous buffers (numpy arrays, CPU
tensors) are carried out-of-band so readers can map them zero-copy from shared
memory. Exceptions are wrapped so the remote traceback survives the boundary.

Wire layout of a serialized value:

    [8B magic+version][msgpack header: {p: pickle_len, b: [buffer lengths]}]
    [pickle bytes][buffer 0 (8B aligned)][buffer 1]...
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, List, Tuple

import cloudpickle
import msgpack

_MAGIC = b"RTPU\x01\x00\x00\x00"
_ALIGN = 8


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


# Above this size the opcode walk itself could cost milliseconds on the
# submit hot path (many-opcode object graphs); callers pick the safe
# answer for oversized payloads instead of scanning.
_REFS_MAIN_SCAN_MAX = 256 * 1024


def _refs_main(payload: bytes) -> bool:
    """Does this pickle reference the __main__ MODULE (a by-reference
    global, unresolvable on a peer) — as opposed to merely containing the
    byte literal inside an embedded data blob (pre-serialized function
    bytes ride inside TaskSpecs on every submit, and a substring hit
    there must NOT force the 2.5x cloudpickle fallback)? The substring
    scan is the cheap gate (no hit, no cost); on a hit, a pickletools
    opcode walk looks for a standalone '__main__' string — module refs
    surface as GLOBAL/unicode opcodes, while blob content stays inside a
    single bytes-opcode argument. Errs toward cloudpickle on anything
    unexpected. Payloads over the scan cap skip the walk and report True
    unscanned: oversized hits are rare (function blobs that big are
    unusual, args travel separately), and paying the cloudpickle fallback
    there is safe — assuming 'blob content' would silently reopen the
    peer-side AttributeError this guard exists to prevent.

    Known tradeoff: the walk re-runs per message even for an identical
    embedded blob (no memoization — control payloads are fresh bytes each
    time, so a verdict cache would have to hash the payload, which costs
    about as much as the walk it saves). Bounded by the scan cap."""
    if b"__main__" not in payload:
        return False
    if len(payload) > _REFS_MAIN_SCAN_MAX:
        return True
    try:
        import pickletools

        for op, arg, _pos in pickletools.genops(payload):
            name = op.name
            if name == "GLOBAL":
                if isinstance(arg, str) and arg.startswith("__main__"):
                    return True
            elif "UNICODE" in name and arg == "__main__":
                return True
        return False
    except Exception:  # noqa: BLE001 — be safe, capture by value
        return True


def serialize(value: Any) -> List[memoryview | bytes]:
    """Serialize to a list of buffers (header + pickle + OOB buffers).

    Returns a buffer list suitable for vectored writes; total size is
    sum(len(b) padded to 8) for the OOB region.
    """
    oob: List[pickle.PickleBuffer] = []

    def callback(buf: pickle.PickleBuffer):
        oob.append(buf)
        return False  # out-of-band

    # C-pickle fast path (~2.5x cheaper than cloudpickle and this is every
    # task arg / put value / return). Plain pickle serializes driver-script
    # classes BY REFERENCE ("__main__.X") — dumps fine here, unresolvable
    # on the peer — so any payload referencing __main__ falls back to
    # cloudpickle's by-value capture. Closures/lambdas/locals fail the
    # plain dump outright and fall back the same way.
    try:
        payload = pickle.dumps(value, protocol=5, buffer_callback=callback)
        if _refs_main(payload):
            raise ValueError("by-reference __main__ pickle")
    except Exception:  # noqa: BLE001 — retry by value
        oob.clear()
        payload = cloudpickle.dumps(value, protocol=5, buffer_callback=callback)
    raw_views: List[memoryview] = []
    lens: List[int] = []
    for b in oob:
        m = b.raw()
        if not m.contiguous:
            m = memoryview(bytes(b))
        else:
            m = m.cast("B")
        raw_views.append(m)
        lens.append(m.nbytes)
    header = msgpack.packb({"p": len(payload), "b": lens})
    parts: List[memoryview | bytes] = [
        _MAGIC + struct.pack("<I", len(header)),
        header,
        payload,
    ]
    # Pad pickle so OOB buffers start aligned.
    pos = len(_MAGIC) + 4 + len(header) + len(payload)
    for m in raw_views:
        pad = _align(pos) - pos
        if pad:
            parts.append(b"\x00" * pad)
            pos += pad
        parts.append(m)
        pos += m.nbytes
    return parts


def serialized_size(parts: List[memoryview | bytes]) -> int:
    return sum(p.nbytes if isinstance(p, memoryview) else len(p) for p in parts)


def serialize_to_bytes(value: Any) -> bytes:
    return b"".join(bytes(p) if isinstance(p, memoryview) else p for p in serialize(value))


def deserialize(data: memoryview | bytes, zero_copy: bool = True) -> Any:
    """Deserialize from a contiguous buffer. When ``zero_copy`` and ``data``
    is a memoryview backed by shared memory, numpy arrays reference the shm
    pages directly (read-only semantics are the caller's contract)."""
    view = memoryview(data).cast("B")
    if bytes(view[:4]) != _MAGIC[:4]:
        raise ValueError("Corrupt serialized value (bad magic)")
    (hlen,) = struct.unpack("<I", view[8:12])
    header = msgpack.unpackb(bytes(view[12 : 12 + hlen]))
    pos = 12 + hlen
    payload = view[pos : pos + header["p"]]
    pos += header["p"]
    buffers = []
    for blen in header["b"]:
        pos = _align(pos)
        b = view[pos : pos + blen]
        if not zero_copy:
            b = memoryview(bytes(b))
        else:
            # Zero-copy readers alias shared-memory pages: hand out read-only
            # views so a consumer mutating e.g. a numpy array cannot corrupt
            # the object for other readers (reference: plasma buffers are
            # read-only after seal).
            b = b.toreadonly()
        buffers.append(b)
        pos += blen
    from ray_tpu_torch.object_ref import _BorrowScope

    with _BorrowScope():
        return pickle.loads(bytes(payload), buffers=buffers)


def dumps(value: Any) -> bytes:
    """Plain in-band cloudpickle (for user functions/classes, which must
    be captured BY VALUE — a __main__-defined function pickled by
    reference would dump fine here and fail to import on the worker)."""
    return cloudpickle.dumps(value)


def dumps_ctrl(value: Any) -> bytes:
    """Control-plane envelope serializer: C-pickle first (2.5x faster than
    cloudpickle on a TaskSpec, and this runs on every RPC), cloudpickle
    only when plain pickle cannot (closures, locals). Safe because control
    messages carry framework types and PRE-SERIALIZED user blobs only —
    user functions/classes/args all flow as bytes produced by dumps()/
    serialize() upstream, never as live objects. Same `__main__` guard as
    serialize(): plain pickle captures driver-script types BY REFERENCE,
    which dumps fine here and explodes peer-side with an AttributeError
    nobody can act on — fall back to cloudpickle's by-value capture."""
    try:
        payload = pickle.dumps(value, protocol=5)
        if _refs_main(payload):
            raise ValueError("by-reference __main__ pickle")
    except Exception:  # noqa: BLE001 — closure/local/__main__ in envelope
        return cloudpickle.dumps(value)
    return payload


def loads(data: bytes) -> Any:
    return pickle.loads(data)


def serialize_exception(exc: BaseException, function_name: str = "") -> bytes:
    """Serialize an exception as a framed value (so error blobs can double as
    object-store values: the reference stores RayTaskError AS the object so
    dependent tasks schedule and then raise). Falls back when unpicklable."""
    import traceback

    from ray_tpu_torch.exceptions import RayTaskError

    if isinstance(exc, RayTaskError):
        # Already wrapped upstream (error object flowed through a dependency):
        # re-serialize as-is so the original cause's type survives.
        return serialize_to_bytes(RayTaskError(exc.function_name,
                                               exc.traceback_str, exc.cause))
    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    try:
        cause: Exception | None = exc if isinstance(exc, Exception) else None
        err = RayTaskError(function_name, tb, cause)
        return serialize_to_bytes(err)
    except Exception:
        err = RayTaskError(function_name, tb, None)
        return serialize_to_bytes(err)


def deserialize_exception(data: bytes):
    try:
        return deserialize(data, zero_copy=False)
    except Exception as e:  # unpicklable user exception type on this side
        from ray_tpu_torch.exceptions import RaySystemError

        return RaySystemError(f"Failed to deserialize remote error: {e}")
