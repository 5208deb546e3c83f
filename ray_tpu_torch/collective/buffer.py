"""Flat contiguous buffers for host collectives.

A pytree of numpy-compatible leaves is packed into one contiguous 1-D
buffer per dtype, each padded so it splits into exactly ``segments``
equal parts. Ring collectives then move *byte ranges*: wire segment ``s``
is the concatenation of every dtype buffer's ``s``-th slice, and
reductions run as in-place ufuncs on the local slices with the incoming
bytes viewed at the same offsets/dtypes — no per-leaf RPCs, no pickling
of tensor data (the reference reduces whole tensors through NCCL/Gloo
communicators; our wire is the object transfer plane, so the packing
layer is what turns a pytree into transferable flat spans).

Determinism contract: every rank must pack a structurally identical tree
(same nesting, leaf shapes and dtypes) — the dtype groups are ordered by
canonical dtype string, leaves by tree order, so byte layouts agree
across ranks without negotiation.

The port's copy of `ray_tpu/collective/buffer.py`, with torch tensors as
leaves beside numpy arrays: a tensor is copied into the host buffer of its
numpy dtype (bfloat16, which numpy lacks, travels and reduces as float32)
and unpacks as a tensor of its own dtype on its own device, so a tensor on
the card leaves it and comes back to it through host memory. Numpy trees
pack byte for byte as the JAX package packs them. torch is never imported
here: a leaf is a tensor only when torch is already loaded.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

REDUCE_UFUNCS = {
    "sum": np.add,
    "product": np.multiply,
    "min": np.minimum,
    "max": np.maximum,
}


def _ordered_keys(d: dict) -> list:
    """Deterministic key order for packing: two ranks that built the same
    dict with different INSERTION orders (one restored from a checkpoint,
    say) must still agree on the byte layout — insertion order would
    silently sum one rank's 'w' against another's 'b'."""
    try:
        return sorted(d)
    except TypeError:  # mixed/unorderable key types
        return sorted(d, key=lambda k: (type(k).__name__, str(k)))


def tree_flatten(value: Any) -> Tuple[Any, List[Any]]:
    """Minimal pytree flatten over dict/list/tuple containers. Dict keys
    are visited in sorted order (see _ordered_keys); sequence order must
    match across ranks."""
    leaves: List[Any] = []

    def rec(v):
        if isinstance(v, dict):
            return ("d", type(v), [(k, rec(v[k])) for k in _ordered_keys(v)])
        if isinstance(v, (list, tuple)):
            return ("s", type(v), [rec(x) for x in v])
        leaves.append(v)
        return ("l", None, len(leaves) - 1)

    spec = rec(value)
    return spec, leaves


def tree_unflatten(spec: Any, leaves: List[Any]) -> Any:
    kind, typ, payload = spec
    if kind == "d":
        return typ((k, tree_unflatten(s, leaves)) for k, s in payload)
    if kind == "s":
        return typ(tree_unflatten(s, leaves) for s in payload)
    return leaves[payload]


def tree_index(x: Any, rank: int, world: int) -> Any:
    """Row-slice every leaf: rank r gets rows [r*n/W, (r+1)*n/W).

    Leaves whose leading dimension does not divide evenly raise a clear
    ValueError — silently dropping the remainder rows (the old behavior)
    loses data on every rank.
    """
    if isinstance(x, dict):
        return {k: tree_index(v, rank, world) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_index(v, rank, world) for v in x)
    arr = x if _tensor_meta(x) is not None else np.asarray(x)
    if arr.ndim == 0 or arr.shape[0] % world != 0:
        raise ValueError(
            f"reducescatter: leading dimension {arr.shape[0] if arr.ndim else 0} "
            f"of a leaf with shape {arr.shape} is not divisible by "
            f"world_size={world}; pad the array (or gather with allreduce) "
            "instead — a silent remainder drop would lose rows on every rank")
    chunk = arr.shape[0] // world
    return arr[rank * chunk:(rank + 1) * chunk]


def _tensor_meta(x: Any) -> Optional[Tuple[Any, Any]]:
    """(dtype, device) of a torch tensor leaf, None for anything else."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor):
        return x.dtype, x.device
    return None


def _to_host(x: Any, meta: Optional[Tuple[Any, Any]]) -> np.ndarray:
    if meta is None:
        return np.asarray(x)
    x = x.detach()
    if meta[0] is sys.modules["torch"].bfloat16:
        x = x.float()
    return x.cpu().numpy()


def _from_host(a: np.ndarray, meta: Optional[Tuple[Any, Any]]) -> Any:
    if meta is None:
        return a
    dtype, device = meta
    return sys.modules["torch"].from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype)


class PackedTree:
    """A pytree packed into per-dtype padded contiguous buffers."""

    def __init__(self, value: Any, segments: int):
        self.segments = max(1, int(segments))
        self.spec, leaves = tree_flatten(value)
        self.tensor_meta = [_tensor_meta(x) for x in leaves]
        arrays = [_to_host(x, m) for x, m in zip(leaves, self.tensor_meta)]
        self.leaf_meta = [(a.shape, a.dtype) for a in arrays]
        groups: Dict[str, List[int]] = {}
        for i, a in enumerate(arrays):
            groups.setdefault(a.dtype.str, []).append(i)
        self.buffers: List[np.ndarray] = []
        self.seg_elems: List[int] = []
        # per buffer: [(leaf index, start elem, elem count), ...]
        self.layout: List[List[Tuple[int, int, int]]] = []
        for dt in sorted(groups):
            idxs = groups[dt]
            dtype = np.dtype(dt)
            total = sum(arrays[i].size for i in idxs)
            per_seg = -(-total // self.segments) if total else 0
            buf = np.zeros(per_seg * self.segments, dtype=dtype)
            pos, slices = 0, []
            for i in idxs:
                n = arrays[i].size
                buf[pos:pos + n] = np.ascontiguousarray(arrays[i]).reshape(-1)
                slices.append((i, pos, n))
                pos += n
            self.buffers.append(buf)
            self.seg_elems.append(per_seg)
            self.layout.append(slices)
        self.total_bytes = sum(b.nbytes for b in self.buffers)
        self.segment_nbytes = sum(p * b.itemsize
                                  for p, b in zip(self.seg_elems, self.buffers))

    # ------------------------------------------------------------ wire spans

    def _seg_slice(self, b: int, s: int) -> np.ndarray:
        p = self.seg_elems[b]
        return self.buffers[b][s * p:(s + 1) * p]

    def segment_parts(self, s: int) -> List[memoryview]:
        """Zero-copy views of wire segment ``s`` (one span per dtype
        buffer); callers must copy before the local buffer mutates."""
        return [memoryview(self._seg_slice(b, s)).cast("B")
                for b in range(len(self.buffers)) if self.seg_elems[b]]

    def whole_parts(self) -> List[memoryview]:
        return [memoryview(b).cast("B") for b in self.buffers if b.size]

    # ------------------------------------------------------------ reductions

    def _incoming_views(self, data, per_buffer_elems: List[int]):
        mv = data if isinstance(data, memoryview) else memoryview(data)
        off = 0
        for b, n in enumerate(per_buffer_elems):
            nbytes = n * self.buffers[b].itemsize
            yield b, np.frombuffer(mv[off:off + nbytes],
                                   dtype=self.buffers[b].dtype)
            off += nbytes
        if off != mv.nbytes:
            raise ValueError(f"collective payload size mismatch: got "
                             f"{mv.nbytes} bytes, layout expects {off}")

    def reduce_segment(self, s: int, data, ufunc) -> None:
        """In-place ``dst = ufunc(dst, incoming)`` on wire segment ``s`` —
        the reduce-into half of the ring (incoming bytes are the peer's
        store segment, viewed without a copy)."""
        for b, src in self._incoming_views(data, self.seg_elems):
            dst = self._seg_slice(b, s)
            ufunc(dst, src, out=dst)

    def set_segment(self, s: int, data) -> None:
        for b, src in self._incoming_views(data, self.seg_elems):
            self._seg_slice(b, s)[:] = src

    def reduce_whole(self, data, ufunc) -> None:
        for b, src in self._incoming_views(
                data, [bf.size for bf in self.buffers]):
            ufunc(self.buffers[b], src, out=self.buffers[b])

    # -------------------------------------------------------------- unpack

    def unpack(self, mean_divisor: Optional[int] = None) -> Any:
        if mean_divisor and mean_divisor > 1:
            for buf in self.buffers:
                if np.issubdtype(buf.dtype, np.inexact):
                    buf /= mean_divisor
                elif np.issubdtype(buf.dtype, np.integer):
                    buf //= mean_divisor
        leaves: List[Any] = [None] * len(self.leaf_meta)
        for b, slices in enumerate(self.layout):
            for i, pos, n in slices:
                shape, _ = self.leaf_meta[i]
                leaves[i] = _from_host(
                    self.buffers[b][pos:pos + n].reshape(shape),
                    self.tensor_meta[i])
        return tree_unflatten(self.spec, leaves)
