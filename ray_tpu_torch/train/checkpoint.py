"""Checkpoint: the interchange unit between Train/Tune/RLlib/Serve.

Equivalent of the reference's AIR `Checkpoint` (`python/ray/air/checkpoint.py:65`
— morphs dict <-> directory <-> URI), as the JAX package's
`ray_tpu/train/checkpoint.py` has it. Model state is a torch state dict
saved with `torch.save` (`from_state_dict`/`get_state_dict`), where the JAX
package stores pytrees with orbax. Sharded checkpoints (`save_sharded_pytree`
and the rest below) write each rank's shards of a dict of tensors as raw
bytes with an index, and restore them at any width.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
from typing import Any, Dict, Optional

_DICT_BLOB = "_ckpt_dict.pkl"
_STATE_DICT = "state_dict.pt"


class Checkpoint:
    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 path: Optional[str] = None):
        if (data is None) == (path is None):
            raise ValueError("Checkpoint needs exactly one of data or path")
        self._data = data
        self._path = path

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=os.path.abspath(path))

    @classmethod
    def from_uri(cls, uri: str) -> "Checkpoint":
        """Materialize from a URI: file:// maps directly; cloud schemes
        (gs://, s3://, memory://) download through the pluggable storage
        backends (reference `air/checkpoint.py:65` from_uri)."""
        if uri.startswith("file://"):
            return cls.from_directory(uri[len("file://"):])
        from ray_tpu_torch.train import storage

        local = tempfile.mkdtemp(prefix="rtt_ckpt_dl_")
        storage.download_dir(uri, local)
        return cls.from_directory(local)

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any],
                        path: Optional[str] = None) -> "Checkpoint":
        """A directory checkpoint of a torch state dict (a model's,
        an optimizer's, or a dict of them), written with `torch.save`:
        the port's counterpart of the JAX package's orbax `from_pytree`."""
        import torch

        path = path or tempfile.mkdtemp(prefix="rtt_ckpt_")
        os.makedirs(path, exist_ok=True)
        torch.save(state, os.path.join(path, _STATE_DICT))
        return cls.from_directory(path)

    # -- views ---------------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        blob = os.path.join(self._path, _DICT_BLOB)
        if os.path.exists(blob):
            with open(blob, "rb") as f:
                return pickle.load(f)
        raise ValueError(
            f"Directory checkpoint at {self._path} has no dict payload; "
            "use to_directory()/get_state_dict()")

    def to_directory(self, path: Optional[str] = None) -> str:
        path = path or tempfile.mkdtemp(prefix="rtt_ckpt_")
        os.makedirs(path, exist_ok=True)
        if self._data is not None:
            with open(os.path.join(path, _DICT_BLOB), "wb") as f:
                pickle.dump(self._data, f)
        elif os.path.abspath(self._path) != os.path.abspath(path):
            shutil.copytree(self._path, path, dirs_exist_ok=True)
        return path

    def get_state_dict(self, map_location: Any = "cpu") -> Dict[str, Any]:
        """The state dict `from_state_dict` saved, loaded with `torch.load`
        onto `map_location` (the CPU by default)."""
        import torch

        assert self._path, "state-dict checkpoints are directory-backed"
        return torch.load(os.path.join(self._path, _STATE_DICT),
                          map_location=map_location, weights_only=True)

    def to_uri(self, uri: str) -> str:
        """Persist to a URI and return it; cloud schemes upload through
        the storage backends (on TPU pods local disk dies with the VM —
        durable checkpoints go through here)."""
        if uri.startswith("file://"):
            self.to_directory(uri[len("file://"):])
            return uri
        from ray_tpu_torch.train import storage

        if self._path is not None:
            local = self._path
        else:
            local = self.to_directory()
        storage.upload_dir(local, uri)
        return uri

    @property
    def uri(self) -> Optional[str]:
        return f"file://{self._path}" if self._path else None

    @property
    def path(self) -> Optional[str]:
        return self._path

    def __repr__(self):
        kind = "dict" if self._data is not None else f"dir:{self._path}"
        return f"Checkpoint({kind})"

    def __reduce__(self):
        # Dict checkpoints travel by value; directory checkpoints by path
        # (the path must be reachable by the receiver — same host or shared fs).
        return (Checkpoint, (self._data, self._path))


# --------------------------------------------------------------------------- #
# Shard-aware checkpoints: per-rank shard files + an index manifest
# --------------------------------------------------------------------------- #
#
# A sharded model checkpoints WITHOUT gathering the whole state on one
# process: each rank writes only its own shards as raw little-endian files
# (the bytes of the tensor, its dtype in the manifest: bit-exact by
# construction, bfloat16 included) plus a per-rank manifest; rank 0 merges
# them into one index (`manifest.json`) mapping every leaf to {shape, dtype,
# shards: [{file, index}]}. Restore assembles each leaf from its shard
# slices and places it under ANY layout: a tp 2 save restores onto tp 1 or
# tp 4 bit-exactly, because resharding raw bytes is pure slicing.
#
# A tree is a dict of tensors, nested dicts allowed; a leaf's key is its
# path of dict keys joined by "/" (e.g. "params/layers.0.wq.weight").

_SHARD_MANIFEST = "manifest.json"


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tensor_bytes(t) -> bytes:
    """The raw bytes of a tensor (any dtype) in C order."""
    import torch

    return t.detach().cpu().contiguous().reshape(-1).view(
        torch.uint8).numpy().tobytes()


def _from_bytes(data: bytes, dtype_name: str, shape):
    import torch

    dtype = getattr(torch, dtype_name)
    if not data:                     # an empty shard
        return torch.empty(shape, dtype=dtype)
    flat = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return flat.view(dtype).reshape(shape)


def _local_shard(t):
    """(local tensor, [[start, stop], ...] in the global tensor, whole) of
    a leaf: a DTensor's shard on this rank, or a plain tensor as the whole
    (fully replicated) array."""
    from torch.distributed.tensor import DTensor, Replicate

    shape = tuple(t.shape)
    if isinstance(t, DTensor):
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)

        local = t.to_local()
        lshape, offset = compute_local_shape_and_global_offset(
            t.shape, t.device_mesh, t.placements)
        index = [[int(o), int(o) + int(n)] for o, n in zip(offset, lshape)]
        whole = all(isinstance(p, Replicate) for p in t.placements)
        return local, index, whole
    return t, [[0, d] for d in shape], True


def save_sharded_pytree(path: str, tree: Dict[str, Any],
                        process_index: int = 0, process_count: int = 1,
                        meta: Optional[Dict[str, Any]] = None,
                        own_replicated: Optional[bool] = None) -> str:
    """Save this process's shards of `tree` (a dict of tensors, nested
    dicts allowed) under `path`. Single-process saves are complete at once;
    multi-process saves need every rank to call this, then rank 0 to call
    `merge_sharded_manifest` (after a barrier) to write the unified index.

    A DTensor leaf writes its local shard with its index in the global
    tensor; a plain tensor counts as fully replicated. `own_replicated`
    says who writes fully replicated leaves. Default (None -> rank 0 only)
    fits SPMD saves where every rank holds the same tree. Pipeline-stage
    saves hold DISJOINT subtrees per rank (no other rank has this rank's
    keys), so they pass True and each rank writes its own replicated
    leaves; the merge dedupes any key two ranks both wrote by shard index,
    so mixed modes stay safe."""
    owns = process_index == 0 if own_replicated is None else own_replicated
    os.makedirs(path, exist_ok=True)
    entries: Dict[str, Any] = {}
    for key, leaf in _flatten(tree).items():
        local, index, whole = _local_shard(leaf)
        shards = []
        if owns or not whole:
            fname = f"{_sanitize(key)}.p{process_index}.s0.bin"
            with open(os.path.join(path, fname), "wb") as f:
                f.write(_tensor_bytes(local))
            shards.append({"file": fname, "index": index})
        entries[key] = {"shape": list(leaf.shape),
                        "dtype": _dtype_name(leaf.dtype), "shards": shards}
    rank_manifest = {"process_index": process_index,
                     "process_count": process_count,
                     "meta": dict(meta or {}), "entries": entries}
    with open(os.path.join(path, f"manifest.p{process_index}.json"),
              "w") as f:
        json.dump(rank_manifest, f)
    if process_count == 1:
        merge_sharded_manifest(path, process_count=1)
    return path


def _sanitize(key: str) -> str:
    """Filesystem-safe shard-file stem. Distinct keys can sanitize to the
    same text ('a/b_c' vs 'a_b/c'), so a crc of the ORIGINAL key is
    appended: two leaves never share a shard file."""
    import zlib

    text = "".join(c if c.isalnum() or c in "._-" else "_" for c in key)
    return f"{text}.{zlib.crc32(key.encode()):08x}"


def merge_sharded_manifest(path: str, process_count: int) -> str:
    """Merge every rank's manifest into the single restore index, called
    by rank 0 AFTER all ranks finished saving (the caller owns the
    barrier). Raises when a rank's manifest is missing (a stage that never
    saved) and when any leaf is not fully covered."""
    import math

    merged: Dict[str, Any] = {}
    meta: Dict[str, Any] = {}
    for p in range(process_count):
        with open(os.path.join(path, f"manifest.p{p}.json")) as f:
            rank_manifest = json.load(f)
        meta.update(rank_manifest.get("meta") or {})
        for key, entry in rank_manifest["entries"].items():
            into = merged.setdefault(
                key, {"shape": entry["shape"], "dtype": entry["dtype"],
                      "shards": []})
            if into["shape"] != entry["shape"] \
                    or into["dtype"] != entry["dtype"]:
                raise ValueError(
                    f"sharded checkpoint {path}: leaf {key!r} disagrees "
                    f"across ranks ({into['shape']}/{into['dtype']} vs "
                    f"{entry['shape']}/{entry['dtype']})")
            seen = {tuple(map(tuple, s["index"])) for s in into["shards"]}
            for s in entry["shards"]:
                if tuple(map(tuple, s["index"])) not in seen:
                    into["shards"].append(s)
    for key, entry in merged.items():
        total = math.prod(entry["shape"])
        shards = entry["shards"]
        # Overlap would let the volume sum mask a missing region: a save's
        # shards partition the tensor, so ANY overlap is a corrupt
        # manifest, and with none the volume sum is an exact check.
        for i in range(len(shards)):
            for j in range(i + 1, len(shards)):
                if all(a1 < b2 and a2 < b1
                       for (a1, b1), (a2, b2)
                       in zip(shards[i]["index"], shards[j]["index"])):
                    raise ValueError(
                        f"sharded checkpoint {path}: leaf {key!r} has "
                        f"overlapping shards {shards[i]['index']} and "
                        f"{shards[j]['index']}: manifests disagree on "
                        "the partitioning")
        covered = sum(math.prod(max(0, b - a) for a, b in s["index"])
                      for s in shards)
        if covered < total:
            raise ValueError(
                f"sharded checkpoint {path}: leaf {key!r} covers only "
                f"{covered}/{total} elements: a rank's shards are missing "
                "(did every rank save before the merge?)")
    with open(os.path.join(path, _SHARD_MANIFEST), "w") as f:
        json.dump({"process_count": process_count, "meta": meta,
                   "entries": merged}, f)
    return path


def sharded_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, _SHARD_MANIFEST)) as f:
        return json.load(f)


def restore_sharded_pytree(path: str, target: Optional[Dict[str, Any]] = None,
                           shardings: Any = None) -> Dict[str, Any]:
    """Restore a sharded checkpoint as CPU tensors, resharding as needed.

    - `target`: a tree with the SAME keys as the saved one (its leaves,
      e.g. meta tensors, only name the keys); the result has its structure
      and only its keys. Without it, the whole checkpoint is returned as
      nested dicts keyed by the manifest's "/"-separated paths.
    - `shardings`: a (DeviceMesh, placements) pair for every leaf, or a
      tree of them matching the result (None leaves stay as they are);
      leaves are placed as DTensors with `distribute_tensor`. THIS is the
      resharding path, bit-exact at any source and target tp width
      because assembly and re-slicing move raw bytes.
    """
    import torch

    manifest = sharded_manifest(path)

    def load(key):
        entry = manifest["entries"].get(key)
        if entry is None:
            raise KeyError(f"sharded checkpoint {path} has no leaf {key!r} "
                           f"(has: {sorted(manifest['entries'])[:8]}...)")
        shape = tuple(entry["shape"])
        out = torch.empty(shape, dtype=getattr(torch, entry["dtype"]))
        for s in entry["shards"]:
            idx = tuple(slice(a, b) for a, b in s["index"])
            with open(os.path.join(path, s["file"]), "rb") as f:
                data = f.read()
            out[idx] = _from_bytes(data, entry["dtype"],
                                   tuple(b - a for a, b in s["index"]))
        return out

    def build(keys):
        result: Dict[str, Any] = {}
        for key in keys:
            node = result
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = load(key)
        return result

    keys = list(_flatten(target)) if target is not None \
        else list(manifest["entries"])
    result = build(keys)
    if shardings is not None:
        result = _place(result, shardings)
    return result


def _place(tree: Dict[str, Any], shardings) -> Dict[str, Any]:
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for k, v in tree.items():
        sh = shardings if isinstance(shardings, tuple) else shardings.get(k)
        if isinstance(v, dict):
            out[k] = v if sh is None else _place(v, sh)
        elif sh is None:
            out[k] = v
        else:
            mesh, placements = sh
            out[k] = distribute_tensor(v, mesh, placements)
    return out


# --------------------------------------------------------------------------- #
# Keep-N checkpoint bookkeeping
# --------------------------------------------------------------------------- #


class CheckpointManager:
    """Tracks reported checkpoints; keeps best-N by a score attribute
    (reference `air/_internal/checkpoint_manager.py`)."""

    def __init__(self, storage_path: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None, score_order: str = "max"):
        self.storage_path = storage_path
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._entries = []  # list of (score, index, path, metrics)
        self._index = 0

    def register(self, checkpoint: Checkpoint, metrics: Dict[str, Any]) -> str:
        self._index += 1
        # The directory is made at the first checkpoint, so a run that
        # reports none writes nothing.
        dest = os.path.join(self.storage_path, f"checkpoint_{self._index:06d}")
        checkpoint.to_directory(dest)
        with open(os.path.join(dest, "metrics.json"), "w") as f:
            json.dump({k: v for k, v in metrics.items()
                       if isinstance(v, (int, float, str, bool))}, f)
        score = metrics.get(self.score_attribute, self._index) \
            if self.score_attribute else self._index
        self._entries.append((score, self._index, dest, metrics))
        self._evict()
        return dest

    def _evict(self):
        if self.num_to_keep is None or len(self._entries) <= self.num_to_keep:
            return
        reverse = self.score_order == "max"
        ranked = sorted(self._entries, key=lambda e: e[0], reverse=reverse)
        keep = ranked[: self.num_to_keep]
        for entry in self._entries:
            if entry not in keep:
                shutil.rmtree(entry[2], ignore_errors=True)
        self._entries = [e for e in self._entries if e in keep]

    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        reverse = self.score_order == "max"
        best = sorted(self._entries, key=lambda e: e[0], reverse=reverse)[0]
        return Checkpoint.from_directory(best[2])

    def latest_checkpoint(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        return Checkpoint.from_directory(max(self._entries, key=lambda e: e[1])[2])
