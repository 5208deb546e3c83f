"""Checkpoint: the interchange unit between Train/Tune/RLlib/Serve.

Equivalent of the reference's AIR `Checkpoint` (`python/ray/air/checkpoint.py:65`
— morphs dict <-> directory <-> URI), as the JAX package's
`ray_tpu/train/checkpoint.py` has it. Model state is a torch state dict
saved with `torch.save` (`from_state_dict`/`get_state_dict`), where the JAX
package stores pytrees with orbax; its sharded pytrees wait for the port's
multi-axis parallelism (ROADMAP M8c).
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
