"""LRU-resident LoRA adapter banks: many models on one engine.

Counterpart of `ray_tpu/inference/adapters.py`. A model-multiplexed engine
hosts several LoRA-style adapters that share ONE paged KV arena and one set
of step programs. This module owns the residency bookkeeping: which
`model_id` occupies which bank row, LRU eviction when a new adapter needs a
row, and the host->device copy of the banks the step programs read.

The banks are fixed-shape per-layer tensors ([n_rows, ...], row 0 the zero
identity) so adapter load/evict is pure data movement: the programs' shapes
never change. Rows holding adapters with live sequences are pinned:
eviction can never yank weights out from under a mid-flight generation.

On a tp mesh (`mesh=`) the host banks stay whole and `device_banks()`
copies out this rank's slice (`lora_bank_shardings`: ao's input dim over
tp). The scheduling rank's manager also logs each residency change
(`take_changes`), which the lockstep engine sends to its followers, whose
managers replay it (`apply_changes`), so every rank holds the same rows.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from ray_tpu_torch._torch_env import resolve_device
from ray_tpu_torch.models.llama import lora_bank_shapes, lora_bank_shardings
from ray_tpu_torch.parallel.mesh import axis_rank
from ray_tpu_torch.parallel.tensor_parallel import local_piece


class AdapterLoadError(ValueError):
    """The adapter cannot become resident (unknown id, or every row is
    pinned by live sequences)."""


class AdapterManager:
    """Residency + banks for one engine. Single-threaded by contract:
    every call happens under the engine lock (submission/step paths).

    Host banks are CPU tensors in the model dtype; `device_banks()` copies
    them (this rank's slices, on a mesh) to `device` (the card unless the
    caller asks for the CPU) once after each residency change."""

    def __init__(self, model_cfg, max_adapters: int, rank: int,
                 mesh=None,
                 device: Optional[Union[str, torch.device]] = None):
        if max_adapters < 1:
            raise ValueError("max_adapters must be >= 1 when multiplexing")
        if rank < 1:
            raise ValueError("lora rank must be >= 1")
        self._shardings = (lora_bank_shardings(model_cfg, mesh)
                           if mesh is not None else None)
        # Residency changes, logged on the rank that schedules (tp
        # coordinate 0 of a mesh) for the lockstep engine's records.
        self._changes: Optional[list] = (
            [] if mesh is not None and axis_rank(mesh, "tp") == 0 else None)
        self._device = resolve_device(device)
        self._cfg = model_cfg
        self.max_adapters = max_adapters
        self.rank = rank
        n_rows = max_adapters + 1   # row 0 = identity (never assigned)
        self._host: List[Tuple] = [
            tuple(torch.zeros(shape, dtype=model_cfg.dtype)
                  for shape in lora_bank_shapes(model_cfg, n_rows, rank))
            for _ in range(model_cfg.n_layer)]
        self._rows: Dict[str, int] = {}        # model_id -> bank row
        self._last_used: Dict[str, float] = {}  # model_id -> monotonic
        self._free_rows = list(range(n_rows - 1, 0, -1))
        self._device_banks = None               # cache, dropped on change
        self.loads = 0
        self.evictions = 0
        self.hits = 0

    # ------------------------------------------------------------ queries

    def resident(self) -> List[str]:
        return sorted(self._rows)

    def row_of(self, model_id: str) -> Optional[int]:
        return self._rows.get(model_id)

    # ---------------------------------------------------------- residency

    def ensure(self, model_id: str,
               loader: Callable[[str], list],
               pinned_rows=()) -> int:
        """Make `model_id` resident and return its bank row. `loader`
        produces the per-layer (aq, bq, ao, bo) rows on a miss (e.g.
        `make_adapter_weights` from the adapter's registered seed); LRU
        evicts the least-recently-used unpinned adapter when the bank is
        full. Raises AdapterLoadError when nothing can be evicted."""
        row = self._rows.get(model_id)
        if row is not None:
            self.hits += 1
            self._last_used[model_id] = time.monotonic()
            return row
        # Load BEFORE evicting/claiming a row: a failing loader (unknown
        # id, bad shapes) must leave residency untouched — no leaked row,
        # no victim evicted for nothing.
        weights = loader(model_id)
        if not self._free_rows:
            victim = self._pick_victim(pinned_rows)
            if victim is None:
                raise AdapterLoadError(
                    f"cannot load adapter {model_id!r}: all "
                    f"{self.max_adapters} bank rows are pinned by live "
                    "sequences (raise max_adapters)")
            self._evict(victim)
        row = self._free_rows[-1]
        self._install(model_id, row, weights)
        if self._changes is not None:
            self._changes.append((model_id, row, weights))
        return row

    def evict(self, model_id: str) -> bool:
        """Explicit eviction (tests / admin); False when not resident."""
        if model_id not in self._rows:
            return False
        self._evict(model_id)
        self._device_banks = None
        return True

    def _pick_victim(self, pinned_rows) -> Optional[str]:
        pinned = set(pinned_rows)
        candidates = [(self._last_used[mid], mid)
                      for mid, row in self._rows.items()
                      if row not in pinned]
        if not candidates:
            return None
        return min(candidates)[1]

    def _evict(self, model_id: str) -> None:
        row = self._rows.pop(model_id)
        self._last_used.pop(model_id, None)
        self._zero_row(row)
        self._free_rows.append(row)
        self.evictions += 1
        if self._changes is not None:
            self._changes.append((model_id, row, None))

    def take_changes(self) -> list:
        """The residency changes since the last call, in order: (model_id,
        row, per-layer rows) for a load, (model_id, row, None) for an
        eviction. Empty off the scheduling rank."""
        if self._changes is None:
            return []
        out, self._changes = self._changes, []
        return out

    def apply_changes(self, changes) -> None:
        """Replay the scheduling rank's residency changes (a lockstep
        follower): the same rows take the same weights."""
        for model_id, row, weights in changes:
            if weights is None:
                self._evict(model_id)
                self._device_banks = None
            else:
                self._install(model_id, row, weights)

    def _install(self, model_id: str, row: int, weights) -> None:
        """Write `weights` into free `row` and make `model_id` resident
        there. A write that fails leaves the row zeroed and free."""
        self._free_rows.remove(row)
        try:
            self._write_row(row, weights)
        except BaseException:
            self._zero_row(row)
            self._free_rows.append(row)
            raise
        self._rows[model_id] = row
        self._last_used[model_id] = time.monotonic()
        self.loads += 1
        self._device_banks = None

    def _write_row(self, row: int, weights) -> None:
        if len(weights) != len(self._host):
            raise AdapterLoadError(
                f"adapter has {len(weights)} layers; model has "
                f"{len(self._host)}")
        for layer, rows in zip(self._host, weights):
            for bank, w in zip(layer, rows):
                w = torch.as_tensor(w)
                if bank[row].shape != w.shape:
                    raise AdapterLoadError(
                        f"adapter row shape {tuple(w.shape)} != bank row "
                        f"{tuple(bank[row].shape)} (rank mismatch?)")
                bank[row] = w.to(bank.dtype)

    def _zero_row(self, row: int) -> None:
        for layer in self._host:
            for bank in layer:
                bank[row] = 0

    # -------------------------------------------------------------- banks

    def device_banks(self):
        """Per-layer [(aq, bq, ao, bo)] tensors on the engine's device for
        the step programs, cached until residency changes; on a mesh this
        rank's slice of each (`lora_bank_shardings`)."""
        if self._device_banks is None:
            def piece(bank, i):
                if self._shardings is None:
                    return bank
                return local_piece(bank, *self._shardings[i])

            self._device_banks = [
                tuple(piece(bank, i).to(self._device, copy=True)
                      for i, bank in enumerate(layer))
                for layer in self._host]
        return self._device_banks

    def stats(self) -> Dict[str, object]:
        return {
            "resident": self.resident(),
            "capacity": self.max_adapters,
            "loads": self.loads,
            "evictions": self.evictions,
            "hits": self.hits,
        }
