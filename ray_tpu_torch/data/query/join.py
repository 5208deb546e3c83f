"""Distributed join: broadcast when the build side is small, hash
exchange otherwise.

- **Broadcast join**: when the right (build) side's sealed bytes fit
  `query_broadcast_join_bytes`, every left block probes against ALL
  right blocks in one fused task whose args carry the right-side refs —
  the object store ships each right block to a node AT MOST ONCE (the
  store caches; with same-host attach the second consumer on a node
  pays a memcpy, not a socket). No exchange of the large side at all.
- **Hash-shuffle join**: both sides exchange through the windowed
  shuffle (mode="hash" on their join keys, SAME partition count), so
  partition i of the left can only match partition i of the right; a
  per-partition task builds a hash table from the right rows and probes
  left rows in order. Both exchanges share one pipeline ByteBudget, so
  a join never holds more unsealed bytes than any other dataflow.

Semantics (inner/left): left row order is preserved; each left row
emits one merged row per matching right row, in right-side original
order. Merged rows take left values; colliding non-key right columns
get the "_1" suffix (the zip() convention). `how="left"` emits
unmatched left rows with the right side's observed columns set to None.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

_HOW = ("inner", "left")


class _KeyGetter:
    """Picklable row -> join-key extractor for the hash exchange."""

    def __init__(self, on: str):
        self.on = on

    def __call__(self, row):
        if not isinstance(row, dict):
            raise ValueError(
                "join() needs record rows (dicts) with the join column; "
                f"got {type(row).__name__}")
        return row[self.on]


def _merge_row(lrow: dict, rrow: Optional[dict], left_on: str,
               right_on: str, rcols: List[str]) -> dict:
    out = dict(lrow)
    if rrow is None:  # left-join miss: observed right columns -> None
        for c in rcols:
            if c != right_on:
                out[c + "_1" if c in lrow else c] = None
        return out
    for c, v in rrow.items():
        if c == right_on:
            continue  # join key already present from the left row
        out[c + "_1" if c in lrow else c] = v
    return out


def right_block_columns(block) -> List[str]:
    """Column NAMES of one build-side block, in observation order —
    bounded metadata the driver unions so left-join None-fill agrees
    across strategies (a hash partition may see none/part of the right
    columns; the broadcast path always sees them all)."""
    from ray_tpu_torch.data.block import BlockAccessor

    cols: List[str] = []
    seen = set()
    for row in BlockAccessor(block).rows():
        if isinstance(row, dict):
            for c in row:
                if c not in seen:
                    seen.add(c)
                    cols.append(c)
    return cols


def join_partition_blocks(left_on: str, right_on: str, how: str,
                          rcols_hint: Optional[List[str]],
                          left_block, *right_blocks):
    """Build a hash table from the right rows, probe left rows in order.
    Runs remotely — as the per-partition task of the shuffle join, or as
    the per-left-block task of the broadcast join (right_blocks then =
    the ENTIRE build side). `rcols_hint` carries the GLOBAL right-side
    column set for left joins on the hash path, where this partition's
    slice of the build side may not observe every column."""
    from ray_tpu_torch.data.block import BlockAccessor

    build: Dict[Any, List[dict]] = {}
    rcols: List[str] = list(rcols_hint or ())
    seen_cols = set(rcols)
    for rb in right_blocks:
        for rrow in BlockAccessor(rb).rows():
            if not isinstance(rrow, dict):
                raise ValueError(
                    "join() needs record rows (dicts) with the join "
                    f"column; got {type(rrow).__name__}")
            k = rrow[right_on]
            if hasattr(k, "item"):
                k = k.item()
            build.setdefault(k, []).append(rrow)
            for c in rrow:
                if c not in seen_cols:
                    seen_cols.add(c)
                    rcols.append(c)
    out: List[dict] = []
    for lrow in BlockAccessor(left_block).rows():
        if not isinstance(lrow, dict):
            raise ValueError(
                "join() needs record rows (dicts) with the join column; "
                f"got {type(lrow).__name__}")
        k = lrow[left_on]
        if hasattr(k, "item"):
            k = k.item()
        matches = build.get(k)
        if matches:
            for rrow in matches:
                out.append(_merge_row(lrow, rrow, left_on, right_on, rcols))
        elif how == "left":
            out.append(_merge_row(lrow, None, left_on, right_on, rcols))
    return out


def resolve_on(on) -> Tuple[str, str]:
    if isinstance(on, str):
        return on, on
    if (isinstance(on, (tuple, list)) and len(on) == 2
            and all(isinstance(c, str) for c in on)):
        return on[0], on[1]
    raise ValueError("join(on=...) takes a column name or a "
                     "(left_col, right_col) pair")


def join_datasets(left, right, on, how: str = "inner"):
    """Lazy distributed join of two Datasets; strategy (broadcast vs
    hash exchange) is chosen at iteration time from the build side's
    actual sealed bytes. `last_join_stats` on the result records the
    decision."""
    from ray_tpu_torch.data.dataset import _JoinDataset

    if how not in _HOW:
        raise ValueError(f"join(how=...) must be one of {_HOW}")
    left_on, right_on = resolve_on(on)
    return _JoinDataset(left, right, left_on, right_on, how)
