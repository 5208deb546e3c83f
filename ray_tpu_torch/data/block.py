"""Block model: the unit of distributed data.

Equivalent of the reference's block layer (`python/ray/data/block.py`,
`_internal/{arrow_block,pandas_block}.py`) collapsed into one accessor.
A block travels through the object store and is one of:

  - list of rows (simple block)
  - dict[str, np.ndarray] (column batch — the format that goes to the card
    as `torch.from_numpy(...).to(device)` without conversion)
  - pandas.DataFrame
  - pyarrow.Table

The accessor normalizes between representations; batches handed to
`map_batches`/`iter_batches` default to the numpy-dict format.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

Block = Any  # list | dict[str, np.ndarray] | pd.DataFrame | pa.Table


@dataclass
class BlockMetadata:
    num_rows: int
    size_bytes: int
    schema: Optional[Any] = None
    input_files: Optional[List[str]] = None


def _is_batch_dict(block: Any) -> bool:
    return isinstance(block, dict) and all(
        isinstance(v, np.ndarray) for v in block.values())


class BlockAccessor:
    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # ------------------------------------------------------------- properties

    def num_rows(self) -> int:
        b = self._block
        if isinstance(b, list):
            return len(b)
        if _is_batch_dict(b):
            return len(next(iter(b.values()))) if b else 0
        try:
            import pyarrow as pa

            if isinstance(b, pa.Table):
                return b.num_rows
        except ImportError:
            pass
        if hasattr(b, "shape"):  # DataFrame / ndarray
            return int(b.shape[0])
        raise TypeError(f"unknown block type {type(b)}")

    def size_bytes(self) -> int:
        b = self._block
        if isinstance(b, list):
            import sys

            return sum(sys.getsizeof(r) for r in b[:100]) * max(1, len(b) // 100) \
                if b else 0
        if _is_batch_dict(b):
            return sum(v.nbytes for v in b.values())
        try:
            import pyarrow as pa

            if isinstance(b, pa.Table):
                return b.nbytes
        except ImportError:
            pass
        if hasattr(b, "memory_usage"):
            return int(b.memory_usage(deep=True).sum())
        if hasattr(b, "nbytes"):
            return int(b.nbytes)
        return 0

    def schema(self) -> Any:
        b = self._block
        if isinstance(b, list):
            return type(b[0]).__name__ if b else None
        if _is_batch_dict(b):
            return {k: str(v.dtype) for k, v in b.items()}
        try:
            import pyarrow as pa

            if isinstance(b, pa.Table):
                return b.schema
        except ImportError:
            pass
        if hasattr(b, "dtypes"):
            return dict(b.dtypes.astype(str))
        return None

    def metadata(self, input_files: Optional[List[str]] = None) -> BlockMetadata:
        return BlockMetadata(self.num_rows(), self.size_bytes(), self.schema(),
                             input_files)

    # ------------------------------------------------------------ conversions

    def rows(self) -> Iterator[Any]:
        b = self._block
        if isinstance(b, list):
            yield from b
        elif _is_batch_dict(b):
            keys = list(b)
            for i in range(self.num_rows()):
                yield {k: b[k][i] for k in keys}
        else:
            df = self.to_pandas()
            for _, row in df.iterrows():
                yield row.to_dict()

    def to_batch(self) -> Dict[str, np.ndarray]:
        """Numpy-dict view (the default batch format)."""
        b = self._block
        if _is_batch_dict(b):
            return b
        if isinstance(b, list):
            if b and isinstance(b[0], dict):
                keys = list(b[0])
                return {k: np.asarray([r[k] for r in b]) for k in keys}
            return {"item": np.asarray(b)}
        try:
            import pyarrow as pa

            if isinstance(b, pa.Table):
                return {name: b.column(name).to_numpy(zero_copy_only=False)
                        for name in b.column_names}
        except ImportError:
            pass
        if hasattr(b, "columns"):  # DataFrame
            return {c: b[c].to_numpy() for c in b.columns}
        raise TypeError(f"cannot batch block of type {type(b)}")

    def to_pandas(self):
        import pandas as pd

        b = self._block
        if hasattr(b, "columns") and hasattr(b, "dtypes"):
            return b
        try:
            import pyarrow as pa

            if isinstance(b, pa.Table):
                return b.to_pandas()
        except ImportError:
            pass
        if _is_batch_dict(b):
            return pd.DataFrame({k: list(v) if v.ndim > 1 else v
                                 for k, v in b.items()})
        if isinstance(b, list):
            if b and isinstance(b[0], dict):
                return pd.DataFrame(b)
            return pd.DataFrame({"item": b})
        raise TypeError(f"cannot convert block of type {type(b)}")

    def to_arrow(self):
        import pyarrow as pa

        b = self._block
        if isinstance(b, pa.Table):
            return b
        return pa.Table.from_pandas(self.to_pandas())

    # ------------------------------------------------------------- operations

    def slice(self, start: int, end: int) -> Block:
        b = self._block
        if isinstance(b, list):
            return b[start:end]
        if _is_batch_dict(b):
            return {k: v[start:end] for k, v in b.items()}
        try:
            import pyarrow as pa

            if isinstance(b, pa.Table):
                return b.slice(start, end - start)
        except ImportError:
            pass
        return b.iloc[start:end]

    def take(self, n: int) -> List[Any]:
        out = []
        for row in self.rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0] or blocks[:1]
        if not blocks:
            return []
        first = blocks[0]
        if isinstance(first, list):
            out: List[Any] = []
            for b in blocks:
                out.extend(b if isinstance(b, list)
                           else BlockAccessor(b).take(BlockAccessor(b).num_rows()))
            return out
        if _is_batch_dict(first):
            keys = list(first)
            return {k: np.concatenate([BlockAccessor(b).to_batch()[k]
                                       for b in blocks]) for k in keys}
        try:
            import pyarrow as pa

            if isinstance(first, pa.Table):
                return pa.concat_tables([BlockAccessor(b).to_arrow()
                                         for b in blocks])
        except ImportError:
            pass
        import pandas as pd

        return pd.concat([BlockAccessor(b).to_pandas() for b in blocks],
                         ignore_index=True)

    @staticmethod
    def batch_to_block(batch: Any) -> Block:
        """Normalize a user map_batches return value into a block."""
        if batch is None:
            return []
        if _is_batch_dict(batch) or isinstance(batch, list):
            return batch
        if isinstance(batch, dict):
            return {k: np.asarray(v) for k, v in batch.items()}
        if isinstance(batch, np.ndarray):
            return {"item": batch}
        return batch  # DataFrame / Table pass through
