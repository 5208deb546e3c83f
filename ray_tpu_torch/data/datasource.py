"""Datasources: file readers/writers run inside read tasks.

Equivalent of the reference's `python/ray/data/datasource/*_datasource.py`
(parquet, csv, json, text, numpy, binary) + `file_based_datasource.py` path
expansion. Each reader returns one block per file chunk; the read happens in
the task, so bytes never flow through the driver. pandas and pyarrow are
imported where a reader or writer needs them; JSON lines go through the
standard `json` module, so `write_json`/`read_json` need neither.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


def expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                f for f in glob.glob(os.path.join(p, "**", "*"), recursive=True)
                if os.path.isfile(f) and not os.path.basename(f).startswith((".", "_"))))
        elif any(c in p for c in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"No input files found for {paths}")
    return out


# -------------------------------------------------------------- partitioning #


class Partitioning:
    """Path-based partitioning scheme (reference
    `python/ray/data/datasource/partitioning.py` Partitioning /
    PathPartitionParser).

    style="hive": `.../year=2024/country=de/part.parquet` -> columns
    {year: "2024", country: "de"}.
    style="dir": positional `field_names` map path directories under
    `base_dir` to columns: field_names=["year", "country"] parses
    `.../2024/de/part.parquet`.
    """

    def __init__(self, style: str = "hive",
                 base_dir: Optional[str] = None,
                 field_names: Optional[List[str]] = None):
        if style not in ("hive", "dir"):
            raise ValueError(f"unknown partitioning style {style!r}")
        if style == "dir" and not field_names:
            raise ValueError("style='dir' requires field_names")
        self.style = style
        self.base_dir = os.path.normpath(base_dir) if base_dir else None
        self.field_names = list(field_names or [])

    def parse(self, path: str) -> Dict[str, str]:
        """Partition column values encoded in `path` (empty when none)."""
        rel = os.path.dirname(os.path.abspath(path))
        if self.base_dir:
            base = os.path.abspath(self.base_dir)
            # Containment, not string prefix: /data/tbl_backup must not
            # read as inside /data/tbl.
            if rel != base and not rel.startswith(base + os.sep):
                return {}
            rel = rel[len(base):].lstrip(os.sep)
        parts = [p for p in rel.split(os.sep) if p]
        if self.style == "hive":
            out = {}
            for p in parts:
                if "=" in p:
                    k, _, v = p.partition("=")
                    out[k] = v
            return out
        # dir style: the LAST len(field_names) directories map by position.
        tail = parts[-len(self.field_names):]
        if len(tail) < len(self.field_names):
            return {}
        return dict(zip(self.field_names, tail))


def attach_partition_columns(block: Any, parts: Dict[str, str]) -> Any:
    """Append constant partition columns to a block (tabular blocks:
    pandas / arrow / dict-of-arrays / list-of-dict rows)."""
    if not parts:
        return block
    try:
        import pandas as pd

        if isinstance(block, pd.DataFrame):
            for k, v in parts.items():
                if k not in block.columns:
                    block[k] = v
            return block
    except ImportError:
        pass
    try:
        import pyarrow as pa

        if isinstance(block, pa.Table):
            n = block.num_rows
            for k, v in parts.items():
                if k not in block.column_names:
                    block = block.append_column(k, pa.array([v] * n))
            return block
    except ImportError:
        pass
    if isinstance(block, dict):
        n = len(next(iter(block.values()))) if block else 0
        for k, v in parts.items():
            block.setdefault(k, np.full(n, v, dtype=object))
        return block
    if isinstance(block, list) and block and isinstance(block[0], dict):
        for row in block:
            for k, v in parts.items():
                row.setdefault(k, v)
        return block
    return block


def partitioned_reader(reader, path: str,
                       partitioning: Optional[Partitioning], *args, **kw):
    """Wrap a per-file reader: parse the path's partition values and
    attach them as columns."""
    block = reader(path, *args, **kw)
    if partitioning is not None:
        block = attach_partition_columns(block, partitioning.parse(path))
    return block


# ------------------------------------------------------------------ readers #


def read_parquet_file(path: str, columns: Optional[List[str]] = None):
    import pyarrow.parquet as pq

    return pq.read_table(path, columns=columns)


def read_csv_file(path: str, **kw):
    import pandas as pd

    return pd.read_csv(path, **kw)


def read_json_file(path: str, lines: bool = True) -> List[Any]:
    """Rows of a JSON-lines file (or of one JSON array when `lines` is
    False), read with the standard `json` module: the reference reads
    through pandas, which a machine may lack."""
    with open(path, "r", encoding="utf-8") as f:
        if lines:
            return [json.loads(line) for line in f if line.strip()]
        data = json.load(f)
    return data if isinstance(data, list) else [data]


def _json_default(value):
    """numpy values in rows, as `json.dumps` takes them."""
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    raise TypeError(f"{type(value).__name__} is not JSON serializable")


def read_text_file(path: str, encoding: str = "utf-8",
                   drop_empty_lines: bool = True) -> List[str]:
    with open(path, "r", encoding=encoding) as f:
        lines = f.read().splitlines()
    return [l for l in lines if l or not drop_empty_lines]


def read_numpy_file(path: str) -> Dict[str, np.ndarray]:
    arr = np.load(path, allow_pickle=False)
    if isinstance(arr, np.lib.npyio.NpzFile):
        return {k: arr[k] for k in arr.files}
    return {"item": arr}


def read_binary_file(path: str, include_paths: bool = False):
    with open(path, "rb") as f:
        data = f.read()
    if include_paths:
        return [{"path": path, "bytes": data}]
    return [data]


# --------------------------------------------------------------- tfrecords #
# TFRecord framing (no TF dependency): each record is
#   [8B LE length][4B masked crc32c(length)][data][4B masked crc32c(data)]
# crc32c implemented table-driven (Castagnoli polynomial), mask per the
# TFRecord spec, so files round-trip with TensorFlow's readers.

_CRC32C_TABLE = None


def _crc32c(data: bytes) -> int:
    try:  # native implementations when present — the Python loop is slow
        import google_crc32c

        return int.from_bytes(google_crc32c.Checksum(data).digest(), "big")
    except ImportError:
        pass
    try:
        import crc32c as _c32

        return _c32.crc32c(data)
    except ImportError:
        pass
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def read_tfrecord_file(path: str, validate: bool = True) -> List[Dict[str, Any]]:
    import struct

    rows: List[Dict[str, Any]] = []
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                break
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            if validate and _masked_crc(header[:8]) != len_crc:
                raise ValueError(f"corrupt tfrecord length crc in {path}")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise ValueError(f"truncated tfrecord in {path}")
            (data_crc,) = struct.unpack("<I", footer)
            if validate and _masked_crc(data) != data_crc:
                raise ValueError(f"corrupt tfrecord data crc in {path}")
            rows.append({"data": data})
    return rows


def write_tfrecords(records, path: str) -> str:
    import struct

    with open(path, "wb") as f:
        for rec in records:
            data = rec["data"] if isinstance(rec, dict) else bytes(rec)
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
    return path


# --------------------------------------------------------------------- sql #


def read_sql_query(sql: str, connection_factory, params=()) -> Dict[str, np.ndarray]:
    """Run one query through a DB-API connection factory (reference
    `ray.data.read_sql`); returns a columnar block."""
    conn = connection_factory()
    try:
        cur = conn.cursor()
        cur.execute(sql, params)
        cols = [d[0] for d in cur.description]
        rows = cur.fetchall()
    finally:
        conn.close()
    if not rows:
        return {c: np.array([]) for c in cols}
    arrays = [np.array([r[i] for r in rows]) for i in range(len(cols))]
    return dict(zip(cols, arrays))


# ------------------------------------------------------------------- images #


def read_image_file(path: str, size=None, mode: Optional[str] = None
                    ) -> List[Dict[str, Any]]:
    """Decode one image to a numpy row (reference `ray.data.read_images`)."""
    from PIL import Image

    with Image.open(path) as img:
        if mode is not None:
            img = img.convert(mode)
        if size is not None:
            img = img.resize(tuple(size))
        arr = np.asarray(img)
    return [{"image": arr, "path": path}]


def read_webdataset_shard(path: str, decode: bool = True
                          ) -> List[Dict[str, Any]]:
    """One WebDataset tar shard -> sample rows (reference
    `python/ray/data/read_api.py` read_webdataset / the webdataset
    format: files sharing a basename stem form one sample; extensions
    become fields). Standard tarfile only — no webdataset dependency."""
    import io
    import json as _json
    import tarfile

    samples: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    with tarfile.open(path, "r:*") as tf:
        for member in tf:
            if not member.isfile():
                continue
            name = os.path.basename(member.name)
            if name.startswith("."):
                continue
            stem, _, ext = name.partition(".")
            raw = tf.extractfile(member).read()
            value: Any = raw
            if decode:
                if ext in ("txt", "text"):
                    value = raw.decode("utf-8", "replace")
                elif ext == "cls":
                    value = int(raw.decode().strip())
                elif ext == "json":
                    value = _json.loads(raw)
                elif ext in ("jpg", "jpeg", "png", "webp"):
                    try:
                        from PIL import Image

                        value = np.asarray(Image.open(io.BytesIO(raw)))
                    except Exception:  # noqa: BLE001 — no PIL: raw bytes
                        value = raw
            if stem not in samples:
                samples[stem] = {"__key__": stem}
                order.append(stem)
            samples[stem][ext] = value
    return [samples[k] for k in order]


def write_webdataset_shard(rows: List[Dict[str, Any]], path: str) -> str:
    """Rows ({'__key__': ..., ext: value}) -> one tar shard."""
    import io
    import json as _json
    import tarfile

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with tarfile.open(path, "w") as tf:
        for i, row in enumerate(rows):
            key = str(row.get("__key__", f"{i:08d}"))
            for ext, value in row.items():
                if ext == "__key__":
                    continue
                if isinstance(value, np.generic):
                    value = value.item()  # np scalar -> plain python
                if isinstance(value, bool):
                    value = int(value)  # .cls reads back via int()
                if isinstance(value, (bytes, bytearray)):
                    raw = bytes(value)
                elif isinstance(value, str):
                    raw = value.encode()
                elif isinstance(value, int):
                    raw = str(value).encode()
                else:
                    raw = _json.dumps(
                        value.tolist() if isinstance(value, np.ndarray)
                        else value).encode()
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(raw)
                tf.addfile(info, io.BytesIO(raw))
    return path


def read_mongo_collection(uri: str, database: str, collection: str,
                          pipeline=None) -> List[Dict[str, Any]]:
    """MongoDB collection -> rows (reference MongoDatasource). Requires
    pymongo (not bundled; a clear error gates it)."""
    try:
        import pymongo
    except ImportError as e:
        raise ImportError(
            "read_mongo requires the pymongo package, which is not "
            "installed in this environment") from e
    client = pymongo.MongoClient(uri)
    try:
        coll = client[database][collection]
        cursor = coll.aggregate(pipeline) if pipeline else coll.find()
        return [{k: v for k, v in doc.items()} for doc in cursor]
    finally:
        client.close()


def make_range_block(start: int, stop: int) -> Dict[str, np.ndarray]:
    return {"id": np.arange(start, stop, dtype=np.int64)}


def make_tensor_range_block(start: int, stop: int, shape) -> Dict[str, np.ndarray]:
    n = stop - start
    base = np.arange(start, stop, dtype=np.float64).reshape((n,) + (1,) * len(shape))
    return {"data": np.broadcast_to(base, (n,) + tuple(shape)).copy()}


# ------------------------------------------------------------------ writers #


def write_block(block: Any, path: str, index: int, fmt: str,
                kw: Dict[str, Any]) -> str:
    from ray_tpu_torch.data.block import BlockAccessor

    acc = BlockAccessor(block)
    out = os.path.join(path, f"part-{index:05d}.{fmt}")
    if fmt == "parquet":
        import pyarrow.parquet as pq

        pq.write_table(acc.to_arrow(), out)
    elif fmt == "csv":
        acc.to_pandas().to_csv(out, index=False)
    elif fmt == "json":
        # One JSON object a line, as pandas' records/lines writer emits
        # them; scalar rows become {"item": value}.
        with open(out, "w", encoding="utf-8") as f:
            for row in acc.rows():
                if not isinstance(row, dict):
                    row = {"item": row}
                f.write(json.dumps(row, default=_json_default) + "\n")
    elif fmt == "numpy":
        col = kw.get("column", "item")
        np.save(out, acc.to_batch()[col])
        out += ".npy"
    elif fmt == "webdataset":
        out = os.path.join(path, f"shard-{index:06d}.tar")
        write_webdataset_shard(list(acc.rows()), out)
    else:
        raise ValueError(f"unknown write format {fmt}")
    return out
