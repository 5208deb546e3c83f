"""Native helpers: lazily-compiled C data plane with pure-Python fallback.

The shared library is built at first use from `fastcopy.c` with the
system C compiler (no Python headers, no pybind11) into the checkout's
`build/ray_tpu_torch/native/` (under a temporary name, then renamed, so a
concurrent loader sees all of it or nothing) and loaded via ctypes —
foreign calls release the GIL, so large copies overlap with other Python
work and with each other. Every entry point falls back to a numpy copy
when no compiler is available, so the framework never *requires* the
native path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional, Union

import numpy as np

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

Buffer = Union[bytes, bytearray, memoryview]


def _build_and_load() -> Optional[ctypes.CDLL]:
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fastcopy.c")
    checkout = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cache_dir = os.environ.get("RAY_TPU_TORCH_NATIVE_CACHE") or os.path.join(
        checkout, "build", "ray_tpu_torch", "native")
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, "fastcopy.so")
    if not os.path.exists(so_path) or \
            os.path.getmtime(so_path) < os.path.getmtime(src):
        for cc in ("cc", "gcc", "clang"):
            try:
                tmp = so_path + f".tmp{os.getpid()}"
                subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", "-pthread", src,
                     "-o", tmp],
                    check=True, capture_output=True, timeout=60)
                os.replace(tmp, so_path)
                break
            except (FileNotFoundError, subprocess.SubprocessError):
                continue
        else:
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    lib.rtpu_gather_copy.restype = ctypes.c_size_t
    lib.rtpu_gather_copy.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
    lib.rtpu_gather_copy_mt.restype = ctypes.c_size_t
    lib.rtpu_gather_copy_mt.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int, ctypes.c_int]
    lib.rtpu_copy_at.restype = None
    lib.rtpu_copy_at.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_char_p, ctypes.c_size_t]
    lib.rtpu_prefault.restype = None
    lib.rtpu_prefault.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if not _tried:
            try:
                _lib = _build_and_load()
            except Exception:  # noqa: BLE001 — never block on native
                logger.debug("native fastcopy unavailable", exc_info=True)
                _lib = None
            _tried = True
            if _lib is not None:
                logger.debug("native fastcopy loaded")
    return _lib


def _addr_len(part: Buffer):
    """(address, nbytes, keepalive) of a contiguous buffer, zero-copy.

    numpy's frombuffer works for read-only sources (bytes, r/o
    memoryviews) where ctypes.from_buffer would refuse; we only need the
    address — writes happen in C against writable destinations."""
    mv = part if isinstance(part, memoryview) else memoryview(part)
    if not mv.contiguous:
        mv = memoryview(bytes(mv))
    arr = np.frombuffer(mv, dtype=np.uint8)
    if arr.nbytes == 0:
        return None, 0, arr
    return arr.ctypes.data, arr.nbytes, arr


_MT_THRESHOLD = 8 * 1024 * 1024  # below this, thread spawn overhead dominates
_MT_SLICE = 8 * 1024 * 1024      # target bytes per copy thread


def _copy_threads(total: int) -> int:
    cpus = os.cpu_count() or 1
    return max(1, min(16, cpus, total // _MT_SLICE))


def gather_copy(dst: memoryview, parts: List[Buffer]) -> int:
    """Copy `parts` back-to-back into `dst` (a writable buffer). Returns
    bytes written. Uses the native library when available (GIL released;
    large copies pre-fault the destination and split across threads —
    fresh tmpfs segments are page-fault bound otherwise), else a numpy
    byte-view copy (still memcpy-speed, GIL held)."""
    lib = get_lib()
    if lib is not None:
        n = len(parts)
        srcs = (ctypes.c_char_p * n)()
        lens = (ctypes.c_size_t * n)()
        keepalive = []
        total = 0
        for i, p in enumerate(parts):
            addr, ln, hold = _addr_len(p)
            keepalive.append(hold)
            srcs[i] = ctypes.cast(addr, ctypes.c_char_p) if addr else None
            lens[i] = ln
            total += ln
        dst_addr, dst_len, dst_hold = _addr_len(dst)
        if dst_len >= total and total > 0:
            cdst = ctypes.cast(dst_addr, ctypes.c_char_p)
            if total >= _MT_THRESHOLD:
                return lib.rtpu_gather_copy_mt(cdst, srcs, lens, n,
                                               _copy_threads(total))
            return lib.rtpu_gather_copy(cdst, srcs, lens, n)
        if total == 0:
            return 0
    # No compiler on this host: ctypes.memmove still releases the GIL, so
    # large copies split across threads parallelize page faulting and
    # memcpy bandwidth just like the native MT path. Raw-pointer writes
    # demand the same capacity guard the native path applies; an
    # undersized dst falls through to numpy's bounds-checked copy.
    total = sum(p.nbytes if isinstance(p, memoryview) else len(p)
                for p in parts)
    if (total >= _MT_THRESHOLD and _copy_threads(total) > 1
            and memoryview(dst).nbytes >= total):
        return _memmove_gather_mt(dst, parts, total)
    # Fallback: numpy byte views (fast path vs raw memoryview assignment).
    out = np.frombuffer(dst, dtype=np.uint8)
    pos = 0
    for p in parts:
        src = np.frombuffer(
            p if not isinstance(p, memoryview) else p.cast("B"),
            dtype=np.uint8)
        out[pos: pos + len(src)] = src
        pos += len(src)
    return pos


_mm_pool = None


def _memmove_pool():
    global _mm_pool
    if _mm_pool is None:
        import concurrent.futures

        with _lock:
            if _mm_pool is None:
                _mm_pool = concurrent.futures.ThreadPoolExecutor(
                    min(16, os.cpu_count() or 1),
                    thread_name_prefix="fastcopy-mm")
    return _mm_pool


def _memmove_gather_mt(dst: memoryview, parts: List[Buffer],
                       total: int) -> int:
    """Compiler-free multithreaded gather: one ctypes.memmove (GIL
    released) per [thread x part] sub-range."""
    d_addr, d_len, d_hold = _addr_len(dst)
    spans = []  # (dst_offset, src_addr, nbytes) per part
    pos = 0
    keep = []
    for p in parts:
        addr, ln, hold = _addr_len(p)
        keep.append(hold)
        if ln:
            spans.append((pos, addr, ln))
        pos += ln
    nthreads = _copy_threads(total)
    chunk = (total + nthreads - 1) // nthreads
    chunk = (chunk + 4095) & ~4095  # page-align slice bounds

    def run(begin: int, end: int):
        for off, s_addr, ln in spans:
            lo, hi = max(begin, off), min(end, off + ln)
            if lo < hi:
                ctypes.memmove(d_addr + lo, s_addr + (lo - off), hi - lo)

    list(_memmove_pool().map(
        lambda i: run(i * chunk, min((i + 1) * chunk, total)),
        range((total + chunk - 1) // chunk)))
    return total


def copy_at(dst: memoryview, offset: int, src: Buffer) -> None:
    """dst[offset:offset+len(src)] = src at memcpy speed."""
    lib = get_lib()
    if lib is not None:
        s_addr, s_len, s_hold = _addr_len(src)
        d_addr, d_len, d_hold = _addr_len(dst)
        if s_len and d_len >= offset + s_len:
            lib.rtpu_copy_at(ctypes.cast(d_addr, ctypes.c_char_p), offset,
                             ctypes.cast(s_addr, ctypes.c_char_p), s_len)
            return
        if not s_len:
            return
    view = np.frombuffer(dst, dtype=np.uint8)
    srcv = np.frombuffer(
        src if not isinstance(src, memoryview) else src.cast("B"),
        dtype=np.uint8)
    view[offset: offset + len(srcv)] = srcv
