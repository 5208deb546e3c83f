"""Build and load the port's CUDA kernels.

Each source under `ray_tpu_torch/csrc/` is compiled by `nvcc` for `sm_90a`
into a shared library with a plain C interface and loaded with `ctypes`.
The libraries link against the CUDA runtime only: libcuda's
`cuTensorMapEncodeTiled`, which the bf16 kernels need for their TMA maps, is
fetched at run time through `cudaGetDriverEntryPoint`, so no `-lcuda`.
Libraries are named by a hash of their sources and flags, so an edited
source is rebuilt and an unchanged one is loaded from the build directory.
All sources are compiled together, one `nvcc` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

from ray_tpu_torch._torch_env import KERNEL_BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
SOURCES = ("flash_fwd.cu", "flash_bwd.cu")
HEADERS = ("flash_common.cuh",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures, as declared in the sources.
SIGNATURES = {
    "flash_fwd.cu": {
        "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
        "flash_fwd_smem": [_I, _I],
    },
    "flash_bwd.cu": {
        "flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _F, _I, _P],
        "flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _F, _I, _P],
        "flash_bwd_smem": [_I, _I, _I],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def _lib_path(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(KERNEL_BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all at once. Returns
    {source: compiler log}; raises with the log when a build fails."""
    os.makedirs(KERNEL_BUILD_DIR, exist_ok=True)
    procs = []
    for src in SOURCES:
        out = _lib_path(src)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for src, out, tmp, proc in procs:
        logs[src] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        else:
            failed.append(src)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[s] for s in failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = _lib_path(source)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            for fn, argtypes in SIGNATURES[source].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.flash_error_string.argtypes = [ctypes.c_int]
            lib.flash_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


def check(lib: ctypes.CDLL, fn: str, code: int) -> None:
    """Raise when a C entry point returned an error: CUDA's, or one of the
    sources' own codes (an unsupported shape, a refused tensor map)."""
    if code != 0:
        msg = lib.flash_error_string(code).decode()
        raise RuntimeError(f"{fn} failed with error {code}: {msg}")
