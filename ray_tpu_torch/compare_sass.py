"""Compare the SASS of the port's kernels between two checkouts.

    python3 -m ray_tpu_torch.compare_sass OTHER_ROOT [--out DIR]

Compiles `ray_tpu_torch/csrc/*.cu` of this checkout and of OTHER_ROOT (e.g.
the parent commit unpacked with `git archive`) with the flags of
`ray_tpu_torch.ops._build`, disassembles every kernel with `cuobjdump
-sass`, and prints one JSON line: for each kernel, whether its
instructions are the same in both, with constant-bank offsets (the
kernel's parameter layout) set aside; for those that differ, whether
they hold the same instructions in another order, and else both
instruction counts and whether their opcodes are the same (registers
allocated otherwise); and the kernels that only one side has. Needs `nvcc` and `cuobjdump`; no card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List

from ray_tpu_torch.ops import _build


def _tool(name: str) -> str:
    path = shutil.which(name) or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found")
    return path


def sass(root: str, source: str, out_dir: str) -> Dict[str, List[str]]:
    """{mangled kernel name: its instructions} of one source of `root`."""
    lib = os.path.join(out_dir, os.path.splitext(source)[0] + ".so")
    subprocess.run([_tool("nvcc"), *_build.NVCC_FLAGS, "-o", lib,
                    os.path.join(root, "ray_tpu_torch", "csrc", source)],
                   check=True, capture_output=True, text=True)
    text = subprocess.run([_tool("cuobjdump"), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    kernels: Dict[str, List[str]] = {}
    body = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            body = kernels.setdefault(m[1], [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if body is not None and m:
            body.append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][_]",
                               m[1]))
    return kernels


def _opcodes(body: List[str]) -> List[str]:
    """The sorted opcodes of a kernel, predicates and operands dropped."""
    return sorted(re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
                  for ins in body)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", help="root of the checkout to compare with")
    parser.add_argument("--out", default=None,
                        help="directory for the libraries (default: temp)")
    args = parser.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = args.out or tempfile.mkdtemp(prefix="compare_sass_")
    result = {}
    for source in _build.SOURCES:
        dirs = [os.path.join(out, side) for side in ("this", "other")]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        this, other = (sass(root, source, d)
                       for root, d in zip((here, args.other), dirs))
        result[source] = {
            "same": sorted(k for k in this if other.get(k) == this[k]),
            "reordered": sorted(
                k for k in this if k in other and other[k] != this[k]
                and sorted(other[k]) == sorted(this[k])),
            "different": sorted(
                k for k in this if k in other
                and sorted(other[k]) != sorted(this[k])),
            "counts": {k: [len(this[k]), len(other[k])] for k in this
                       if k in other and sorted(other[k]) != sorted(this[k])},
            "same_opcodes": sorted(
                k for k in this if k in other
                and sorted(other[k]) != sorted(this[k])
                and _opcodes(other[k]) == _opcodes(this[k])),
            "only_this": sorted(set(this) - set(other)),
            "only_other": sorted(set(other) - set(this)),
        }
    print(json.dumps({"sass": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
