"""GPU accelerator registry and node shapes.

The port's counterpart of `ray_tpu/util/accelerators.py`, which holds the
TPU generations and pod-slice topology. Here a generation is a GPU model
(name, compute capability, memory, SMs, cards per host of the usual node)
and a node shape names a group of whole hosts by generation and card
count: "h100-16" is 16 H100s, two hosts of 8. The slice helpers map one to
one: `parse_shape` (`parse_slice`), `shape_gpu_count` (`slice_chip_count`),
`shape_host_count` (`slice_host_count`) and `shape_bundles`
(`slice_bundles`), whose bundles are `{"CPU": c, "GPU": n}`, one a host.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# Accelerator type constants (custom resource names), as the reference's.
NVIDIA_TESLA_V100 = "V100"
NVIDIA_TESLA_T4 = "T4"
NVIDIA_TESLA_A100 = "A100"
NVIDIA_A10G = "A10G"
NVIDIA_H100 = "H100"


@dataclass(frozen=True)
class GpuGeneration:
    name: str
    # The type constant, as `nvidia-smi --query-gpu=name` spells it.
    accelerator_type: str
    compute_capability: Tuple[int, int]
    memory_gb: float
    sms: int
    # Cards per host of the usual node (DGX for V100/A100/H100, the cloud
    # instances that carry T4 and A10G).
    gpus_per_host: int


GPU_GENERATIONS: Dict[str, GpuGeneration] = {
    "v100": GpuGeneration("v100", NVIDIA_TESLA_V100, (7, 0), 32, 80, 8),
    "t4": GpuGeneration("t4", NVIDIA_TESLA_T4, (7, 5), 16, 40, 4),
    "a100": GpuGeneration("a100", NVIDIA_TESLA_A100, (8, 0), 80, 108, 8),
    "a10g": GpuGeneration("a10g", NVIDIA_A10G, (8, 6), 24, 80, 4),
    "h100": GpuGeneration("h100", NVIDIA_H100, (9, 0), 80, 132, 8),
}


def parse_shape(shape: str) -> Tuple[str, int]:
    """'h100-16' -> ('h100', 16 cards). A shape larger than one host must
    fill whole hosts."""
    gen, _, count = shape.lower().rpartition("-")
    if gen not in GPU_GENERATIONS:
        raise ValueError(f"Unknown GPU generation in '{shape}'")
    try:
        n = int(count)
    except ValueError:
        raise ValueError(f"No card count in '{shape}'") from None
    per_host = GPU_GENERATIONS[gen].gpus_per_host
    if n < 1 or (n > per_host and n % per_host):
        raise ValueError(f"'{shape}': {n} cards do not fill whole hosts of "
                         f"{per_host}")
    return gen, n


def shape_gpu_count(shape: str) -> int:
    return parse_shape(shape)[1]


def shape_host_count(shape: str) -> int:
    gen, n = parse_shape(shape)
    return max(1, n // GPU_GENERATIONS[gen].gpus_per_host)


def shape_bundles(shape: str, cpus_per_host: float = 1.0
                  ) -> List[Dict[str, float]]:
    """Placement-group bundles for one node shape: one bundle per host.

    Feed to `placement_group(..., strategy='STRICT_SPREAD')` so each bundle
    lands on a distinct host, one training worker per host holding all of
    its cards."""
    gen, n = parse_shape(shape)
    cards = min(GPU_GENERATIONS[gen].gpus_per_host, n)
    return [{"CPU": cpus_per_host, "GPU": float(cards)}
            for _ in range(shape_host_count(shape))]


def generation_of(device_name: str) -> Optional[str]:
    """The generation whose type constant is a word of `device_name`
    ("NVIDIA H100 80GB HBM3" -> "h100", "Tesla T4" -> "t4"), else None."""
    words = "".join(c if c.isalnum() else " "
                    for c in device_name.upper()).split()
    for gen in GPU_GENERATIONS.values():
        if gen.accelerator_type in words:
            return gen.name
    return None


def detect_local_generation(nvidia_smi: str = "nvidia-smi") -> Optional[str]:
    """Best-effort generation of this host's first card, from
    `nvidia-smi --query-gpu=name` (neither torch nor CUDA is touched);
    None where there is no card, no nvidia-smi or an unknown model."""
    try:
        out = subprocess.run(
            [nvidia_smi, "--query-gpu=name", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    names = out.stdout.strip().splitlines() if out.returncode == 0 else []
    return generation_of(names[0]) if names else None
