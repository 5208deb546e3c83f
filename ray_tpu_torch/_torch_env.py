"""Device selection and numerics settings for the PyTorch port.

Counterpart of `ray_tpu/_jax_env.py`. Every entry point of the port runs on
the CUDA card unless its caller asks for the CPU with `device="cpu"`; it
never drops to the CPU on its own.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

# Where the CUDA kernels are compiled to, at first use (listed in .gitignore).
KERNEL_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
    "ray_tpu_torch")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`cuda` by default; the CPU only when asked for.

    Raises when the card is wanted and CUDA is not available. On the card,
    float32 matrix products and convolutions are pinned to full float32
    (no TF32), so float32 comparisons there mean what they say."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def same_device(asked: torch.device, actual: torch.device) -> bool:
    """Whether a tensor on `actual` lies on `asked` (`cuda` matches any card,
    `cuda:1` only the second)."""
    return asked.type == actual.type and asked.index in (None, actual.index)
