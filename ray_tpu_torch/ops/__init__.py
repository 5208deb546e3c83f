"""Kernels of the PyTorch port (counterpart of `ray_tpu.ops`)."""

from ray_tpu_torch.ops.attention import flash_attention, mha_reference
from ray_tpu_torch.ops.ring_attention import ring_attention

__all__ = ["flash_attention", "mha_reference", "ring_attention"]
