"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside `ray_tpu/`: it imports torch, never jax, and
nothing of `ray_tpu`. Its entry points run on the CUDA card unless the
caller passes `device="cpu"`.
"""

from ray_tpu_torch._torch_env import resolve_device

__all__ = ["resolve_device"]
