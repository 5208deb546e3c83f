"""Experimental utilities (reference `python/ray/experimental/`; the port's
counterpart of `ray_tpu/experimental/`)."""

from ray_tpu_torch.experimental import internal_kv, tqdm_ray
from ray_tpu_torch.experimental.dynamic_resources import set_resource

__all__ = ["internal_kv", "set_resource", "tqdm_ray"]
