"""Models of the PyTorch port (counterpart of `ray_tpu.models`)."""

from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config
from ray_tpu_torch.models.llama import Llama, LlamaConfig
from ray_tpu_torch.models.mlp import MLP
from ray_tpu_torch.models.moe import MoE, MoEConfig

__all__ = ["GPT2", "GPT2Config", "Llama", "LlamaConfig", "MLP",
           "MoE", "MoEConfig"]
