"""ray_tpu_torch.inference — continuous-batching LLM serving engine.

Counterpart of `ray_tpu.inference`: a paged KV-cache block manager and
radix prefix cache (`kv_cache`), LRU-resident LoRA adapter banks
(`adapters`) and an iteration-level scheduler that re-forms the batch every
decode step (`engine`). `LLMServer` (`inference/api.py`) is the Serve
deployment over the engine; it is imported lazily, so the engine core loads
without the serving stack.

    from ray_tpu_torch.inference import EngineConfig, InferenceEngine
    engine = InferenceEngine(EngineConfig(model_size="7b", batch_slots=8))
    req = engine.add_request([1, 2, 3], max_new_tokens=16)
    engine.run_until_idle()
"""

from ray_tpu_torch.inference.adapters import AdapterLoadError, AdapterManager
from ray_tpu_torch.inference.engine import (
    EngineConfig,
    EngineLoop,
    InferenceEngine,
    Request,
)
from ray_tpu_torch.inference.kv_cache import BlockManager

__all__ = [
    "AdapterLoadError",
    "AdapterManager",
    "BlockManager",
    "EngineConfig",
    "EngineLoop",
    "InferenceEngine",
    "LLMServer",
    "Request",
]


def __getattr__(name):
    # LLMServer pulls in ray_tpu_torch.serve; keep the core engine
    # importable without the serving stack (and without a cluster).
    if name == "LLMServer":
        from ray_tpu_torch.inference.api import LLMServer

        return LLMServer
    raise AttributeError(name)
