"""ray_tpu_torch.inference — continuous-batching LLM serving engine.

Counterpart of `ray_tpu.inference`: a paged KV-cache block manager and
radix prefix cache (`kv_cache`), LRU-resident LoRA adapter banks
(`adapters`) and an iteration-level scheduler that re-forms the batch every
decode step (`engine`). The Serve deployment `LLMServer` waits for the port
of the actor runtime and the Serve tier.

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
    "Request",
]
