"""Model-multiplexed engines of the port: LoRA banks on one engine.

As tests/test_multiplex.py, on the port's tiny Llama: N adapters share ONE
paged arena and one argument shape per program, each adapter's output is
token-identical to a dedicated single-adapter engine with the same
weights, the arena is adapter-invariant (a prefix cached under one adapter
serves every other one), and residency is LRU with pinned rows protected.
The last test holds the port's multiplexed engine against the JAX
package's, on one flax parameter tree (float32, token-exact).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_compiles_once
from gloo_ranks import fake_tp_mesh
from ray_tpu_torch.inference import (AdapterLoadError, AdapterManager,
                                     EngineConfig, InferenceEngine)
from ray_tpu_torch.models.llama import (Llama, LlamaConfig,
                                        make_adapter_weights, params_from_jax)

SEEDS = {"m-a": 11, "m-b": 22, "m-c": 33}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # Tiny shapes: one intra-op thread each, so parallel test workers do
    # not oversubscribe the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_model():
    return Llama(LlamaConfig.tiny(seq=256), device="cpu", seed=0)


def _source(cfg):
    def load(model_id):
        if model_id not in SEEDS:
            raise AdapterLoadError(f"unknown model {model_id!r}")
        return make_adapter_weights(cfg, rank=8, seed=SEEDS[model_id])
    return load


def _mux_engine(model, capacity=2):
    eng = InferenceEngine(EngineConfig(max_adapters=capacity, lora_rank=8),
                          model=model)
    eng.register_adapter_source(_source(model.config))
    return eng


def test_multiplexed_parity_and_one_shape_per_program(tiny_model):
    eng = _mux_engine(tiny_model)
    reqs = {
        "m-a": eng.add_request([1, 2, 3, 4, 5], 10, model_id="m-a"),
        "m-b": eng.add_request([1, 2, 3, 4, 5], 10, model_id="m-b"),
        None: eng.add_request([7, 8, 9], 8),
    }
    eng.run_until_idle()
    assert_compiles_once(eng.stats(), "prefill_compiles", "decode_compiles")
    eng.check_no_leaks()
    outs = {mid: list(r.generated) for mid, r in reqs.items()}
    assert outs["m-a"] != outs["m-b"]   # the adapters steer generation
    for mid in ("m-a", "m-b"):
        ded = _mux_engine(tiny_model, capacity=1)
        r = ded.add_request([1, 2, 3, 4, 5], 10, model_id=mid)
        ded.run_until_idle()
        assert list(r.generated) == outs[mid], mid
    plain = InferenceEngine(EngineConfig(), model=tiny_model)
    r = plain.add_request([7, 8, 9], 8)
    plain.run_until_idle()
    assert list(r.generated) == outs[None]


def test_lru_eviction_and_deterministic_reload(tiny_model):
    eng = _mux_engine(tiny_model, capacity=2)
    first = eng.add_request([1, 2, 3, 4, 5], 10, model_id="m-a")
    eng.add_request([9, 9], 4, model_id="m-b")
    eng.run_until_idle()
    baseline = list(first.generated)
    eng.add_request([1, 2], 4, model_id="m-c")
    eng.run_until_idle()
    st = eng.stats()["adapters"]
    assert st["resident"] == ["m-b", "m-c"]
    assert st["evictions"] == 1
    again = eng.add_request([1, 2, 3, 4, 5], 10, model_id="m-a")
    eng.run_until_idle()
    assert list(again.generated) == baseline
    assert_compiles_once(eng.stats(), "prefill_compiles", "decode_compiles")
    eng.check_no_leaks()


def test_pinned_rows_never_evicted(tiny_model):
    eng = _mux_engine(tiny_model, capacity=2)
    eng.add_request([1] * 40, 24, model_id="m-a")
    eng.add_request([2] * 40, 24, model_id="m-b")
    with pytest.raises((AdapterLoadError, ValueError), match="pinned"):
        eng.add_request([3, 3], 4, model_id="m-c")
    eng.run_until_idle()
    eng.check_no_leaks()
    eng.add_request([3, 3], 4, model_id="m-c")
    eng.run_until_idle()
    assert "m-c" in eng.stats()["adapters"]["resident"]


def test_unknown_model_rejected_at_submit(tiny_model):
    eng = _mux_engine(tiny_model)
    with pytest.raises(ValueError, match="unknown model"):
        eng.add_request([1, 2], 4, model_id="nope")
    plain = InferenceEngine(EngineConfig(), model=tiny_model)
    with pytest.raises(ValueError, match="not multiplexed"):
        plain.add_request([1, 2], 4, model_id="m-a")


def test_cross_adapter_prefix_hits_with_parity(tiny_model):
    eng = _mux_engine(tiny_model, capacity=3)
    prompt = list(range(1, 18))        # 17 tokens -> 16 ride the cache
    outs = {}
    for mid in ("m-a", "m-b", None):
        r = eng.add_request(prompt, 8, model_id=mid)
        eng.run_until_idle()
        outs[mid] = list(r.generated)
    st = eng.stats()
    assert st["prefix_cache"]["hits"] >= 2, st["prefix_cache"]
    assert_compiles_once(st, "prefill_compiles", "decode_compiles")
    eng.check_no_leaks()
    assert outs["m-a"] != outs["m-b"]
    for mid in ("m-a", "m-b"):
        cold = _mux_engine(tiny_model, capacity=1)
        r = cold.add_request(prompt, 8, model_id=mid)
        cold.run_until_idle()
        assert list(r.generated) == outs[mid], mid


def test_adapter_manager_banks_and_rows():
    cfg = LlamaConfig.tiny()
    mgr = AdapterManager(cfg, max_adapters=2, rank=8, device="cpu")
    load = _source(cfg)
    assert mgr.ensure("m-a", load) == 1 and mgr.ensure("m-b", load) == 2
    banks = mgr.device_banks()
    assert mgr.device_banks() is banks               # cached
    assert len(banks) == cfg.n_layer and banks[0][0].dtype == torch.bfloat16
    assert not banks[0][0][0].any()                  # row 0: the identity
    assert torch.equal(banks[0][0][1], load("m-a")[0][0])
    assert mgr.ensure("m-a", load) == 1 and mgr.hits == 1
    mgr.ensure("m-c", load, pinned_rows={1})          # evicts m-b, not m-a
    assert mgr.resident() == ["m-a", "m-c"]
    assert mgr.device_banks() is not banks           # dropped on change
    with pytest.raises(AdapterLoadError, match="pinned"):
        mgr.ensure("m-b", load, pinned_rows={1, 2})
    assert mgr.evict("m-c") and not mgr.evict("m-c")
    with pytest.raises(AdapterLoadError, match="rank mismatch"):
        mgr.ensure("bad", lambda _: make_adapter_weights(cfg, 4, 0))
    # The failed load leaked no row: both rows are free for new adapters.
    assert mgr.resident() == ["m-a"] and mgr.ensure("m-b", load) == 2
    # A tp that does not divide the KV heads (2 in tiny) is refused, as
    # the reference's `lora_bank_shardings` refuses it.
    with fake_tp_mesh(4) as mesh, pytest.raises(ValueError,
                                                match="n_kv_head"):
        AdapterManager(cfg, 1, 8, mesh=mesh, device="cpu")


def test_port_multiplexed_engine_emits_the_jax_engines_tokens():
    from ray_tpu.inference import EngineConfig as JaxEngineConfig
    from ray_tpu.inference import InferenceEngine as JaxInferenceEngine
    from ray_tpu.models import llama as jllama

    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(seq=256),
                               dtype=jnp.float32)
    jmodel = jllama.Llama(jcfg)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 8), jnp.int32)))()
    tmodel = Llama(dataclasses.replace(LlamaConfig.tiny(seq=256),
                                       dtype=torch.float32), device="cpu",
                   state=params_from_jax(jax.tree.map(
                       np.asarray, fnn.meta.unbox(params))))

    def jax_source(model_id):
        return jllama.make_adapter_weights(jcfg, rank=8,
                                           seed=SEEDS[model_id])

    kwargs = dict(max_adapters=2, lora_rank=8)
    jeng = JaxInferenceEngine(JaxEngineConfig(**kwargs), model=jmodel,
                              params=params)
    jeng.register_adapter_source(jax_source)
    teng = InferenceEngine(EngineConfig(**kwargs), model=tmodel)
    teng.register_adapter_source(_source(tmodel.config))
    outs = []
    for eng in (jeng, teng):
        reqs = [eng.add_request([1, 2, 3, 4, 5], 8, model_id=mid)
                for mid in ("m-a", "m-b", None)]
        eng.run_until_idle()
        eng.check_no_leaks()
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1]
    assert outs[1][0] != outs[1][1]
