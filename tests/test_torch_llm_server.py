"""The port's `LLMServer`, the sampler deployments and `shardgroup` on the
CPU.

`LLMServer` runs a tiny Llama with `device="cpu"` in a Serve replica;
`generate`, `stream` and HTTP must give the ids of the port's
`InferenceEngine` driven directly on the same seed, token for token, and
the JAX package's `LLMServer` the same response and event structure for
the same payload (its tokens differ: its weights come from `PRNGKey(0)`;
the token parity of the two engines on carried weights is
tests/test_torch_inference.py's). Adapters route as tests/test_multiplex.py's
LLMServer case does. The samplers equal plain greedy loops over the
port's models. The shardgroup tests form real gangs: their ranks join one
gloo group.

One module-scoped port cluster; the deployments stay up for the module
(one `serve.shutdown()` at its end). Replicas run torch on one thread.
"""

import json
import time
import urllib.request

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve, shardgroup
from ray_tpu_torch.inference import EngineConfig, InferenceEngine, LLMServer
from ray_tpu_torch.models.llama import (Llama, LlamaConfig,
                                        make_adapter_weights)

ENGINE = {"batch_slots": 2, "block_size": 8, "num_blocks": 32,
          "max_blocks_per_seq": 8, "prefill_chunk": 8}
ONE_THREAD = {"runtime_env": {"env_vars": {"OMP_NUM_THREADS": "1"}}}
PROMPT = [1, 2, 3, 4, 5]
SEEDS = {"m-a": 11, "m-b": 22}


@pytest.fixture(scope="module", autouse=True)
def cluster():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ray_tpu_torch.init(num_cpus=8)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_llm():
    """The JAX package's LLMServer on a cluster of its own (its replica
    compiles the tiny model's programs at start)."""
    import ray_tpu
    from ray_tpu import serve as jserve
    from ray_tpu.inference import LLMServer as JaxLLMServer

    ray_tpu.init(num_cpus=2)
    try:
        yield jserve.run(JaxLLMServer.options(num_replicas=1).bind(
            "tiny", 128, 6, engine_config=ENGINE), timeout_s=120)
    finally:
        try:
            jserve.shutdown()
        finally:
            ray_tpu.shutdown()


@pytest.fixture(scope="module")
def llm():
    return serve.run(LLMServer.options(
        num_replicas=1, ray_actor_options=ONE_THREAD).bind(
            "tiny", 128, 6, engine_config=ENGINE, device="cpu"),
        timeout_s=120)


def _post(port, path, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return [json.loads(line) for line in resp.read().splitlines()
                if line.strip()]


def _direct(prompt, n, **engine):
    """The port's engine driven directly, same config and seed."""
    eng = InferenceEngine(EngineConfig(model_size="tiny", max_model_len=128,
                                       **dict(ENGINE, **engine)),
                          device="cpu")
    req = eng.add_request(prompt, max_new_tokens=n)
    eng.run_until_idle()
    return list(req.prompt) + list(req.generated)


def test_llm_server_generate_stream_and_http_equal_the_engine(llm):
    # test_inference.py::test_llm_server_generate_and_stream_through_serve
    # and ::test_llm_server_streams_over_http
    want = _direct(PROMPT, 6)
    out = ray_tpu_torch.get(llm.generate.remote(
        {"ids": PROMPT, "max_new_tokens": 6}))
    assert out == {"ids": want}
    assert all(type(t) is int for t in out["ids"])
    events = list(llm.options(stream=True).stream.remote(
        {"ids": PROMPT, "max_new_tokens": 6}))
    assert [e["token"] for e in events[:-1]] == want[len(PROMPT):]
    assert events[-1] == {"done": True, "ids": want}
    port = serve.http_port()
    assert _post(port, "/LLMServer", {"ids": PROMPT, "max_new_tokens": 6}) \
        == [{"result": {"ids": want}}]
    lines = _post(port, "/LLMServer", {"ids": PROMPT, "max_new_tokens": 6,
                                       "stream": True})
    assert lines == events
    m = ray_tpu_torch.get(llm.metrics.remote(None))
    assert m["requests_finished"] >= 4 and m["decode_compiles"] == 1
    assert m["kv"]["blocks_in_use"] == m["prefix_cache"]["cached_blocks"]
    stats = ray_tpu_torch.get(ray_tpu_torch.get_actor(
        "SERVE_REPLICA::LLMServer#0", namespace="serve").stats.remote())
    assert {"queue_depth", "running", "tokens_per_sec",
            "prefix_hit_rate"} <= set(stats["user"])


def test_llm_server_answers_like_the_reference(llm, jax_llm):
    # The JAX package's LLMServer on the same payload: the same keys, the
    # same number of ids and events, the prompt first.
    import ray_tpu

    payload = {"ids": PROMPT, "max_new_tokens": 3}
    answers = {"jax": ray_tpu.get(jax_llm.generate.remote(payload)),
               "port": ray_tpu_torch.get(llm.generate.remote(payload))}
    streams = {"jax": list(jax_llm.options(stream=True).stream.remote(
                   payload)),
               "port": list(llm.options(stream=True).stream.remote(
                   payload))}
    for out in answers.values():
        assert set(out) == {"ids"} and len(out["ids"]) == 8
        assert out["ids"][:5] == PROMPT
    for name, events in streams.items():
        assert [set(e) for e in events] == [{"token"}] * 3 + [
            {"done", "ids"}], name
        assert events[-1]["ids"] == answers[name]["ids"]


def test_llm_server_adapters_route_like_the_reference():
    # test_multiplex.py::test_multiplexed_llmserver_http_and_affinity; each
    # adapter's tokens also equal the engine driven directly with the
    # same adapter weights.
    from ray_tpu_torch.serve.handle import _process_router

    adapters = {m: {"seed": s, "rank": 8} for m, s in SEEDS.items()}
    serve.run(LLMServer.options(
        name="zoo_llm", num_replicas=1, max_concurrent_queries=16,
        ray_actor_options=ONE_THREAD).bind(
            "tiny", 128, 6, None, adapters, device="cpu"), timeout_s=120)
    port = serve.http_port()
    outs = {m: _post(port, f"/zoo_llm?model_id={m}",
                     {"ids": PROMPT, "max_new_tokens": 6,
                      "model_id": m})[0]["result"]
            for m in SEEDS}
    assert outs["m-a"]["ids"] != outs["m-b"]["ids"]
    assert outs["m-a"] == _post(port, "/zoo_llm?model_id=m-a",
                                {"ids": PROMPT, "max_new_tokens": 6,
                                 "model_id": "m-a"})[0]["result"]
    model = Llama(LlamaConfig.tiny(seq=128), device="cpu", seed=0)
    for m, seed in SEEDS.items():
        eng = InferenceEngine(EngineConfig(max_adapters=2, lora_rank=8),
                              model=model)
        eng.register_adapter_source(lambda mid, s=seed: make_adapter_weights(
            model.config, rank=8, seed=s))
        req = eng.add_request(PROMPT, 6, model_id=m)
        eng.run_until_idle()
        assert outs[m]["ids"] == PROMPT + list(req.generated), m
    router = _process_router()
    router._ensure_started()
    deadline = time.time() + 20
    entry = None
    while time.time() < deadline:
        entry = router.entry_snapshot("zoo_llm")
        resident = next(iter((entry or {}).get("adapters", {}).values()),
                        [])
        if "m-a" in resident and "m-b" in resident:
            break
        time.sleep(0.25)
    assert entry and entry.get("mux"), entry
    rid = next(iter(entry["adapters"]))
    choice = router._pick(entry, model_id="m-a")
    assert choice is not None and choice[0] == rid


def test_serving_without_a_card_or_cpu_raises(monkeypatch):
    # No GPU grant and no device="cpu": the replica refuses to serve (it
    # never drops to the CPU on its own). A CPU replica sees
    # CUDA_VISIBLE_DEVICES="".
    from ray_tpu_torch._torch_env import replica_device
    from ray_tpu_torch.serve.examples import GPT2Sampler, LlamaSampler

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    for make in (lambda: LLMServer._target("tiny", 128, 6,
                                           engine_config=ENGINE),
                 lambda: GPT2Sampler._target("tiny", 64, 4),
                 lambda: LlamaSampler._target("tiny", 64, 4),
                 replica_device):
        with pytest.raises(RuntimeError, match="num_gpus"):
            make()
    assert replica_device("cpu") == torch.device("cpu")


def _greedy(model, prompt, n):
    """Plain greedy decoding: n full forwards of the growing sequence."""
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = model(torch.tensor([ids]))
            ids.append(int(logits[0, -1].argmax()))
    return ids


def test_gpt2_sampler_batches_and_equals_the_greedy_loop():
    # test_serve.py::test_gpt2_sampler_deployment_batches
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from ray_tpu_torch.serve.examples import GPT2Sampler

    handle = serve.run(GPT2Sampler.options(
        ray_actor_options=ONE_THREAD).bind("tiny", 64, 4, device="cpu"),
        timeout_s=120)
    prompts = [[1, 2, 3 + i] for i in range(8)]
    outs = ray_tpu_torch.get([handle.remote({"ids": p, "max_new_tokens": 4})
                              for p in prompts])
    m = ray_tpu_torch.get(handle.metrics.remote(None))
    assert m["batches_served"] >= 1
    assert m["mean_batch_size"] > 1.0, "batching never engaged"
    model = GPT2(GPT2Config.tiny(seq=64), device="cpu", seed=0).eval()
    assert [o["ids"] for o in outs] == [_greedy(model, p, 4)
                                        for p in prompts]


def test_llama_sampler_equals_the_greedy_loop():
    from ray_tpu_torch.serve.examples import LlamaSampler

    handle = serve.run(LlamaSampler.options(
        ray_actor_options=ONE_THREAD).bind("tiny", 64, 4, device="cpu"),
        timeout_s=120)
    prompts = [[5, 6, 7, 8 + i, 9][: 3 + i % 3] for i in range(4)]
    outs = ray_tpu_torch.get([handle.remote({"ids": p, "max_new_tokens": 4})
                              for p in prompts])
    model = Llama(LlamaConfig.tiny(seq=64), device="cpu", seed=0)
    assert [o["ids"] for o in outs] == [_greedy(model, p, 4)
                                        for p in prompts]


# ---------------------------------------------------------------- shardgroup


class _Rank:
    """A gang rank that answers with its view of the process group."""

    def __call__(self, payload):
        return payload

    def world(self):
        import torch.distributed as dist

        ones = torch.ones(1) * (dist.get_rank() + 1)
        dist.all_reduce(ones)
        ctx = shardgroup.current()
        return (ctx.rank, dist.get_rank(), dist.get_world_size(),
                int(ones.item()), dist.get_backend(), shardgroup.current_mesh())


class _FailingRank:
    """Deployment whose rank 2 explodes in its ctor."""

    def __init__(self):
        ctx = shardgroup.current()
        if ctx is not None and ctx.rank == 2:
            raise RuntimeError("rank 2 exploded in ctor")

    def __call__(self, payload):
        return payload


def test_gang_creation_and_rendezvous():
    # The ranks meet over the GCS KV and join one gloo group (no card).
    group = shardgroup.create_replica_group(
        _Rank, shardgroup.ShardSpec(tp=1, world_size=2),
        deployment_name="rdv", actor_options=ONE_THREAD)
    try:
        views = ray_tpu_torch.get([r.handle_request.remote("world", (), {})
                                   for r in group.ranks], timeout=60)
        assert views == [(0, 0, 2, 3, "gloo", None),
                         (1, 1, 2, 3, "gloo", None)]
        assert ray_tpu_torch.get(group.handle.handle_request.remote(
            "__call__", ("hi",), {})) == "hi"
    finally:
        group.kill()


def _settled_cpus() -> float:
    """Available CPUs once an earlier test's teardown has returned its
    bundles (two reads 0.3 s apart agree)."""
    last = None
    for _ in range(30):
        now = ray_tpu_torch.available_resources().get("CPU", 0)
        if last is not None and abs(now - last) < 0.01:
            return now
        last = now
        time.sleep(0.3)
    return last


def test_gang_all_or_nothing_abort():
    # test_shardgroup.py::test_gang_all_or_nothing_abort (3 ranks)
    before = _settled_cpus()
    with pytest.raises(shardgroup.GangError) as err:
        shardgroup.create_replica_group(
            _FailingRank, shardgroup.ShardSpec(tp=1, world_size=3),
            deployment_name="failgang",
            actor_options=dict(ONE_THREAD, num_cpus=0.5), ready_timeout_s=60)
    assert err.value.rank == 2 and "rank 2" in str(err.value)
    deadline = time.time() + 10
    while time.time() < deadline:
        if abs(ray_tpu_torch.available_resources().get("CPU", 0)
               - before) < 0.01:
            break
        time.sleep(0.1)
    assert abs(ray_tpu_torch.available_resources().get("CPU", 0)
               - before) < 0.01
    for rank in range(3):
        with pytest.raises(Exception):
            ray_tpu_torch.get_actor(
                f"SHARDGROUP::{err.value.group_id}#r{rank}")


def test_gang_bundle_overflow_fails_fast():
    # test_shardgroup.py::test_gang_bundle_overflow_fails_fast
    t0 = time.time()
    with pytest.raises(shardgroup.GangError, match="bundle"):
        shardgroup.create_gang(
            _FailingRank, shardgroup.ShardSpec(tp=1, world_size=2,
                                               bundle={"CPU": 0.1}),
            rank_options=lambda r: {"num_cpus": 2.0})
    assert time.time() - t0 < 5.0


def test_gang_monitor_fails_the_group_fast_on_rank_death():
    # test_shardgroup.py::test_gang_monitor_fires_once_on_rank_death
    deaths = []
    group = shardgroup.create_replica_group(
        _Rank, shardgroup.ShardSpec(tp=1, world_size=2),
        deployment_name="mon", actor_options=ONE_THREAD,
        on_death=lambda g, rank: deaths.append(rank))
    assert group.check_alive(timeout_s=10)
    t0 = time.time()
    ray_tpu_torch.kill(group.ranks[1])
    while not deaths and time.time() - t0 < 15:
        time.sleep(0.05)
    assert deaths == [1] and time.time() - t0 < 5.0
    group.kill()


def test_current_mesh_is_none_at_tp1_and_needs_m8_above():
    from ray_tpu_torch.shardgroup import runtime
    from ray_tpu_torch.shardgroup.spec import resources_of

    assert resources_of({"num_gpus": 1, "num_cpus": 2}) == {"GPU": 1.0,
                                                            "CPU": 2.0}
    assert shardgroup.ShardSpec(world_size=2).rank_bundle(
        {"num_gpus": 1}) == {"GPU": 1.0}
    assert shardgroup.current_mesh() is None
    try:
        runtime.activate({"group_id": "g1", "rank": 0, "world_size": 1,
                          "tp": 1, "spmd": False})
        assert shardgroup.current_mesh() is None
        runtime.deactivate()
        runtime.activate({"group_id": "g2", "rank": 0, "world_size": 1,
                          "tp": 2, "spmd": False})
        with pytest.raises(NotImplementedError, match="M8"):
            shardgroup.current_mesh()
    finally:
        runtime.deactivate()
