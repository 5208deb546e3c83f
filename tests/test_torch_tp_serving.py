"""Tensor-parallel serving of the port against the JAX package's, on the
CPU.

The reference serves a tp mesh from one process (GSPMD partitions its
step programs); the port's lockstep engine runs one engine a rank: the
ranks are two spawned gloo processes (`tests/gloo_ranks.py`), rank 0
schedules and rank 1 follows its step records. The JAX side runs in the
test process, its tp-2 engine on 2 of conftest's 8 virtual CPU devices.
Both serve the tiny Llama in float32 from one flax parameter tree carried
across (`params_from_jax`), so the comparison is token-exact: where tokens
part, the test fails naming the step and whether the reference's top-2
logits there lie within TIE (of the row's rms) of each other, a near tie
that another summation order may break the other way. JAX is imported
only inside fixtures: the ranks import this file.
"""

import dataclasses
import datetime
import threading
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import assert_compiles_once
from gloo_ranks import GlooRanks
from ray_tpu_torch.inference import EngineConfig, InferenceEngine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import MeshSpec, build_mesh
from ray_tpu_torch.parallel.tensor_parallel import (MeshContext,
                                                    vocab_parallel_argmax)

SEEDS = {"m-a": 11, "m-b": 22}
TIE = 1e-4
# The reference's engine tests: tests/test_shardgroup.py:87 (plain),
# tests/test_multiplex.py:166 (adapters) and :188 (prefix cache and
# speculative decoding); each wave is served to the end before the next.
PLAIN = {"kwargs": {}, "waves": [[([1, 2, 3, 4, 5], 10, None),
                                  ([7, 8, 9], 8, None)]]}
MUX = {"kwargs": {"max_adapters": 2, "lora_rank": 8},
       "waves": [[([1, 2, 3, 4, 5], 10, "m-a"), ([9, 8, 7], 8, "m-b")]]}
SPEC_PROMPT = list(range(1, 18))
SPEC = {"kwargs": {"spec_decode_draft_len": 2}, "draft": True,
        "waves": [[(SPEC_PROMPT, 8, None)],
                  [(SPEC_PROMPT, 8, None), ([9, 8, 7], 6, None)]]}


@pytest.fixture(scope="module", autouse=True)
def ranks():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    pool = GlooRanks(2, timeout_s=120, preload=__name__)
    yield pool
    pool.close()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's tiny Llama in float32, its engines (one device
    and tp 2) and the same weights as the port's state dict in numpy."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from ray_tpu.inference import EngineConfig as JaxEngineConfig
    from ray_tpu.inference import InferenceEngine as JaxInferenceEngine
    from ray_tpu.models import llama as jllama
    from ray_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel.mesh import build_mesh as jax_build_mesh

    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(seq=128),
                              dtype=jnp.float32)
    model = jllama.Llama(cfg)
    params = jax.jit(lambda: model.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32)))()
    state = {k: v.numpy() for k, v in tllama.params_from_jax(
        jax.tree.map(np.asarray, fnn.meta.unbox(params))).items()}
    mesh = jax_build_mesh(JaxMeshSpec({"tp": 2}), devices=jax.devices()[:2])

    def source(model_id):
        return jllama.make_adapter_weights(cfg, rank=8, seed=SEEDS[model_id])

    def serve(case, tp: int):
        draft = ({"draft_model": model, "draft_params": params}
                 if case.get("draft") else {})
        eng = JaxInferenceEngine(JaxEngineConfig(**case["kwargs"]),
                                 model=model, params=params,
                                 mesh=mesh if tp == 2 else None, **draft)
        eng.register_adapter_source(source)
        return _serve_waves(eng, case["waves"])

    def gap(prompt, model_id=None):
        """The reference's top-2 logit gap after `prompt`, over the logit
        row's rms: the stream through its paged decode in one chunk."""
        n_blk = -(-len(prompt) // 16)
        arenas = jllama.make_paged_arena(cfg, n_blk + 1, 16)
        bt = jnp.arange(1, n_blk + 1, dtype=jnp.int32)[None]
        ids = jnp.asarray([prompt], jnp.int32)
        lora = {}
        if model_id is not None:
            from ray_tpu.inference.adapters import AdapterManager

            mgr = AdapterManager(cfg, 1, 8)
            mgr.ensure(model_id, source)
            lora = {"lora_banks": mgr.device_banks(),
                    "adapter_idx": jnp.ones((1,), jnp.int32)}
        logits, _ = model.apply(params, ids, arenas, bt,
                                jnp.zeros((1,), jnp.int32),
                                jnp.ones(ids.shape, bool), **lora,
                                method=model.decode_paged)
        row = np.asarray(logits[0, -1], np.float64)
        top = np.sort(row)[-2:]
        return float((top[1] - top[0]) / np.sqrt(np.mean(row ** 2)))

    return types.SimpleNamespace(state=state, serve=serve, gap=gap)


def _serve_waves(engine, waves):
    """Tokens of each request, wave by wave (each served to the end), and
    the prompt tokens the prefix cache gave each."""
    tokens, cached = [], []
    for wave in waves:
        reqs = [engine.add_request(p, n, model_id=m) for p, n, m in wave]
        engine.run_until_idle()
        tokens += [list(r.generated) for r in reqs]
        cached += [r.cached_tokens for r in reqs]
    engine.check_no_leaks()
    return {"tokens": tokens, "cached": cached, "stats": engine.stats()}


def _port_model(state, mesh=None) -> tllama.Llama:
    """The tiny Llama of `state`, placed on `mesh` when one is given."""
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(seq=128),
                              dtype=torch.float32)
    return tllama.Llama(cfg, device="cpu", mesh=mesh, state={
        k: torch.from_numpy(np.array(v)) for k, v in state.items()})


def _port_engine(state, case, mesh=None):
    model = _port_model(state, mesh)
    engine = InferenceEngine(
        EngineConfig(**case["kwargs"]), model=model, mesh=mesh,
        draft_model=model if case.get("draft") else None)

    def source(model_id):
        return tllama.make_adapter_weights(model.config, 8, SEEDS[model_id])

    engine.register_adapter_source(source)
    return engine


def test_a_mesh_engine_serves_only_models_placed_on_its_mesh():
    """One placement path: a model is placed on the mesh (`Llama(mesh=)`)
    before the engine serves it there, and a model on a mesh is served only
    with that mesh (a fake group of 2: the refusals come before any
    collective)."""
    from gloo_ranks import fake_tp_mesh

    cfg = tllama.LlamaConfig.tiny(seq=128)
    whole = tllama.Llama(cfg, device="cpu", seed=0)
    with fake_tp_mesh(2) as mesh:
        placed = tllama.Llama(cfg, device="cpu", seed=0, mesh=mesh)
        for kwargs in ({"model": whole, "mesh": mesh}, {"model": placed},
                       {"model": placed, "draft_model": whole,
                        "mesh": mesh}):
            with pytest.raises(ValueError, match="placed on that mesh"):
                InferenceEngine(EngineConfig(), **kwargs)


def _tp2_mesh():
    return build_mesh(MeshSpec({"tp": 2}), device_type="cpu")


def serve_tp2(rank, state, case):
    """A rank of the port's tp 2 engine: rank 0 serves `case`'s waves and
    sends the stop record, rank 1 follows. Each returns its stats, its
    arena's shape and (rank 1) the records it applied."""
    engine = _port_engine(state, case, _tp2_mesh())
    out = {"arena": tuple(engine._arenas[0][0].shape)}
    if rank == 0:
        out.update(_serve_waves(engine, case["waves"]))
        engine.stop_followers()
    else:
        out["followed"] = engine.follow()
        out["stats"] = engine.stats()
        engine.check_no_leaks()
    return out


def _assert_same_tokens(got, want, waves, ref, what: str):
    """Token for token; where they part, name the step and the reference's
    top-2 gap there (a near tie below TIE)."""
    reqs = [r for wave in waves for r in wave]
    for j, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        i = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        prompt, _, model_id = reqs[j]
        gap = ref.gap(list(prompt) + w[:i], model_id)
        kind = (f"a near tie: the reference's top-2 logits are {gap:.2e} "
                f"of the row's rms apart, within {TIE:.0e}" if gap < TIE
                else f"not a tie: the reference's top-2 gap is {gap:.2e} "
                     "of the row's rms")
        raise AssertionError(f"{what}: request {j} parts at token {i} "
                             f"({g[i]} against {w[i]}): {kind}")
    assert len(got) == len(want)


def _check_ranks(outs, case, cfg):
    """Both ranks: one shape per program, each arena holding n_kv_head / 2
    heads, the follower applied one record a program call."""
    kv = (EngineConfig().num_blocks, EngineConfig().block_size,
          cfg.n_kv_head // 2, cfg.head_dim)
    for rank, out in enumerate(outs):
        assert out["arena"] == kv, (rank, out["arena"])
        st = out["stats"]
        assert st["tp"] == 2
        if case["kwargs"].get("spec_decode_draft_len"):
            assert_compiles_once(st["spec_decode"], "draft_prefill_compiles",
                                 "propose_compiles", "verify_compiles",
                                 context=f"rank {rank}")
            assert_compiles_once(st, "prefill_compiles",
                                 context=f"rank {rank}")
        else:
            assert_compiles_once(st, "prefill_compiles", "decode_compiles",
                                 context=f"rank {rank}")
    assert outs[1]["followed"] > 0


def test_tp2_engine_emits_the_jax_engines_tokens(ranks, ref):
    # tests/test_shardgroup.py::test_engine_tp_decode_parity_and_compile_once
    outs = ranks.run(serve_tp2, ref.state, PLAIN)
    _check_ranks(outs, PLAIN, _port_model(ref.state).config)
    port_tp1 = _serve_waves(_port_engine(ref.state, PLAIN), PLAIN["waves"])
    got = outs[0]["tokens"]
    for name, want in (("the reference's tp-2 engine", ref.serve(PLAIN, 2)),
                       ("the reference's single-device engine",
                        ref.serve(PLAIN, 1)),
                       ("the port's tp-1 engine", port_tp1)):
        _assert_same_tokens(got, want["tokens"], PLAIN["waves"], ref, name)


def test_tp2_multiplexed_engine_emits_the_jax_engines_tokens(ranks, ref):
    # tests/test_multiplex.py::test_tp2_multiplexed_parity: m-a and m-b
    # through tp 2, the A_o bank split with the heads.
    outs = ranks.run(serve_tp2, ref.state, MUX)
    _check_ranks(outs, MUX, _port_model(ref.state).config)
    assert outs[1]["stats"]["adapters"]["resident"] == ["m-a", "m-b"]
    want = ref.serve(MUX, 2)
    _assert_same_tokens(outs[0]["tokens"], want["tokens"], MUX["waves"], ref,
                        "the reference's tp-2 engine")
    assert outs[0]["tokens"][0] != outs[0]["tokens"][1]


def test_tp2_prefix_cache_and_spec_decode_emit_the_jax_engines_tokens(
        ranks, ref):
    # tests/test_multiplex.py::test_tp2_prefix_cache_and_spec_decode_parity:
    # a radix hit and speculative decoding (the target as its own draft)
    # through tp 2.
    outs = ranks.run(serve_tp2, ref.state, SPEC)
    _check_ranks(outs, SPEC, _port_model(ref.state).config)
    got = outs[0]
    assert got["cached"][1] == 16, got["cached"]
    assert got["stats"]["prefix_cache"]["hits"] >= 1
    assert got["stats"]["spec_decode"]["accept_rate"] == 1.0
    want = ref.serve(SPEC, 2)
    _assert_same_tokens(got["tokens"], want["tokens"], SPEC["waves"], ref,
                        "the reference's tp-2 engine")


def dense_decode_tp2(rank, state):
    """The dense-cache path at tp 2: a prompt, then two single tokens,
    through `decode` on this rank's cache (n_kv_head / 2 heads), against
    the same calls at tp 1. Returns the largest difference of this rank's
    vocab shard of the logits and the cache's shape."""
    mesh = _tp2_mesh()
    one = _port_model(state)
    tp = _port_model(state, mesh)
    caches = [tllama.make_cache(one.config, 2, 16, device="cpu"),
              tllama.make_cache(one.config, 2, 16, device="cpu", mesh=mesh)]
    ids = torch.tensor([[1, 2, 3, 4], [9, 8, 7, 6]])
    pos = torch.zeros(2, dtype=torch.long)
    half = one.config.vocab_size // 2
    worst = 0.0
    for step in range(3):
        want, _ = one.decode(ids, caches[0], pos)
        got, _ = tp.decode(ids, caches[1], pos)
        want = want[..., rank * half:(rank + 1) * half]
        worst = max(worst, float((got - want).abs().max()))
        pos = pos + ids.shape[1]
        ids = torch.tensor([[5 + step], [6 + step]])
    return worst, tuple(caches[1][0][0].shape)


def test_tp2_dense_cache_decode_gives_the_tp1_logits_shard(ranks, ref):
    cfg = _port_model(ref.state).config
    for worst, shape in ranks.run(dense_decode_tp2, ref.state):
        assert worst < 1e-5, worst
        assert shape == (2, 16, cfg.n_kv_head // 2, cfg.head_dim)


# --------------------------------------------------------------------- #
# The vocab-parallel pick, the reset and stop records, a follower's fault
# --------------------------------------------------------------------- #


def pick_tp2(rank, rows):
    """Each rank's half of `rows` through `vocab_parallel_argmax`."""
    ctx = MeshContext.of(_tp2_mesh())
    half = rows.shape[-1] // 2
    mine = torch.from_numpy(rows[..., rank * half:(rank + 1) * half])
    return vocab_parallel_argmax(mine, ctx).tolist()


def test_vocab_parallel_pick_breaks_ties_as_argmax(ranks):
    v = 8                                   # shards [0, 4) and [4, 8)
    rows = np.zeros((6, v), np.float32)
    rows[0, [3, 4]] = 1.0                   # tie across the shard border
    rows[1, [1, 6]] = 1.0                   # tie across shards, apart
    rows[2, [5, 7]] = 1.0                   # tie inside rank 1's shard
    rows[3, [0, 2]] = 1.0                   # tie inside rank 0's shard
    rows[4, 6] = 2.0                        # rank 1 alone holds the max
    rows[5] = -1.0                          # every column ties
    want = torch.from_numpy(rows).argmax(dim=-1).tolist()
    assert want == [3, 1, 5, 0, 6, 0]
    for shape in ((6, v), (2, 3, v)):       # [B] and [B, k+1] rows
        r = rows.reshape(shape)
        assert ranks.run(pick_tp2, r) == [
            torch.from_numpy(r).argmax(dim=-1).tolist()] * 2


def reset_and_stop(rank, state):
    """Rank 0 serves a request, fails everything (`fail_all`: an arena
    reset record), then stops; rank 1 follows. Returns whether the arenas
    held KV after the request and were zero at the end, and what
    `follow()` returned."""
    engine = _port_engine(state, PLAIN, _tp2_mesh())
    if rank == 0:
        engine.add_request([1, 2, 3, 4, 5], 4)
        engine.run_until_idle()
        written = bool(engine._arenas[0][0].any())
        engine.add_request([7, 8, 9], 4)
        assert engine.fail_all("planted") == 1
        engine.stop_followers()
        engine.stop_followers()             # once only
        followed = None
    else:
        followed = engine.follow()
        written = None
    return {"written": written, "followed": followed,
            "zero": not any(k.any() or v.any() for k, v in engine._arenas)}


def test_fail_all_resets_the_followers_arena_and_stop_ends_follow(ranks,
                                                                   ref):
    lead, follower = ranks.run(reset_and_stop, ref.state)
    assert lead["written"] and lead["zero"]
    # The prefill, three decodes and the reset: the follower's arena was
    # rebuilt too, and the stop record ended `follow()`.
    assert follower["followed"] == 5 and follower["zero"]


def idle_loop(rank, state):
    """Rank 0 runs an `EngineLoop` with the heartbeat due at once: idle, it
    sends empty records; `stop()` sends the stop record. Rank 1 follows."""
    from ray_tpu_torch.inference import EngineLoop

    engine = _port_engine(state, PLAIN, _tp2_mesh())
    if rank == 1:
        return engine.follow()
    # The ranks' group times out at 60 s (`gloo_ranks`): the heartbeat is
    # due every quarter of that.
    assert engine._lockstep.heartbeat_s == 15.0
    engine._lockstep.heartbeat_s = 0.0
    loop = EngineLoop(engine)
    deadline = time.monotonic() + 10
    while engine._lockstep.sent < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    loop.stop()
    return engine._lockstep.sent


def test_an_idle_loop_keeps_followers_alive_and_its_stop_ends_follow(ranks,
                                                                     ref):
    sent, followed = ranks.run(idle_loop, ref.state)
    # Every record but the stop one was applied: empty ones, then
    # `fail_all`'s reset as the loop stopped.
    assert sent >= 4 and followed == sent - 1


def planted_fault(rank, state, timeout_s):
    """tp 2 over a group with a `timeout_s` limit; rank 1's decode program
    raises. Rank 0 serves through an `EngineLoop`: its first decode fails
    within the limit and breaks the lockstep, after which the loop's
    circuit breaker fails every request, one submitted after the fault
    too, and stopping the loop sends nothing. Returns each request's
    error and the seconds until it finished."""
    from torch.distributed.device_mesh import DeviceMesh

    from ray_tpu_torch.inference import EngineLoop

    group = dist.new_group([0, 1], backend="gloo",
                           timeout=datetime.timedelta(seconds=timeout_s))
    mesh = DeviceMesh.from_group(group, "cpu", mesh_dim_names=("tp",))
    engine = _port_engine(state, PLAIN, mesh)
    if rank == 1:
        def fault(*args):
            raise RuntimeError("planted fault")

        engine._programs["decode"] = fault
        try:
            engine.follow()
        except RuntimeError as e:
            return str(e)
        return "follow() returned"
    loop = EngineLoop(engine)
    t0 = time.monotonic()
    ended = {}

    def submit(prompt):
        done = threading.Event()
        req = loop.submit(prompt, 4, on_finish=lambda r: done.set())
        return req, done

    first = [submit([1, 2, 3, 4, 5]), submit([7, 8, 9])]
    for req, done in first:
        done.wait(4 * timeout_s)
        ended[req.request_id] = time.monotonic() - t0
    sent = engine._lockstep.sent
    late, done = submit([4, 5, 6])
    done.wait(4 * timeout_s)
    ended[late.request_id] = time.monotonic() - t0
    t1 = time.monotonic()
    loop.stop()
    return {"errors": [r.error for r, _ in first] + [late.error],
            "ended_s": sorted(ended.values()),
            "broken": engine._lockstep.broken,
            "sent": [sent, engine._lockstep.sent],
            "stop_s": time.monotonic() - t1}


def test_a_follower_fault_fails_the_leaders_step_in_its_timeout(ranks, ref):
    timeout_s = 2.0
    lead, follower = ranks.run(planted_fault, ref.state, timeout_s)
    assert follower == "planted fault"
    # Every request failed: the two in flight when the follower faulted
    # within the one timeout that the first decode waits out (the
    # breaker's two further steps fail at once, with no second wait), the
    # late one at once.
    assert all(e for e in lead["errors"]), lead
    assert lead["broken"] is not None, lead
    assert lead["ended_s"][-1] < 1.75 * timeout_s, lead
    # Nothing was sent into the broken group after the fault: not the
    # late request's steps, the breaker's reset or the loop's stop.
    assert lead["sent"][0] == lead["sent"][1] and lead["stop_s"] < 1.0, lead


@pytest.mark.parametrize("fault", [RuntimeError("a program failed"),
                                   TimeoutError("no record in time")])
def test_a_failed_llm_server_follower_ends_its_rank(monkeypatch, fault):
    """`LLMServer`'s follower thread ends its process on any fault of
    `follow()`, so the controller restarts the gang as a unit (a rank that
    stayed up would leave its leader out of step for good); a stop record
    ends the thread and nothing else."""
    from ray_tpu_torch.inference import api

    exits = []
    monkeypatch.setattr(api.os, "_exit", exits.append)
    monkeypatch.setattr(api.logging, "shutdown", lambda: None)

    def follow():
        raise fault

    server = api.LLMServer.user_callable
    server._follow(types.SimpleNamespace(
        _engine=types.SimpleNamespace(follow=follow)))
    server._follow(types.SimpleNamespace(
        _engine=types.SimpleNamespace(follow=lambda: 3)))
    assert exits == [1]
