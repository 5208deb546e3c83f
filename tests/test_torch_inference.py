"""The port's continuous-batching engine, on the CPU.

The block manager and radix prefix cache tests of tests/test_inference.py
run on the port's copy; the engine behaviours run on the port's tiny Llama
(bf16 compute, as the reference's tests) against its own dense-cache greedy
loop, token for token; and the slice as a whole is held against the JAX
package: its engine and the port's, on one flax parameter tree carried
across with `params_from_jax` (float32, so the comparison is token-exact),
serve the same requests and emit the same tokens.
"""

import dataclasses
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_compiles_once
from gloo_ranks import fake_tp_mesh
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.inference import EngineConfig, EngineLoop, InferenceEngine
from ray_tpu_torch.inference.kv_cache import TRASH_BLOCK, BlockManager
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.observability import tracing


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # Tiny shapes: one intra-op thread each, so parallel test workers do
    # not oversubscribe the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# Block manager and radix prefix cache (pure bookkeeping)
# --------------------------------------------------------------------- #


def test_block_manager_alloc_free():
    bm = BlockManager(num_blocks=9, block_size=4)
    assert bm.capacity == 8 and bm.num_free() == 8
    bm.register("a")
    assert bm.ensure("a", 10)          # 3 blocks
    assert bm.blocks_in_use() == 3
    assert len(bm.block_table("a")) == 3
    assert TRASH_BLOCK not in bm.block_table("a")
    assert bm.ensure("a", 10)          # idempotent
    assert bm.blocks_in_use() == 3
    assert bm.free("a") == 3
    assert bm.blocks_in_use() == 0
    bm.check_consistency()


def test_block_manager_exhaustion_returns_false():
    bm = BlockManager(num_blocks=5, block_size=2)   # 4 allocatable
    bm.register("a")
    bm.register("b")
    assert bm.ensure("a", 6)           # 3 blocks
    assert not bm.ensure("b", 4)       # needs 2, only 1 free
    assert bm.ensure("b", 2)           # 1 block fits
    assert not bm.fits(100)
    bm.free("a")
    assert bm.ensure("b", 8)
    bm.free("b")
    bm.check_consistency()
    assert bm.blocks_in_use() == 0


def test_block_manager_fork_refcounts_and_cow():
    bm = BlockManager(num_blocks=17, block_size=4)
    bm.register("parent")
    assert bm.ensure("parent", 10)     # 3 blocks
    bm.fork("parent", "child")
    assert bm.block_table("child") == bm.block_table("parent")
    assert bm.blocks_in_use() == 3     # shared, not copied
    # Appending to a shared tail must copy-on-write.
    cow = bm.ensure_appendable("child")
    assert cow is not None and cow[1] != -1
    src, dst = cow
    assert bm.block_table("child")[-1] == dst
    assert bm.block_table("parent")[-1] == src
    assert bm.blocks_in_use() == 4
    assert bm.ensure_appendable("child") is None   # now exclusive
    # Freeing the parent keeps the shared prefix alive for the child.
    assert bm.free("parent") == 1      # only the old tail was exclusive
    assert bm.blocks_in_use() == 3
    assert bm.free("child") == 3
    assert bm.blocks_in_use() == 0
    bm.check_consistency()


def test_block_manager_cow_exhaustion_degrades():
    bm = BlockManager(num_blocks=4, block_size=2)   # 3 allocatable
    bm.register("p")
    assert bm.ensure("p", 6)           # all 3 blocks
    bm.fork("p", "c")
    assert bm.ensure_appendable("c") == (bm.block_table("c")[-1], -1)
    bm.free("p")
    bm.free("c")
    bm.check_consistency()


def test_block_manager_randomized_fuzz():
    """Seeded fork/append/free fuzz: any interleaving of COW forks,
    appends, frees and radix-style table adoptions keeps the refcount
    invariants (`check_consistency` after EVERY op) and a full drain
    returns the arena to empty — the zero-leak contract the engine's
    `check_no_leaks` builds on."""
    import random

    rng = random.Random(0x5EED)
    bm = BlockManager(num_blocks=25, block_size=4)
    tokens = {}                        # live seq_id -> token count
    spawned = 0
    for _ in range(600):
        roll = rng.random()
        if roll < 0.35 or not tokens:              # new sequence
            sid = f"s{spawned}"
            spawned += 1
            n = rng.randint(1, 12)
            bm.register(sid)
            if bm.ensure(sid, n):
                tokens[sid] = n
            else:                                  # pool full: back out
                bm.free(sid)
        elif roll < 0.60:                          # append one token
            sid = rng.choice(sorted(tokens))
            cow = bm.ensure_appendable(sid)
            if cow is not None and cow[1] == -1:
                pass                               # COW exhausted: no-op
            elif bm.ensure(sid, tokens[sid] + 1):
                tokens[sid] += 1
        elif roll < 0.75:                          # fork (shared prefix)
            child = f"s{spawned}"
            spawned += 1
            parent = rng.choice(sorted(tokens))
            bm.fork(parent, child)
            tokens[child] = tokens[parent]
        elif roll < 0.85:                          # adopt (radix-style)
            twin = f"s{spawned}"
            spawned += 1
            donor = rng.choice(sorted(tokens))
            bm.register_with_blocks(twin, bm.block_table(donor))
            tokens[twin] = tokens[donor]
        else:                                      # free
            sid = rng.choice(sorted(tokens))
            bm.free(sid)
            del tokens[sid]
        bm.check_consistency()
        assert bm.blocks_in_use() <= bm.capacity
    for sid in sorted(tokens):
        bm.free(sid)
        bm.check_consistency()
    assert bm.blocks_in_use() == 0 and bm.num_seqs() == 0


# --------------------------------------------------------------------- #
# Radix prefix cache (pure bookkeeping, no jax)
# --------------------------------------------------------------------- #


def test_radix_cache_insert_match_split_evict():
    from ray_tpu_torch.inference.kv_cache import RadixPrefixCache

    bm = BlockManager(num_blocks=17, block_size=4)
    cache = RadixPrefixCache(bm)
    bm.register("donor")
    assert bm.ensure("donor", 12)
    table = list(bm.block_table("donor"))
    assert cache.insert(list(range(12)), table) == 3   # 3 novel blocks
    # The donor frees; the cache's synthetic table keeps the KV alive.
    assert bm.free("donor") == 0
    cache.check_consistency()
    assert cache.cached_blocks() == 3 == bm.blocks_in_use()

    # Full-prefix hit returns the donor's physical blocks in order.
    hit, node = cache.match(list(range(12)))
    assert hit == table and node is not None

    # Partial match splits the edge so the returned node covers EXACTLY
    # the matched span (pinning it protects nothing extra).
    hit2, node2 = cache.match(list(range(8)) + [77, 78, 79, 80])
    assert hit2 == table[:2]
    cache.check_consistency()
    cache.pin(node2)

    # Adoption: a reader increfs the cached blocks, frees its own ref.
    bm.register_with_blocks("reader", hit2)
    bm.check_consistency()
    assert bm.free("reader") == 0          # cache still holds them
    assert cache.cached_blocks() == 3

    # Eviction is LRU over UNPINNED leaves: the pinned 2-block prefix
    # survives unbounded pressure; only the unpinned tail leaf goes.
    assert cache.evict_for(1000) == 1
    assert cache.cached_blocks() == 2
    cache.unpin(node2)
    assert cache.evict_for(1000) == 2
    assert cache.cached_blocks() == 0
    cache.check_consistency()
    assert bm.blocks_in_use() == 0
    s = cache.stats()
    assert s["lookups"] == 2 and s["hits"] == 2
    assert s["inserted_blocks"] == 3 and s["evicted_blocks"] == 3


def test_radix_cache_dedupes_branches_and_clears():
    from ray_tpu_torch.inference.kv_cache import RadixPrefixCache

    bm = BlockManager(num_blocks=17, block_size=4)
    cache = RadixPrefixCache(bm)
    bm.register("d1")
    assert bm.ensure("d1", 12)
    t1 = list(bm.block_table("d1"))
    cache.insert(list(range(12)), t1)
    bm.free("d1")

    # Second donor shares the first 8 tokens, diverges in block 3: the
    # shared span dedupes onto the tree's blocks (the donor's duplicates
    # return to the pool when it frees), only the novel block is kept.
    bm.register("d2")
    assert bm.ensure("d2", 12)
    t2 = list(bm.block_table("d2"))
    toks2 = list(range(8)) + [90, 91, 92, 93]
    assert cache.insert(toks2, t2) == 1
    assert bm.free("d2") == 2              # the two duplicated blocks
    cache.check_consistency()
    assert cache.cached_blocks() == 4 == bm.blocks_in_use()

    # Both branches resolve to their own tails over the shared prefix.
    hit1, _ = cache.match(list(range(12)))
    hit2, _ = cache.match(toks2)
    assert hit1 == t1
    assert hit2 == t1[:2] + t2[2:]
    # Partial blocks never match (alphabet is FULL blocks only).
    hit3, node3 = cache.match(list(range(3)))
    assert hit3 == [] and node3 is None

    assert cache.clear() == 4
    cache.check_consistency()
    assert cache.cached_blocks() == 0 and bm.blocks_in_use() == 0


# --------------------------------------------------------------------- #
# Engine
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def tiny_llama():
    return tllama.Llama(tllama.LlamaConfig.tiny(seq=256), device="cpu",
                        seed=0)


def _reference_generate(model, prompt, n):
    """Dense KV-cache greedy loop — the engine must match it exactly."""
    cache = tllama.make_cache(model.config, 1, 256, device="cpu")
    logits, cache = model.decode(torch.tensor([prompt]), cache,
                                 torch.zeros(1, dtype=torch.long))
    toks = [int(logits[0, -1].argmax())]
    pos = len(prompt)
    while len(toks) < n:
        logits, cache = model.decode(torch.tensor([[toks[-1]]]), cache,
                                     torch.tensor([pos]))
        toks.append(int(logits[0, -1].argmax()))
        pos += 1
    return toks


def _make_engine(model, **overrides):
    draft = {k: overrides.pop(k) for k in ("draft_model",) if k in overrides}
    kwargs = dict(batch_slots=3, block_size=4, num_blocks=64,
                  max_blocks_per_seq=16, prefill_chunk=8)
    kwargs.update(overrides)
    return InferenceEngine(EngineConfig(**kwargs), model=model, **draft)


def test_engine_matches_reference_and_compiles_once(tiny_llama):
    engine = _make_engine(tiny_llama)
    reqs = [engine.add_request([1 + i, 2 + i, 3 + i, 4 + i],
                               max_new_tokens=4 + i) for i in range(5)]
    engine.run_until_idle()
    for req in reqs:
        assert req.state == "FINISHED"
        ref = _reference_generate(tiny_llama, req.prompt, req.max_new_tokens)
        assert req.generated == ref, req.request_id
    stats = engine.stats()
    # Mixed admissions, exits and chunked prefill: one argument shape for
    # each of the two programs.
    assert_compiles_once(stats, "prefill_compiles", "decode_compiles")
    engine.check_no_leaks()


def test_chunked_prefill_interleaves_with_decode(tiny_llama):
    events = []
    engine = _make_engine(tiny_llama, batch_slots=2, prefill_chunk=4)
    short = engine.add_request(
        [1, 2, 3], max_new_tokens=12,
        on_token=lambda r, t: events.append(("short", t)),
        request_id="short")
    while short.state != "DECODE":
        engine.step()
    long = engine.add_request(
        list(range(1, 33)), max_new_tokens=4,      # 8 prefill chunks
        on_token=lambda r, t: events.append(("long", t)),
        request_id="long")
    engine.run_until_idle()
    assert short.state == "FINISHED" and long.state == "FINISHED"
    first_long = next(i for i, (who, _) in enumerate(events)
                      if who == "long")
    short_before_long = sum(1 for who, _ in events[:first_long]
                            if who == "short")
    assert short_before_long >= 3, events
    engine.check_no_leaks()


def test_preemption_recovers_and_leaks_nothing(tiny_llama):
    engine = _make_engine(tiny_llama, batch_slots=2, block_size=2,
                          num_blocks=9, max_blocks_per_seq=8,
                          prefill_chunk=4)
    a = engine.add_request([1, 2, 3], max_new_tokens=10, request_id="a")
    b = engine.add_request([4, 5, 6], max_new_tokens=10, request_id="b")
    engine.run_until_idle()
    assert a.state == b.state == "FINISHED"
    stats = engine.stats()
    assert stats["preemptions"] >= 1
    assert a.preemptions == 0 and b.preemptions >= 1
    assert a.generated == _reference_generate(tiny_llama, a.prompt, 10)
    assert b.generated == _reference_generate(tiny_llama, b.prompt, 10)
    engine.check_no_leaks()
    engine.drop_prefix_cache()
    engine.check_no_leaks()
    assert engine.stats()["kv"]["blocks_in_use"] == 0
    assert_compiles_once(stats, "decode_compiles")


def test_engine_rejects_oversized_request(tiny_llama):
    engine = _make_engine(tiny_llama, block_size=2, num_blocks=8,
                          max_blocks_per_seq=4)
    with pytest.raises(ValueError, match="token slots"):
        engine.add_request(list(range(20)), max_new_tokens=20)
    engine.check_no_leaks()


def test_engine_loop_threaded_streaming(tiny_llama):
    engine = _make_engine(tiny_llama)
    loop = EngineLoop(engine)
    try:
        done = threading.Event()
        tokens = []
        req = loop.submit([1, 2, 3], 6,
                          on_token=lambda r, t: tokens.append(t),
                          on_finish=lambda r: done.set())
        assert done.wait(60)
        assert tokens == req.generated and len(tokens) == 6
    finally:
        loop.stop()
    assert not loop._thread.is_alive()
    engine.check_no_leaks()


def test_cancel_releases_slot_and_blocks(tiny_llama):
    engine = _make_engine(tiny_llama, batch_slots=1)
    done = []
    a = engine.add_request([1, 2, 3], max_new_tokens=50,
                           request_id="abandoned")
    b = engine.add_request([4, 5], max_new_tokens=3, request_id="live",
                           on_finish=lambda r: done.append(r.request_id))
    for _ in range(3):
        engine.step()
    assert a.state == "DECODE" and b.state == "WAITING"
    assert engine.cancel("abandoned")
    assert a.state == "FAILED" and a.error == "cancelled"
    assert not engine.cancel("abandoned")
    engine.run_until_idle()
    assert b.state == "FINISHED" and done == ["live"]
    engine.check_no_leaks()
    engine.add_request([1], 1, request_id="abandoned")
    engine.run_until_idle()
    engine.check_no_leaks()


def test_duplicate_request_id_rejected_at_submit(tiny_llama):
    engine = _make_engine(tiny_llama)
    engine.add_request([1, 2], max_new_tokens=4, request_id="dup")
    with pytest.raises(ValueError, match="already live"):
        engine.add_request([3, 4], max_new_tokens=4, request_id="dup")
    engine.run_until_idle()
    engine.check_no_leaks()


def test_fail_all_rebuilds_arenas_and_submit_after_stop(tiny_llama):
    engine = _make_engine(tiny_llama, batch_slots=2,
                          spec_decode_draft_len=2)
    finished = []
    reqs = [engine.add_request([1 + i], max_new_tokens=50,
                               on_finish=lambda r: finished.append(r),
                               request_id=f"f{i}") for i in range(4)]
    engine.step()                       # two scheduled, two waiting
    old = [engine._arenas[0][0], engine._draft_arenas[0][0]]
    assert all(t.any() for t in old)
    assert engine.fail_all("injected failure") == 4
    assert len(finished) == 4
    assert all(r.state == "FAILED" and r.error == "injected failure"
               for r in reqs)
    engine.check_no_leaks()
    # Fresh, zeroed arenas, of the same geometry, in place of the old.
    for arenas, was in ((engine._arenas, old[0]),
                        (engine._draft_arenas, old[1])):
        assert arenas[0][0] is not was and arenas[0][0].shape == was.shape
        assert not any(k.any() or v.any() for k, v in arenas)
    recovered = engine.add_request([7, 8], max_new_tokens=3)
    engine.run_until_idle()
    assert recovered.generated == _reference_generate(tiny_llama, [7, 8], 3)
    engine.check_no_leaks()

    loop = EngineLoop(engine)
    loop.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        loop.submit([1], 2)


def test_static_gang_holds_results_until_drain(tiny_llama):
    engine = _make_engine(tiny_llama, batch_slots=2, scheduling="static")
    r_short = engine.add_request([1, 2], max_new_tokens=2,
                                 request_id="short")
    r_long = engine.add_request([3, 4], max_new_tokens=16,
                                request_id="long")
    r_next = engine.add_request([5], max_new_tokens=2, request_id="next")
    engine.run_until_idle()
    assert r_short.state == r_long.state == r_next.state == "FINISHED"
    assert abs(r_short.first_token_at - r_long.finished_at) < 0.5
    assert r_next.first_token_at >= r_long.finished_at
    engine.check_no_leaks()


def test_prefix_cache_hit_skips_prefill_no_new_programs(tiny_llama):
    engine = _make_engine(tiny_llama)              # block_size=4
    prompt = list(range(1, 10))                    # 9 tokens
    ref = _reference_generate(tiny_llama, prompt, 6)
    a = engine.add_request(prompt, max_new_tokens=6)
    engine.run_until_idle()
    assert a.generated == ref and a.cached_tokens == 0
    s0 = engine.stats()["prefix_cache"]
    assert s0["cached_blocks"] >= 2 and s0["hits"] == 0
    b = engine.add_request(prompt, max_new_tokens=6)
    engine.run_until_idle()
    assert b.generated == ref
    assert b.cached_tokens == 8
    st = engine.stats()
    assert st["prefix_cache"]["hits"] == 1
    assert st["prefix_cache"]["hit_tokens"] == 8
    assert 0.0 < st["prefix_cache"]["hit_rate"] <= 1.0
    assert_compiles_once(st, "prefill_compiles", "decode_compiles")
    engine.check_no_leaks()
    engine.drop_prefix_cache()
    engine.check_no_leaks()
    assert engine.stats()["kv"]["blocks_in_use"] == 0


def test_prefix_cache_evicts_under_arena_pressure(tiny_llama):
    engine = _make_engine(tiny_llama, batch_slots=1, num_blocks=13,
                          block_size=4, max_blocks_per_seq=12,
                          prefill_chunk=8)
    engine.add_request(list(range(1, 9)), max_new_tokens=4)
    engine.run_until_idle()
    assert engine.stats()["prefix_cache"]["cached_blocks"] >= 2
    big = engine.add_request(list(range(100, 140)), max_new_tokens=6)
    engine.run_until_idle()
    assert big.state == "FINISHED"
    st = engine.stats()
    assert st["prefix_cache"]["evicted_blocks"] >= 1
    assert st["preemptions"] == 0
    engine.check_no_leaks()


def test_prefix_cache_live_sequence_pins_its_path(tiny_llama):
    engine = _make_engine(tiny_llama)
    prompt = list(range(1, 10))
    engine.add_request(prompt, max_new_tokens=3)
    engine.run_until_idle()
    slow = engine.add_request(prompt, max_new_tokens=12)
    while slow.state != "DECODE":
        engine.step()
    assert slow.cached_tokens == 8
    assert engine.stats()["prefix_cache"]["pinned_nodes"] == 1
    engine._prefix.evict_for(10_000)
    assert engine.stats()["prefix_cache"]["cached_blocks"] >= 2
    engine.run_until_idle()
    assert slow.generated == _reference_generate(tiny_llama, prompt, 12)
    assert engine.stats()["prefix_cache"]["pinned_nodes"] == 0
    engine.check_no_leaks()


def test_fail_all_clears_prefix_cache_and_recovers(tiny_llama):
    engine = _make_engine(tiny_llama)
    a = engine.add_request(list(range(1, 9)), max_new_tokens=4)
    engine.run_until_idle()
    assert engine.stats()["prefix_cache"]["cached_blocks"] > 0
    engine.fail_all("injected")
    st = engine.stats()
    assert st["prefix_cache"]["cached_blocks"] == 0
    assert st["kv"]["blocks_in_use"] == 0
    b = engine.add_request(list(range(1, 9)), max_new_tokens=4)
    engine.run_until_idle()
    assert b.generated == a.generated
    assert engine.stats()["prefix_cache"]["cached_blocks"] > 0
    engine.check_no_leaks()


def test_spec_decode_lossless_and_compiles_once(tiny_llama):
    engine = _make_engine(tiny_llama, spec_decode_draft_len=3)
    assert engine._draft_model.config.n_layer == 1
    # The default draft shares the target's (serving) weights.
    assert (engine._draft_model.embed.data_ptr()
            == engine._model.embed.data_ptr())
    reqs = [engine.add_request([1 + i, 2 + i, 3 + i], max_new_tokens=6)
            for i in range(3)]
    engine.run_until_idle()
    for r in reqs:
        assert r.generated == _reference_generate(tiny_llama, r.prompt,
                                                  6), r.request_id
    sd = engine.stats()["spec_decode"]
    assert sd["draft_len"] == 3 and sd["rounds"] > 0
    assert sum(sd["accepted_hist"]) == sd["rounds"]
    assert_compiles_once(sd, "draft_prefill_compiles", "propose_compiles",
                         "verify_compiles")
    assert_compiles_once(engine.stats(), "prefill_compiles")
    assert engine.stats()["decode_compiles"] == 0
    engine.check_no_leaks()
    engine.drop_prefix_cache()
    assert engine.stats()["kv"]["blocks_in_use"] == 0


def test_spec_decode_target_draft_accepts_everything(tiny_llama):
    engine = _make_engine(tiny_llama, spec_decode_draft_len=3,
                          draft_model=tiny_llama)
    r = engine.add_request([1, 2, 3, 4], max_new_tokens=8)
    engine.run_until_idle()
    assert r.generated == _reference_generate(tiny_llama, [1, 2, 3, 4], 8)
    sd = engine.stats()["spec_decode"]
    assert sd["accept_rate"] == 1.0
    assert sd["rounds"] == 2                       # 8 tokens, k+1 = 4 each
    assert sd["accepted_hist"][3] == 2
    engine.check_no_leaks()


def test_spec_decode_preemption_rolls_back_without_leaks(tiny_llama):
    engine = _make_engine(tiny_llama, spec_decode_draft_len=2,
                          batch_slots=2, block_size=2, num_blocks=9,
                          max_blocks_per_seq=8, prefill_chunk=4)
    a = engine.add_request([1, 2, 3], max_new_tokens=10, request_id="a")
    b = engine.add_request([4, 5, 6], max_new_tokens=10, request_id="b")
    engine.run_until_idle()
    assert a.state == b.state == "FINISHED"
    assert engine.stats()["preemptions"] >= 1
    assert a.generated == _reference_generate(tiny_llama, a.prompt, 10)
    assert b.generated == _reference_generate(tiny_llama, b.prompt, 10)
    engine.check_no_leaks()
    engine.drop_prefix_cache()
    assert engine.stats()["kv"]["blocks_in_use"] == 0


def test_slo_interactive_admitted_before_earlier_batch(tiny_llama):
    engine = _make_engine(tiny_llama, batch_slots=1)
    hold = engine.add_request([1, 2], max_new_tokens=6, slo_class="batch")
    while hold.state != "DECODE":
        engine.step()
    bat = engine.add_request([3, 4], max_new_tokens=3, slo_class="batch")
    inter = engine.add_request([5, 6], max_new_tokens=3,
                               slo_class="interactive")
    assert engine.stats()["slo"] == {"reserved_slots": 0,
                                     "waiting_interactive": 1,
                                     "waiting_batch": 1}
    engine.run_until_idle()
    assert inter.first_token_at < bat.first_token_at
    engine.check_no_leaks()
    with pytest.raises(ValueError, match="slo_class"):
        engine.add_request([1], 1, slo_class="bulk")


def test_slo_reserved_slots_hold_headroom_for_interactive(tiny_llama):
    engine = _make_engine(tiny_llama, batch_slots=2,
                          slo_interactive_reserved_slots=1)
    b1 = engine.add_request([1, 2], max_new_tokens=8, slo_class="batch")
    b2 = engine.add_request([3, 4], max_new_tokens=8, slo_class="batch")
    for _ in range(4):
        engine.step()
    assert b1.state in ("PREFILL", "DECODE") and b2.state == "WAITING"
    i1 = engine.add_request([5, 6], max_new_tokens=2,
                            slo_class="interactive")
    engine.run_until_idle()
    assert all(r.state == "FINISHED" for r in (b1, b2, i1))
    assert i1.first_token_at < b2.first_token_at
    engine.check_no_leaks()


def test_slo_preemption_prefers_batch_victim(tiny_llama):
    engine = _make_engine(tiny_llama, batch_slots=2, block_size=2,
                          num_blocks=9, max_blocks_per_seq=8,
                          prefill_chunk=4)
    bat = engine.add_request([1, 2, 3], max_new_tokens=10,
                             slo_class="batch")
    inter = engine.add_request([4, 5, 6], max_new_tokens=10,
                               slo_class="interactive")
    engine.run_until_idle()
    assert engine.stats()["preemptions"] >= 1
    assert inter.preemptions == 0 and bat.preemptions >= 1
    assert inter.generated == _reference_generate(tiny_llama, inter.prompt,
                                                  10)
    assert bat.generated == _reference_generate(tiny_llama, bat.prompt, 10)
    engine.check_no_leaks()


def test_phase_spans_follow_the_submitting_trace(tiny_llama):
    engine = _make_engine(tiny_llama)
    tracing.drain()
    assert engine.add_request([1, 2], 2).trace_ctx is None   # disabled
    engine.run_until_idle()
    assert tracing.drain() == []
    root = {"trace_id": "ab" * 16, "span_id": "cd" * 8, "sampled": True}
    tracing.set_enabled(True)
    try:
        # A trace sampled out at its root records nothing downstream.
        token = tracing.activate({"sampled": False})
        engine.add_request([1, 2], 2)
        engine.run_until_idle()
        tracing.deactivate(token)
        assert tracing.drain() == []
        token = tracing.activate(root)
        req = engine.add_request([1, 2, 3], 4)
        engine.run_until_idle()
        tracing.deactivate(token)
    finally:
        tracing.set_enabled(False)
    spans = {s["name"]: s for s in tracing.drain()}
    assert sorted(spans) == ["engine.decode", "engine.prefill",
                             "engine.queue"]
    for s in spans.values():
        assert s["trace_id"] == root["trace_id"]
        assert s["parent_id"] == root["span_id"]
        assert s["attrs"]["request"] == req.request_id
    # The TTFT decomposition is contiguous.
    assert spans["engine.queue"]["end"] == spans["engine.prefill"]["start"]
    assert spans["engine.prefill"]["end"] == spans["engine.decode"]["start"]
    assert spans["engine.decode"]["attrs"]["tokens"] == 4


def test_flags_from_the_environment_and_unported_options(monkeypatch,
                                                        tiny_llama):
    monkeypatch.setenv("RAY_TPU_SPEC_DECODE_DRAFT_LEN", "2")
    monkeypatch.setenv("RAY_TPU_PREFIX_CACHE_ENABLED", "0")
    monkeypatch.setenv("RAY_TPU_SLO_DEFAULT_CLASS", "batch")
    monkeypatch.setenv("RAY_TPU_SLO_INTERACTIVE_RESERVED_SLOTS", "1")
    GLOBAL_CONFIG.refresh()
    try:
        engine = _make_engine(tiny_llama)
        assert engine._draft_len == 2 and engine._prefix is None
        assert engine._slo_reserved == 1
        assert engine.add_request([1], 1).slo_class == "batch"
        # An explicit config wins over the environment.
        engine = _make_engine(tiny_llama, spec_decode_draft_len=0,
                              prefix_cache_enabled=True)
        assert engine._draft_len == 0 and engine._prefix is not None
    finally:
        monkeypatch.undo()
        GLOBAL_CONFIG.refresh()
    # The engine's four flags are back at their defaults (the table holds
    # the runtime's flags too).
    engine_flags = ("prefix_cache_enabled", "spec_decode_draft_len",
                    "slo_default_class", "slo_interactive_reserved_slots")
    assert {k: GLOBAL_CONFIG.dump()[k] for k in engine_flags} == {
        "prefix_cache_enabled": True, "spec_decode_draft_len": 0,
        "slo_default_class": "interactive",
        "slo_interactive_reserved_slots": 0}
    assert not hasattr(EngineConfig(), "use_jit")
    # A tp that does not divide the KV heads (2 in tiny) is refused, as
    # the reference's `validate_tp` refuses it (a fake group of 4 ranks:
    # the refusal comes before any collective).
    with fake_tp_mesh(4) as mesh, pytest.raises(ValueError,
                                                match="n_kv_head"):
        InferenceEngine(EngineConfig(), model=tiny_llama, mesh=mesh)
    with pytest.raises(ValueError, match="lies on cpu"):
        InferenceEngine(EngineConfig(), model=tiny_llama, device="cuda:0")


# --------------------------------------------------------------------- #
# The slice as a whole: the JAX engine and the port's, same weights
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("draft_len", [0, 2])
def test_port_engine_emits_the_jax_engines_tokens(draft_len):
    from ray_tpu.inference import EngineConfig as JaxEngineConfig
    from ray_tpu.inference import InferenceEngine as JaxInferenceEngine
    from ray_tpu.models import llama as jllama

    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(seq=256),
                               dtype=jnp.float32)
    jmodel = jllama.Llama(jcfg)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 8), jnp.int32)))()
    state = tllama.params_from_jax(jax.tree.map(np.asarray,
                                                fnn.meta.unbox(params)))
    tmodel = tllama.Llama(
        dataclasses.replace(tllama.LlamaConfig.tiny(seq=256),
                            dtype=torch.float32), device="cpu", state=state)
    # Chunked prefill (prompts up to 20 tokens over chunks of 8), requests
    # queued behind 3 slots; then a second wave that extends two finished
    # prompts and hits the prefix cache.
    prompts = [[1 + i, 2 + i, 3 + i, 4 + i] * (i + 1) for i in range(5)]
    waves = [prompts, [prompts[3] + [9, 9], prompts[4]]]
    kwargs = dict(batch_slots=3, block_size=4, num_blocks=64,
                  max_blocks_per_seq=16, prefill_chunk=8,
                  spec_decode_draft_len=draft_len)
    outs = []
    for engine in (JaxInferenceEngine(JaxEngineConfig(**kwargs),
                                      model=jmodel, params=params),
                   InferenceEngine(EngineConfig(**kwargs), model=tmodel)):
        out = []
        for wave in waves:
            reqs = [engine.add_request(p, max_new_tokens=4 + 2 * i)
                    for i, p in enumerate(wave)]
            engine.run_until_idle()
            out += [r.generated for r in reqs]
        engine.check_no_leaks()
        assert engine.stats()["prefix_cache"]["hits"] == 2
        outs.append(out)
    assert outs[0] == outs[1]
