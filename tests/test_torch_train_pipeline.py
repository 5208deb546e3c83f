"""The port's pipeline training (`ray_tpu_torch.train.pipeline`), stage
split, sharded stage checkpoints and elastic pipeline gang, on the CPU: the
counterpart of tests/test_train_pipeline.py.

The parity spine, as in the JAX package: splitting the Llama into stages
and chaining per-stage gradients is BITWISE equal to the monolithic
backward, so schedule, width and transport comparisons within the port
assert exact equality. Against the JAX package (its `LlamaStage` and its
`LocalPipelineTrainer`, on weights carried by `params_from_jax`) the port
is held to float32 tolerances, stated at each test. The p2p cases drive two
ranks as threads over the raylets of one module-scoped port cluster (the
reference's harness); the gang cases run worker processes on it under
`BackendExecutor`; the checkpoint's tp meshes are 4 spawned gloo ranks.
Tensor-parallel stages (pp 2 x tp 2) run as a 4-worker gang whose gloo
group and mesh `TorchConfig(mesh=pipeline_mesh_spec(2))` forms; their
losses are held to pp 1 x tp 1 within 1e-5 relative (float32 summation
order over tp). JAX is imported only inside the `ref` fixture: the gloo
ranks import this file.
"""

import os
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.collective import CollectiveGroup, RayletTransport
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.train.checkpoint import (merge_sharded_manifest,
                                            save_sharded_pytree,
                                            sharded_manifest)
from ray_tpu_torch.train.pipeline import (LocalPipelineTrainer, adam_state,
                                          analytic_bubble,
                                          build_stage_programs,
                                          make_pipeline_train_fn,
                                          pipeline_mesh_spec,
                                          restore_pipeline_stage,
                                          save_pipeline_stage, seeded_batch,
                                          tiny_pipeline_config, token_xent)

from gloo_ranks import GlooRanks

STALL_S = 10.0
TP_RTOL = 1e-5


def _equal(a, b):
    """Two dicts of tensors (nested dicts allowed) equal bit for bit."""
    if a.keys() != b.keys():
        return False
    return all(_equal(a[k], b[k]) if isinstance(a[k], dict)
               else torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def cluster():
    """A head of 2 CPUs and a node of 2, the driver connected: the p2p
    ranks use both raylets, the gangs' workers fork from a template that
    holds torch and the pipeline module."""
    saved = dict(GLOBAL_CONFIG._overrides)
    GLOBAL_CONFIG._overrides.update({
        "collective_stall_timeout_s": STALL_S,
        "collective_inline_max_bytes": 1024,
        "collective_p2p_ack_window": 2,
        "rpc_connect_timeout_s": 2.0,
        # torch._dynamo: torch.optim imports it at an optimizer's first
        # step (~3 s here); it starts no thread, so the template may hold it.
        "worker_forge_preimports": (
            "ray_tpu_torch.core.worker,numpy,torch,torch._dynamo,"
            "ray_tpu_torch.train.pipeline"),
    })
    # Workers read the stall horizon from their environment.
    os.environ["RAY_TPU_COLLECTIVE_STALL_TIMEOUT_S"] = str(int(STALL_S))
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    c.add_node(num_cpus=2)
    c.wait_for_nodes()
    c.connect()
    try:
        yield c
    finally:
        c.shutdown()
        os.environ.pop("RAY_TPU_COLLECTIVE_STALL_TIMEOUT_S", None)
        GLOBAL_CONFIG._overrides.clear()
        GLOBAL_CONFIG._overrides.update(saved)


@pytest.fixture(scope="module", autouse=True)
def ranks():
    """Started with the module, so the ranks' imports overlap the tests
    before the one that uses them."""
    pool = GlooRanks(4, preload=__name__)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def ref():
    """The JAX package's side, on the CPU (conftest pins the platform),
    with its Llama's init on `tiny_pipeline_config` from seed 0, once,
    jitted (its eager dispatch takes four times as long), as numpy."""
    import flax.linen as fnn
    import jax

    from ray_tpu.models import llama
    from ray_tpu.train import pipeline

    cfg = pipeline.tiny_pipeline_config()
    sample = seeded_batch(0, 0, 2, 16, cfg.vocab_size)[0]
    init = jax.jit(lambda key: llama.Llama(cfg).init(key, sample)["params"])
    full = jax.tree.map(np.asarray,
                        fnn.meta.unbox(init(jax.random.PRNGKey(0))))
    return types.SimpleNamespace(jax=jax, llama=llama, pipeline=pipeline,
                                 cfg=cfg, full=full)


# --------------------------------------------------------------------------- #
# Collective p2p (send / isend / recv) on the port's plane
# --------------------------------------------------------------------------- #


def _run_pair(cluster, name, fn, join_s=60.0):
    """fn(rank, group) for ranks 0/1 on threads over the two raylets;
    returns (results, errors)."""
    results, errors = [None, None], [None, None]

    def run(rank):
        try:
            group = CollectiveGroup(
                name, 2, rank,
                transport=RayletTransport(cluster.raylets[rank]))
            try:
                results[rank] = fn(rank, group)
            finally:
                if rank == 0:
                    group.destroy()
                else:
                    group.leave()
        except Exception as e:  # noqa: BLE001 — asserted by callers
            errors[rank] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(join_s)
    assert not any(t.is_alive() for t in threads), "p2p rank thread hung"
    return results, errors


def test_p2p_ordering_mixed_payloads(cluster):
    """Messages on one channel arrive in send order across the
    inline/object size boundary, and channels with different tags never
    interleave."""
    def fn(rank, group):
        if rank == 0:
            for i in range(6):
                # odd sends cross the 1KB inline ceiling -> object path
                size = 8 if i % 2 == 0 else 4096
                group.send({"i": i, "data": np.full(size, i, np.uint8)}, 1)
            for i in range(3):
                group.send(("other", i), 1, tag="side")
            group.barrier()     # receiver drains before rank 0 destroys
            return None
        got = [group.recv(0) for _ in range(6)]
        side = [group.recv(0, tag="side") for _ in range(3)]
        group.barrier()
        return got, side

    results, errors = _run_pair(cluster, "p2p-order", fn)
    assert not any(errors), errors
    got, side = results[1]
    assert [g["i"] for g in got] == list(range(6))
    for g in got:
        assert (g["data"] == g["i"]).all()
    assert side == [("other", i) for i in range(3)]


def test_p2p_isend_call_order_survives_thread_races(cluster):
    """isend reserves the channel seq in the CALLER: many overlapping
    background posts still deliver in call order."""
    def fn(rank, group):
        if rank == 0:
            handles = [group.isend(np.full(4096, i, np.int32), 1)
                       for i in range(10)]
            for h in handles:
                h.wait(30.0)
            group.barrier()     # receiver drains before rank 0 destroys
            return None
        out = []
        for _ in range(10):
            time.sleep(0.01)    # receiver lags: window must flow-control
            out.append(int(group.recv(0)[0]))
        group.barrier()
        return out

    results, errors = _run_pair(cluster, "p2p-isend", fn)
    assert not any(errors), errors
    assert results[1] == list(range(10))


def test_p2p_bidirectional_streams_no_deadlock(cluster):
    """The 1F1B wire pattern: both ranks stream object-path messages at
    each other through a window of 2 while also receiving. A send blocking
    on its drain ack must not wedge the reverse channel."""
    n = 8

    def fn(rank, group):
        peer = 1 - rank
        got = []

        def pump():
            for i in range(n):
                group.send(np.full(4096, i * 10 + rank, np.int32), peer,
                           tag="fwd" if rank == 0 else "bwd")

        t = threading.Thread(target=pump)
        t.start()
        for _ in range(n):
            got.append(int(group.recv(peer,
                                      tag="bwd" if rank == 0 else "fwd")[0]))
        t.join(30.0)
        group.barrier()
        return got

    results, errors = _run_pair(cluster, "p2p-bidi", fn)
    assert not any(errors), errors
    assert results[0] == [i * 10 + 1 for i in range(n)]
    assert results[1] == [i * 10 for i in range(n)]


# --------------------------------------------------------------------------- #
# Stage-split parity
# --------------------------------------------------------------------------- #


def test_llama_stage_matches_reference_at_pp2(ref):
    """The port's LlamaStage at pp 2 on the reference's weights: stage 0's
    boundary activations, the loss and every stage-chained gradient
    against the reference's own stage programs (float32 on both sides,
    summation order apart: 1e-5 atol and rtol)."""
    cfg, jcfg, full_np = tiny_pipeline_config(), ref.cfg, ref.full
    ids, tg = seeded_batch(0, 0, 2, 16, cfg.vocab_size)

    jstages = ref.llama.split_stage_params(full_np, jcfg, 2)
    jp = [ref.pipeline.build_stage_programs(jcfg, s, 2) for s in range(2)]
    jy = jp[0].fwd(jstages[0], ids)
    jloss, jg1, jgx = jp[1].fwdbwd(jstages[1], jy, tg)
    jg0 = jp[0].bwd(jstages[0], ids, jgx)
    want_grads = tllama.params_from_jax(
        ref.jax.tree.map(np.asarray, {**jg0, **jg1}))

    stages = tllama.split_stage_params(tllama.params_from_jax(full_np),
                                       cfg, 2)
    mods = [tllama.LlamaStage(cfg, s, 2, device="cpu", state=stages[s])
            for s in range(2)]
    assert set(mods[0].state_dict()) == set(stages[0])
    tp = [build_stage_programs(cfg, s, 2, "cpu") for s in range(2)]
    y = tp[0].fwd(stages[0], ids)
    assert torch.equal(y, mods[0](torch.from_numpy(ids)).detach())
    loss, g1, gx = tp[1].fwdbwd(stages[1], y, tg)
    g0 = tp[0].bwd(stages[0], ids, gx)
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(loss.item(), float(jloss), **tol)
    got = {**g0, **g1}
    assert got.keys() == want_grads.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want_grads[k].numpy(),
                                   err_msg=k, **tol)


def test_stage_chain_bitwise_vs_monolithic_grad():
    """pp 3 chained stage programs (fwd / fused last / middle and first
    bwd) reproduce the monolithic model's loss and gradients BIT FOR BIT,
    a middle stage's bwd differentiating both params and input."""
    cfg = tiny_pipeline_config(n_layer=3)
    ids, tg = seeded_batch(1, 0, 2, 16, cfg.vocab_size)
    model = tllama.Llama(cfg, device="cpu", seed=0)
    loss_ref = token_xent(model(torch.from_numpy(ids)), torch.from_numpy(tg))
    names = [n for n, _ in model.named_parameters()]
    grad_ref = dict(zip(names, torch.autograd.grad(
        loss_ref, list(model.parameters()))))

    pp = 3
    progs = [build_stage_programs(cfg, s, pp, "cpu") for s in range(pp)]
    stages = tllama.split_stage_params(
        {k: v.detach() for k, v in model.named_parameters()}, cfg, pp)
    y0 = progs[0].fwd(stages[0], ids)
    y1 = progs[1].fwd(stages[1], y0)
    loss, gp2, gy1 = progs[2].fwdbwd(stages[2], y1, tg)
    gp1, gy0 = progs[1].bwd(stages[1], y0, gy1)
    gp0 = progs[0].bwd(stages[0], ids, gy0)

    assert torch.equal(loss, loss_ref.detach())
    want = tllama.split_stage_params(grad_ref, cfg, pp)
    for got, w in zip((gp0, gp1, gp2), want):
        assert _equal(got, w)


def test_stage_seed_init_is_the_whole_models():
    """`LlamaStage(seed=)` at every pp draws the whole model's weights:
    the stages merge into `Llama(seed=)`'s state dict, bit for bit."""
    cfg = tiny_pipeline_config(n_layer=3)
    full = tllama.Llama(cfg, device="cpu", seed=5).state_dict()
    for pp in (1, 2, 3):
        parts = [tllama.LlamaStage(cfg, s, pp, device="cpu",
                                   seed=5).state_dict() for s in range(pp)]
        assert _equal(tllama.merge_stage_params(parts), full)
        assert [set(p) for p in parts] == \
            [set(p) for p in tllama.split_stage_params(full, cfg, pp)]
    assert tllama.stage_layer_ranges(cfg, 2) == [(0, 2), (2, 3)]
    with pytest.raises(ValueError):
        tllama.merge_stage_params([{"embed": 1}, {"embed": 2}])


def _run(cfg, pp, m, steps, batch, schedule="1f1b", **kw):
    t = LocalPipelineTrainer(cfg, pp=pp, num_microbatches=m, seed=0,
                             schedule=schedule, device="cpu", **kw)
    losses = []
    for step in range(steps):
        ids, tg = seeded_batch(0, step, batch, 16, cfg.vocab_size)
        losses.append(t.train_step(ids, tg)["loss"])
    return losses, t


def test_pp2_training_bitwise_vs_pp1():
    """Three Adam steps at pp 2 match pp 1 step for step: losses, merged
    weights and Adam state bitwise."""
    cfg = tiny_pipeline_config()
    l1, t1 = _run(cfg, 1, 2, 3, 4)
    l2, t2 = _run(cfg, 2, 2, 3, 4)
    assert l1 == l2
    assert _equal(t1.merged_params(), t2.merged_params())
    assert _equal(t1.merged_adam_state(), t2.merged_adam_state())


def test_1f1b_and_sequential_schedules_bitwise_equal():
    """Same microbatch accumulation order => the overlapped schedule and
    the serialized A/B give identical losses and weights; the schedules
    differ only in warm-up depth (call counts prove both ran every
    microbatch exactly once per direction)."""
    cfg = tiny_pipeline_config()
    m = 4
    la, a = _run(cfg, 2, m, 2, 8, "1f1b")
    lb, b = _run(cfg, 2, m, 2, 8, "sequential")
    assert la == lb
    assert _equal(a.merged_params(), b.merged_params())
    for trainer in (a, b):
        for st in trainer.last_result.stage_stats:
            assert st.fwd_calls == m and st.bwd_calls == m
            assert 0.0 <= st.bubble_frac <= 1.0
            assert st.analytic_bubble_frac == analytic_bubble(2, m)
    assert analytic_bubble(2, 4) == pytest.approx(1 / 5)
    assert analytic_bubble(4, 8) == pytest.approx(3 / 11)
    assert analytic_bubble(1, 4) == 0.0
    with pytest.raises(ValueError, match="unknown schedule"):
        _run(cfg, 2, m, 1, 8, "gpipe")


def test_local_trainer_matches_reference(ref, monkeypatch):
    """The port's LocalPipelineTrainer at pp 2 against the reference's at
    pp 1 (its pp 2 is bitwise its pp 1) over 4 Adam steps (lr 1e-2), from
    the reference's weights. Losses within 1e-5 relative. Weights: Adam's
    first step moves each element by lr * g / (|g| + eps), about lr for
    any gradient well above eps = 1e-8 whatever its rounding, so two
    float32 runs agree to ~lr * 1e-6 there; where a gradient is zero in
    exact arithmetic (ROADMAP queue 3, "AdamW's first step") its rounding
    noise, ~1e-10 here, becomes a step of up to lr * 1e-10 / 1e-8 = 1e-4,
    and 4 steps keep that size: atol 2e-4."""
    cfg, jcfg, full_np = tiny_pipeline_config(), ref.cfg, ref.full
    # The reference trainer's own init is the fixture's, already made (its
    # eager flax init takes ~8 s here).
    monkeypatch.setattr(ref.llama.Llama, "init",
                        lambda self, key, ids: {"params": dict(full_np)})
    jt = ref.pipeline.LocalPipelineTrainer(jcfg, pp=1, num_microbatches=2,
                                           seed=0)
    t = LocalPipelineTrainer(cfg, pp=2, num_microbatches=2, device="cpu")
    with torch.no_grad():
        for s, stage in enumerate(tllama.split_stage_params(
                tllama.params_from_jax(full_np), cfg, 2)):
            for name, v in stage.items():
                t.params[s][name].copy_(v)
    for step in range(4):
        ids, tg = seeded_batch(0, step, 4, 16, cfg.vocab_size)
        want = jt.train_step(ids, tg)["loss"]
        got = t.train_step(ids, tg)["loss"]
        assert abs(got - want) <= 1e-5 * abs(want), (step, got, want)
    want = tllama.params_from_jax(ref.jax.tree.map(np.asarray,
                                                   jt.merged_params()))
    got = t.merged_params()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=2e-4, rtol=0, err_msg=k)


# --------------------------------------------------------------------------- #
# Sharded stage checkpoints
# --------------------------------------------------------------------------- #


def _adam_like(params, seed):
    """An Adam state for `params` with nonzero moments and step 3."""
    gen = torch.Generator().manual_seed(seed)
    return {k: {"step": torch.tensor(3.0),
                "exp_avg": torch.randn(v.shape, generator=gen),
                "exp_avg_sq": torch.rand(v.shape, generator=gen)}
            for k, v in params.items()}


def _checkpoint_rank(rank, path):
    """Save at (tp 2, pp 2): ranks 2s and 2s + 1 hold stage s over a tp 2
    mesh (DTensor params and moments by the Llama partition rules); rank 0
    merges. Then restore at (1, 1), at (4, 1) over all 4 ranks and at
    (1, 2), each against the split of the same whole state."""
    from torch.distributed.tensor import DTensor, Shard

    cfg = tiny_pipeline_config()
    full = tllama.Llama(cfg, device="cpu", seed=0).state_dict()
    opt = _adam_like(full, 1)
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"pp": 2, "tp": 2}),
                            device_type="cpu")
    stage, tp_rank = rank // 2, rank % 2
    tp_mesh = mesh["tp"]
    params = tllama.split_stage_params(full, cfg, 2)[stage]
    sharded =tllama.shard_stage_params(params, tp_mesh)
    exp_avg = tllama.shard_stage_params(
        {k: opt[k]["exp_avg"] for k in params}, tp_mesh)
    exp_avg_sq = tllama.shard_stage_params(
        {k: opt[k]["exp_avg_sq"] for k in params}, tp_mesh)
    moments = {k: {"step": opt[k]["step"], "exp_avg": exp_avg[k],
                   "exp_avg_sq": exp_avg_sq[k]} for k in params}
    assert all(isinstance(v, DTensor) for v in sharded.values())
    save_pipeline_stage(path, {"params": sharded, "opt": moments}, stage,
                        2, step=0, tp_rank=tp_rank, tp=2)
    dist.barrier()
    if rank == 0:
        merge_sharded_manifest(path, 4)
    dist.barrier()

    bad = []
    st = restore_pipeline_stage(path, cfg, 0, 1, device="cpu")
    if not (_equal(st["params"], full) and _equal(st["opt"], opt)):
        bad.append("(1, 1)")
    mesh4 = tmesh.build_mesh(tmesh.MeshSpec({"tp": 4}), device_type="cpu")
    st = restore_pipeline_stage(path, cfg, 0, 1, mesh=mesh4, device="cpu")
    embed = st["params"]["embed"]
    if tuple(embed.placements) != (Shard(0),):
        bad.append(f"embed placed {embed.placements}")
    if not _equal({k: v.full_tensor() for k, v in st["params"].items()},
                  full):
        bad.append("(4, 1)")
    for s in range(2):
        st = restore_pipeline_stage(path, cfg, s, 2, device="cpu")
        want = tllama.split_stage_params(full, cfg, 2)[s]
        if not (_equal(st["params"], want) and
                _equal(st["opt"], {k: opt[k] for k in want})):
            bad.append(f"(1, 2) stage {s}")
    return bad


def test_stage_checkpoint_reshard_round_trips(ranks, tmp_path):
    """(tp 2, pp 2) save -> restore at (1, 1), (4, 1) and (1, 2): all
    bitwise (raw-byte shard assembly), Adam state included, on 4 gloo
    ranks; at tp 4 the embedding lands `Shard(0)`."""
    path = str(tmp_path / "ck")
    assert ranks.run(_checkpoint_rank, path) == [[]] * 4
    manifest = sharded_manifest(path)
    assert manifest["process_count"] == 4 and manifest["meta"]["tp"] == 2
    # wq is split over tp by rows: two shards of 16 of its 32 rows.
    shards = manifest["entries"]["params/layers.0.wq.weight"]["shards"]
    assert sorted(s["index"][0] for s in shards) == [[0, 16], [16, 32]]


def test_stage_checkpoint_missing_stage_fails_loudly(tmp_path):
    """A merge over a world where one stage never saved must raise, not
    produce a manifest that restores garbage for the absent subtree."""
    cfg = tiny_pipeline_config()
    full = tllama.Llama(cfg, device="cpu", seed=0).state_dict()
    stage0 = tllama.split_stage_params(full, cfg, 2)[0]
    path = str(tmp_path / "ck")
    save_pipeline_stage(path, {"params": stage0,
                               "opt": adam_state(stage0)}, 0, 2, step=0)
    with pytest.raises(FileNotFoundError):
        merge_sharded_manifest(path, 2)


def test_replicated_leaves_need_owner_for_stage_saves(tmp_path):
    """The hazard own_replicated=True exists for: a NON-zero rank saving a
    disjoint subtree under SPMD ownership rules writes zero-coverage
    entries for its replicated leaves, and the merge rejects them."""
    tree = {"scale": torch.ones(4)}
    path = str(tmp_path / "ck")
    save_sharded_pytree(path, {}, process_index=0, process_count=2)
    save_sharded_pytree(path, tree, process_index=1, process_count=2)
    with pytest.raises(ValueError, match="covers only"):
        merge_sharded_manifest(path, 2)


# --------------------------------------------------------------------------- #
# Elastic pipeline runs (worker processes)
# --------------------------------------------------------------------------- #


def _drain(executor, train_fn, name):
    per_step = {}
    for rnd in executor.run(train_fn, {}, device="cpu",
                            experiment_name=name):
        for r in rnd:
            m = r["metrics"]
            per_step.setdefault(m["step"], {}).update(
                {k: m[k] for k in ("world", "loss") if k in m})
    return per_step


def _local_run(steps):
    cfg = tiny_pipeline_config()
    local = LocalPipelineTrainer(cfg, pp=1, num_microbatches=2, seed=0,
                                 device="cpu")
    losses = []
    for step in range(steps):
        ids, tg = seeded_batch(0, step, 4, 16, cfg.vocab_size)
        losses.append(local.train_step(ids, tg)["loss"])
    return losses, local


def test_pipeline_worker_run_matches_local_bitwise(cluster, tmp_path):
    """pp 2 over worker processes and the collective plane's p2p
    reproduces the single-process pp 1 run bitwise, step for step, and its
    last merged checkpoint restores the local run's weights and Adam
    state."""
    from ray_tpu_torch.train.backend import BackendConfig
    from ray_tpu_torch.train.backend_executor import BackendExecutor
    from ray_tpu_torch.train.config import ScalingConfig

    steps = 4
    train_fn = make_pipeline_train_fn(
        steps=steps, microbatches=2, batch=4, seq=16, lr=1e-2, seed=0,
        ckpt_dir=str(tmp_path / "ck"))
    ex = BackendExecutor(BackendConfig(),
                         ScalingConfig(num_workers=2, use_gpu=False))
    ex.start()
    try:
        per_step = _drain(ex, train_fn, "pipe_parity")
        final = ex.latest_checkpoint.to_dict()
    finally:
        ex.shutdown()

    losses, local = _local_run(steps)
    assert [per_step[s]["loss"] for s in range(steps)] == losses
    assert all(per_step[s]["world"] == 2 for s in range(steps))
    st = restore_pipeline_stage(final["path"], tiny_pipeline_config(), 0, 1,
                                device="cpu")
    assert _equal(st["params"], local.merged_params())
    assert _equal(st["opt"], local.merged_adam_state())


def test_kill_a_stage_resharded_resume_bitwise(cluster, tmp_path):
    """Kill one stage's worker mid-run: the gang restarts SHRUNK to pp 1
    (`elastic_world_fn`) under the reference's 180 s recovery deadline,
    restores the merged pp 2 manifest re-split at the new width, and
    finishes with weights bitwise-equal to an unkilled run."""
    from ray_tpu_torch.train.backend import BackendConfig
    from ray_tpu_torch.train.backend_executor import BackendExecutor
    from ray_tpu_torch.train.config import ScalingConfig

    steps = 8
    train_fn = make_pipeline_train_fn(
        steps=steps, microbatches=2, batch=4, seq=16, lr=1e-2, seed=0,
        ckpt_dir=str(tmp_path / "ck"))
    deadline = time.monotonic() + 180.0
    ex = BackendExecutor(BackendConfig(),
                         ScalingConfig(num_workers=2, use_gpu=False),
                         max_failures=2,
                         elastic_world_fn=lambda fail, world: 1)
    ex.start()
    victim = ex.worker_group.procs[1]["pid"]

    def killer():
        # Wait for a merged checkpoint so the resume is a genuine RESHARD
        # (pp 2 manifest -> pp 1 restore), then kill stage 1's process.
        while time.monotonic() < deadline:
            ck = ex.latest_checkpoint
            if ck is not None and ck.to_dict().get("step", -1) >= 1:
                os.kill(victim, signal.SIGKILL)
                return
            time.sleep(0.01)

    threading.Thread(target=killer, daemon=True).start()
    try:
        per_step = _drain(ex, train_fn, "pipe_kill")
        final = ex.latest_checkpoint.to_dict()
        restarts = list(ex.restarts)
    finally:
        ex.shutdown()

    assert time.monotonic() < deadline, "recovery blew the 180 s deadline"
    assert restarts and restarts[0]["world_size"] == 1, restarts
    assert final["step"] == steps - 1 and final["pp"] == 1
    worlds = {s: v["world"] for s, v in per_step.items()}
    assert 2 in worlds.values() and 1 in worlds.values(), worlds
    _, local = _local_run(steps)
    st = restore_pipeline_stage(final["path"], tiny_pipeline_config(), 0, 1,
                                device="cpu")
    assert _equal(st["params"], local.merged_params())
    assert _equal(st["opt"], local.merged_adam_state())


# --------------------------------------------------------------------------- #
# Launch counters under stage threads
# --------------------------------------------------------------------------- #


def test_launch_counters_count_every_thread():
    """Pipeline stages launch the kernels from threads of their own: the
    counts (`count_launch`, which every wrapper calls where it launches)
    lose no launch when 8 threads raise them at once."""
    from ray_tpu_torch.ops import attention as tattn

    n, names = 20_000, tattn.KERNELS
    before = tattn.kernel_launches()
    start = threading.Barrier(8)

    def work(i):
        start.wait()
        for _ in range(n):
            tattn.count_launch(names[i % len(names)])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    after = tattn.kernel_launches()
    want = {name: sum(n for i in range(8) if names[i % len(names)] == name)
            for name in names}
    assert {k: after[k] - before[k] for k in names} == want


# --------------------------------------------------------------------------- #
# Tensor-parallel stages: pp 2 x tp 2 gangs, their checkpoints, GPT-2's
# (dp, tp) checkpoints and the shard gang's mesh
# --------------------------------------------------------------------------- #


def _tp_executor(world, **kw):
    from ray_tpu_torch.train.backend import TorchConfig
    from ray_tpu_torch.train.backend_executor import BackendExecutor
    from ray_tpu_torch.train.config import ScalingConfig

    return BackendExecutor(
        TorchConfig(backend="gloo", mesh=pipeline_mesh_spec(2)),
        ScalingConfig(num_workers=world, use_gpu=False), **kw)


def _restore_tp2(rank, path):
    """Restore a merged stage checkpoint at (tp 2, pp 1), ranks 0-1 and
    2-3 each a tp line: whole params and moments, and the placements."""
    cfg = tiny_pipeline_config()
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"dp": 2, "tp": 2}),
                            device_type="cpu")
    st = restore_pipeline_stage(path, cfg, 0, 1, mesh=mesh["tp"],
                                device="cpu")
    placed = {k: (tuple(v.placements), tuple(st["opt"][k]["exp_avg"]
                                             .placements))
              for k, v in st["params"].items()}
    params = {k: v.full_tensor() for k, v in st["params"].items()}
    opt = {k: {"step": v["step"], "exp_avg": v["exp_avg"].full_tensor(),
               "exp_avg_sq": v["exp_avg_sq"].full_tensor()}
           for k, v in st["opt"].items()}
    return params, opt, placed


def _check_restores(ranks, path, pp):
    """The merged checkpoint at `path` restores bitwise alike at (tp, pp)
    = (1, 1), (1, 2) and (2, 1); returns the (1, 1) state."""
    cfg = tiny_pipeline_config()
    whole = restore_pipeline_stage(path, cfg, 0, 1, device="cpu")
    parts = [restore_pipeline_stage(path, cfg, s, 2, device="cpu")
             for s in range(2)]
    assert _equal(tllama.merge_stage_params([p["params"] for p in parts]),
                  whole["params"])
    assert _equal(tllama.merge_stage_params([p["opt"] for p in parts]),
                  whole["opt"])
    for params, opt, placed in ranks.run(_restore_tp2, path):
        assert _equal(params, whole["params"]) and _equal(opt, whole["opt"])
        assert placed["layers.0.wq.weight"] == ((Shard(0),), (Shard(0),))
        assert placed["layers.0.wo.weight"] == ((Shard(1),), (Shard(1),))
    return whole


def test_pipeline_tp2_gang_matches_pp1_and_restores_at_any_width(
        cluster, ranks, tmp_path):
    """`make_pipeline_train_fn(tp=2)` at pp 2 x tp 2 (4 gloo workers, each
    stage over its tp line, boundaries between (s, t) and (s +- 1, t))
    gives the losses of pp 1 x tp 1 within 1e-5 relative; its merged
    per-step checkpoint (written by all 4 ranks, DTensor shards and
    moments) restores bitwise alike at (tp, pp) = (1, 1), (1, 2) and
    (2, 1), within Adam's noise (2e-4, as the reference test above) of
    the single-process run's weights."""
    steps = 4
    train_fn = make_pipeline_train_fn(
        steps=steps, microbatches=2, batch=4, seq=16, lr=1e-2, seed=0,
        ckpt_dir=str(tmp_path / "ck"), tp=2)
    ex = _tp_executor(4)
    ex.start()
    try:
        per_step = _drain(ex, train_fn, "pipe_tp2")
        final = ex.latest_checkpoint.to_dict()
    finally:
        ex.shutdown()
    losses, local = _local_run(steps)
    for s in range(steps):
        assert per_step[s]["world"] == 4
        assert abs(per_step[s]["loss"] - losses[s]) <= \
            TP_RTOL * abs(losses[s]), (s, per_step[s], losses[s])
    assert (final["step"], final["pp"], final["tp"]) == (steps - 1, 2, 2)
    manifest = sharded_manifest(final["path"])
    assert manifest["process_count"] == 4
    shards = manifest["entries"]["params/layers.0.wq.weight"]["shards"]
    assert sorted(sh["index"][0] for sh in shards) == [[0, 16], [16, 32]]
    whole = _check_restores(ranks, final["path"], 2)
    for name, want in local.merged_params().items():
        np.testing.assert_allclose(whole["params"][name].numpy(),
                                   want.numpy(), atol=2e-4, rtol=0,
                                   err_msg=name)


def test_kill_a_tp_stage_resumes_at_pp1_tp2(cluster, ranks, tmp_path):
    """Kill one rank of a pp 2 x tp 2 gang after a merged checkpoint: the
    gang restarts at 2 workers (pp 1 x tp 2, `elastic_world_fn`) under
    the reference's 180 s deadline, restores the pp 2 manifest onto its tp
    line, and finishes every step; its losses stay within 1e-5 of pp 1 x
    tp 1's, and the last checkpoint restores bitwise at every width."""
    steps = 6
    train_fn = make_pipeline_train_fn(
        steps=steps, microbatches=2, batch=4, seq=16, lr=1e-2, seed=0,
        ckpt_dir=str(tmp_path / "ck"), tp=2)
    deadline = time.monotonic() + 180.0
    ex = _tp_executor(4, max_failures=2,
                      elastic_world_fn=lambda fail, world: 2)
    ex.start()
    victim = ex.worker_group.procs[3]["pid"]

    def killer():
        while time.monotonic() < deadline:
            ck = ex.latest_checkpoint
            if ck is not None and ck.to_dict().get("step", -1) >= 1:
                os.kill(victim, signal.SIGKILL)
                return
            time.sleep(0.01)

    threading.Thread(target=killer, daemon=True).start()
    try:
        per_step = _drain(ex, train_fn, "pipe_tp2_kill")
        final = ex.latest_checkpoint.to_dict()
        restarts = list(ex.restarts)
    finally:
        ex.shutdown()
    assert time.monotonic() < deadline, "recovery blew the 180 s deadline"
    assert restarts and restarts[0]["world_size"] == 2, restarts
    assert (final["step"], final["pp"], final["tp"]) == (steps - 1, 1, 2)
    worlds = {s: v["world"] for s, v in per_step.items()}
    assert 4 in worlds.values() and 2 in worlds.values(), worlds
    losses, _ = _local_run(steps)
    for s in range(steps):
        assert abs(per_step[s]["loss"] - losses[s]) <= \
            TP_RTOL * abs(losses[s]), (s, per_step[s], losses[s])
    _check_restores(ranks, final["path"], 1)


def _gpt2_checkpoint_rank(rank, path, src, dst):
    """GPT-2 tiny on mesh `src` takes one AdamW step and saves its DTensor
    parameters and moments from all 4 ranks (rank 0 merges); then the
    checkpoint restores on mesh `dst` into a model placed there, and every
    value must equal the saved one bit for bit, in the new model's
    placements. Returns the saved state, whole, and what failed."""
    import dataclasses

    from ray_tpu_torch.models import gpt2 as tgpt2
    from ray_tpu_torch.parallel.sharding import shard_batch
    from ray_tpu_torch.parallel.tensor_parallel import full_state, place_like
    from ray_tpu_torch.train.checkpoint import restore_sharded_pytree

    cfg = dataclasses.replace(tgpt2.GPT2Config.tiny(seq=16),
                              dtype=torch.float32)
    mesh = tmesh.build_mesh(tmesh.MeshSpec(src), device_type="cpu")
    model = tgpt2.GPT2(cfg, mesh=mesh, seed=0)
    opt = tgpt2.adamw(model)
    step = tgpt2.make_train_step(model, opt, mesh=mesh)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)))
    step(shard_batch({"input_ids": ids, "labels": ids}, mesh))

    def moments(m, o):
        return {n: {"step": o.state[p]["step"],
                    "exp_avg": o.state[p]["exp_avg"],
                    "exp_avg_sq": o.state[p]["exp_avg_sq"]}
                for n, p in m.named_parameters()}

    tree = {"params": dict(model.named_parameters()),
            "opt": moments(model, opt)}
    save_sharded_pytree(path, tree, process_index=rank, process_count=4,
                        meta=src)
    dist.barrier()
    if rank == 0:
        merge_sharded_manifest(path, 4)
    dist.barrier()
    saved = {"params": full_state(model),
             "opt": {n: {k: v.full_tensor() if hasattr(v, "full_tensor")
                         else v for k, v in st.items()}
                     for n, st in moments(model, opt).items()}}

    bad = []
    target = tgpt2.GPT2(cfg, mesh=tmesh.build_mesh(tmesh.MeshSpec(dst),
                                                   device_type="cpu"),
                        seed=1)
    target_opt = tgpt2.adamw(target)
    whole = restore_sharded_pytree(path)
    with torch.no_grad():
        for name, p in target.named_parameters():
            value = place_like(whole["params"][name], p)
            if tuple(value.placements) != tuple(p.placements):
                bad.append(f"{name} placed {value.placements}")
            p.copy_(value)
            target_opt.state[p] = {
                k: place_like(whole["opt"][name][k], p) if k != "step"
                else whole["opt"][name][k] for k in ("step", "exp_avg",
                                                     "exp_avg_sq")}
    got = {"params": full_state(target),
           "opt": {n: {k: v.full_tensor() if hasattr(v, "full_tensor")
                       else v for k, v in st.items()}
                   for n, st in moments(target, target_opt).items()}}
    if not _equal(got, saved):
        bad.append(f"restored at {dst}")
    return saved, bad


@pytest.mark.parametrize("src,dst", [
    ({"dp": 2, "tp": 2}, {"dp": 1, "tp": 4}),
    ({"fsdp": 2, "tp": 2}, {"dp": 2, "tp": 2})])
def test_gpt2_mesh_checkpoint_restores_bitwise(ranks, tmp_path, src, dst):
    """A GPT-2 checkpoint with AdamW's moments saved at (dp 2, tp 2) (each
    dp replica's copy written once) or at (fsdp 2, tp 2) (FSDP2's shards,
    strided on the tp-sharded biases) restores bit-exact at (dp, tp) =
    (1, 1), whole into a model on one device, and at (1, 4) or (2, 2),
    placed as that mesh's model places its parameters."""
    from ray_tpu_torch.models import gpt2 as tgpt2
    from ray_tpu_torch.train.checkpoint import restore_sharded_pytree

    path = str(tmp_path / "gpt2")
    results = ranks.run(_gpt2_checkpoint_rank, path, src, dst)
    assert [bad for _, bad in results] == [[]] * 4
    saved = results[0][0]
    assert sharded_manifest(path)["meta"] == src
    whole = restore_sharded_pytree(path)
    assert _equal(whole, saved)
    cfg = tgpt2.GPT2Config.tiny(seq=16)
    model = tgpt2.GPT2(cfg, device="cpu", state=whole["params"])
    assert _equal({k: v.detach() for k, v in model.named_parameters()},
                  saved["params"])


class _MeshRank:
    """A gang rank that answers with its stage mesh and a tp all-reduce."""

    def __call__(self, payload):
        return payload

    def mesh(self):
        from ray_tpu_torch import shardgroup

        mesh = shardgroup.current_mesh()
        ones = torch.ones(1) * (dist.get_rank() + 1)
        dist.all_reduce(ones, group=mesh.get_group("tp"))
        return (shardgroup.current().rank, tuple(mesh.mesh_dim_names),
                tuple(mesh.mesh.shape), tuple(mesh.get_coordinate()),
                mesh.device_type, int(ones.item()))


@pytest.mark.parametrize("sp,tp", [(1, 2), (2, 2)])
def test_gang_current_mesh_at_tp2_and_sp2_tp2(cluster, sp, tp):
    """A shard gang of sp x tp ranks (one a card; CPU ranks here) builds
    its ("sp", "tp") DeviceMesh over its gloo group at bring-up, size-1
    axes dropped, and a collective over its tp group runs."""
    from ray_tpu_torch import shardgroup

    group = shardgroup.create_replica_group(
        _MeshRank, shardgroup.ShardSpec(tp=tp, sp=sp, world_size=sp * tp),
        deployment_name=f"mesh-sp{sp}-tp{tp}",
        actor_options={"num_cpus": 0.5,
                       "runtime_env": {"env_vars": {"OMP_NUM_THREADS": "1"}}})
    try:
        views = ray_tpu_torch.get([r.handle_request.remote("mesh", (), {})
                                   for r in group.ranks], timeout=60)
    finally:
        group.kill()
    names = ("sp", "tp") if sp > 1 else ("tp",)
    shape = (sp, tp) if sp > 1 else (tp,)
    for rank, view in enumerate(views):
        coord = (rank // tp, rank % tp) if sp > 1 else (rank,)
        # The tp line of rank r holds ranks r - r % tp and the next.
        line = rank - rank % tp
        assert view == (rank, names, shape, coord, "cpu",
                        (line + 1) + (line + 2)), view
