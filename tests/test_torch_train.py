"""The PyTorch port's trainer, device rule and import rule, on the CPU.

`TorchTrainer.fit` runs its loop in worker actors of the port's runtime,
which one module-scoped `ray_tpu_torch.init` starts; every loop below is a
module-level function, so the workers import it from this file. The
Data-fed cases (`datasets=`) mirror the reference's trainer cases in
tests/test_data.py and test_data_streaming.py; `TorchPredictor` and
`BatchPredictor` are held against the JAX package's `JaxPredictor` on a
tiny GPT-2 whose weights `params_from_jax` carries (Pallas in interpret
mode).
"""

import ast
import dataclasses
import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import _torch_env, resolve_device
from ray_tpu_torch import data as rd
from ray_tpu_torch.models import gpt2
from ray_tpu_torch import train as train_api
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.train import (BatchPredictor, Checkpoint,
                                 CheckpointConfig, FailureConfig, RunConfig,
                                 ScalingConfig, TorchPredictor, TorchTrainer,
                                 TrainingFailedError, session)

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.train.batch_predictor import JaxPredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def runtime():
    # The forge template preimports torch, so a forked worker starts with
    # it loaded (the flag's documented use for torch-heavy workers).
    ray_tpu_torch.init(num_cpus=4, _system_config={
        "worker_forge_preimports": "ray_tpu_torch.core.worker,numpy,torch"})
    yield
    ray_tpu_torch.shutdown()


def _loop(config):
    device = session.get_device()
    assert session.get_context().world_size == 1
    cfg = gpt2.GPT2Config.tiny(seq=64)
    model = gpt2.GPT2(cfg, device=device, seed=0)
    step = gpt2.make_train_step(model, gpt2.adamw(model, lr=1e-3))
    ids = torch.randint(0, cfg.vocab_size, (2, 64),
                        generator=torch.Generator().manual_seed(0))
    for i in range(config["steps"]):
        session.report({"step": i, "loss": step({"input_ids": ids,
                                                  "labels": ids}).item()})


def test_fit_on_cpu_reports_a_falling_loss(tmp_path):
    result = TorchTrainer(
        _loop, train_loop_config={"steps": 3}, device="cpu",
        run_config=RunConfig(name="t", storage_path=str(tmp_path))).fit()
    losses = [m["loss"] for m in result.metrics_history]
    assert [m["step"] for m in result.metrics_history] == [0, 1, 2]
    assert losses[2] < losses[0]
    assert result.metrics == result.metrics_history[-1]
    assert result.path == os.path.join(str(tmp_path), "t")
    with pytest.raises(RuntimeError):
        session.report({"loss": 0.0})  # the session ends with fit()


# float32 and SGD: one worker on the whole batch and two on its halves then
# differ only in summation order (AdamW's first step turns such noise into
# part of the step, ROADMAP "AdamW's first step"); so do a worker's threads
# and the test process's.
_DP_CFG = dataclasses.replace(gpt2.GPT2Config.tiny(seq=32),
                              dtype=torch.float32)
_DP_BATCH = torch.randint(0, _DP_CFG.vocab_size, (4, 32),
                          generator=torch.Generator().manual_seed(1))


def _sgd_steps(device, n):
    model = gpt2.GPT2(_DP_CFG, device=device, seed=0)
    step = gpt2.make_train_step(model, torch.optim.SGD(model.parameters(),
                                                       lr=0.5))
    batch = {"input_ids": _DP_BATCH, "labels": _DP_BATCH}
    return [step(batch).item() for _ in range(n)]


def _direct_loop(config):
    for i, loss in enumerate(_sgd_steps(session.get_device(), 3)):
        session.report({"step": i, "loss": loss})


def test_one_worker_actor_losses_match_make_train_step():
    result = TorchTrainer(_direct_loop, device="cpu").fit()
    assert result.error is None
    got = [m["loss"] for m in result.metrics_history]
    np.testing.assert_allclose(got, _sgd_steps("cpu", 3), rtol=1e-6, atol=0)
    assert got[2] < got[0]


def _dp_loop(config):
    rank = session.get_world_rank()
    world = session.get_world_size()
    model = gpt2.GPT2(_DP_CFG, device=session.get_device(), seed=0)
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    ids = _DP_BATCH.chunk(world)[rank]
    for i in range(2):
        opt.zero_grad()
        loss = gpt2.next_token_loss(model(ids), ids)
        loss.backward()
        session.sync_gradients([p.grad for p in model.parameters()])
        opt.step()
        session.report({"step": i, "loss": loss.item()})
    if rank == 0:
        session.report({"step": 2}, checkpoint=Checkpoint.from_state_dict(
            model.state_dict()))


def test_two_gloo_workers_with_sync_gradients_match_one_worker(tmp_path):
    states = []
    for n in (1, 2):
        result = TorchTrainer(
            _dp_loop, device="cpu",
            scaling_config=ScalingConfig(num_workers=n),
            run_config=RunConfig(name=f"dp{n}",
                                 storage_path=str(tmp_path))).fit()
        assert result.error is None, result.error
        states.append(result.checkpoint.get_state_dict())
    assert states[0].keys() == states[1].keys()
    for key in states[0]:
        np.testing.assert_allclose(states[1][key].numpy(),
                                   states[0][key].numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)
    before = gpt2.GPT2(_DP_CFG, device="cpu", seed=0).state_dict()
    assert any(not torch.equal(before[k], states[0][k]) for k in before)


def _broadcast_loop(config):
    rank = session.get_world_rank()
    model = gpt2.GPT2(_DP_CFG, device=session.get_device(), seed=rank)
    session.broadcast_params(model, src_rank=0)
    want = gpt2.GPT2(_DP_CFG, device="cpu", seed=0).state_dict()
    got = model.state_dict()
    if not all(torch.equal(got[k], want[k]) for k in want):
        raise AssertionError(f"rank {rank} differs from rank 0 after "
                             "broadcast_params")
    session.report({"rank": rank, "equal": True})


def test_broadcast_params_makes_rank_1_equal_rank_0():
    # Rank 1 starts from other weights (seed 1) and raises unless the
    # broadcast gave it rank 0's; its error would come back in Result.
    assert not torch.equal(
        gpt2.GPT2(_DP_CFG, device="cpu", seed=1).state_dict()["wte"],
        gpt2.GPT2(_DP_CFG, device="cpu", seed=0).state_dict()["wte"])
    result = TorchTrainer(_broadcast_loop, device="cpu",
                          scaling_config=ScalingConfig(num_workers=2)).fit()
    assert result.error is None, result.error
    assert result.metrics == {"rank": 0, "equal": True}


def _mesh_loop(config):
    """Each rank's mesh (`session.get_mesh()`), gathered to rank 0 over the
    group the backend formed; and whether a mesh asked for without a
    device type (so on CUDA, absent here) raises."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    mesh = session.get_mesh()
    try:
        build_mesh(MeshSpec(config["axes"]))
        raised = None
    except RuntimeError as e:
        raised = str(e)
    mine = {"rank": session.get_world_rank(), "raised": raised,
            "names": list(mesh.mesh_dim_names),
            "shape": list(mesh.mesh.shape), "type": mesh.device_type,
            "coordinate": mesh.get_coordinate()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    session.report({"ranks": every})


@pytest.mark.parametrize("workers,axes", [(2, {"dp": 2}), (1, {"sp": 1})])
def test_scaling_config_mesh_reaches_every_worker(workers, axes):
    """`ScalingConfig(mesh=...)` over CPU workers: each worker's
    `get_mesh()` is a CPU DeviceMesh with the spec's axes over the group
    the backend formed (of one rank too); without "cpu" asked for, a mesh
    needs CUDA and raises."""
    result = TorchTrainer(
        _mesh_loop, train_loop_config={"axes": axes}, device="cpu",
        scaling_config=ScalingConfig(num_workers=workers,
                                     mesh=MeshSpec(axes))).fit()
    assert result.error is None, result.error
    every = result.metrics["ranks"]
    assert [r["rank"] for r in every] == list(range(workers))
    for r in every:
        assert r["names"] == list(axes) and r["shape"] == list(axes.values())
        assert r["type"] == "cpu"
        assert list(r["coordinate"]) == [r["rank"]]
        assert "CUDA is not available" in r["raised"]
    assert session.get_mesh is train_api.get_mesh


def _failing_loop(config):
    session.report({"step": 0})
    raise ValueError("the loop broke after one report")


def test_loop_error_comes_back_in_the_result():
    result = TorchTrainer(_failing_loop, device="cpu").fit()
    assert isinstance(result.error, TrainingFailedError)
    assert "broke after one report" in str(result.error.__cause__)
    assert result.metrics == {"step": 0}
    assert result.metrics_history == [{"step": 0}]
    # Setup errors still raise, before any worker starts.
    with pytest.raises(ValueError):
        TorchTrainer(_failing_loop, device="cpu",
                     scaling_config=ScalingConfig(num_workers=0)).fit()
    with pytest.raises(ValueError):
        TorchTrainer(_failing_loop, device="cuda:1").fit()


def _ckpt_loop(config):
    start = session.get_checkpoint()
    first = 0 if start is None else start.to_dict()["step"] + 1
    for step, score in zip(range(first, first + 4), config["scores"]):
        session.report({"step": step, "score": score},
                       checkpoint=Checkpoint.from_dict({"step": step}))


def test_checkpoints_keep_n_best_by_score_and_restore(tmp_path):
    run = RunConfig(name="ckpt", storage_path=str(tmp_path),
                    checkpoint_config=CheckpointConfig(
                        num_to_keep=2, checkpoint_score_attribute="score"))
    result = TorchTrainer(_ckpt_loop, device="cpu", run_config=run,
                          train_loop_config={"scores": [3, 9, 1, 5]}).fit()
    assert result.error is None
    kept = sorted(os.listdir(os.path.join(result.path, "checkpoints")))
    assert kept == ["checkpoint_000002", "checkpoint_000004"]  # 9 and 5
    assert result.best_checkpoint.to_dict() == {"step": 1}
    assert result.checkpoint.to_dict() == {"step": 3}
    # restore() resumes from the latest checkpoint kept under the run.
    resumed = TorchTrainer.restore(result.path, _ckpt_loop, device="cpu",
                                   train_loop_config={"scores": [0] * 4})
    assert resumed.resume_from_checkpoint.to_dict() == {"step": 3}
    again = resumed.fit()
    assert [m["step"] for m in again.metrics_history] == [4, 5, 6, 7]


def _flaky_loop(config):
    # Fails once, after a checkpoint; the restarted gang resumes from it.
    start = session.get_checkpoint()
    if start is None:
        session.report({"step": 0}, checkpoint=Checkpoint.from_dict(
            {"step": 0}))
        raise RuntimeError("the first attempt dies")
    session.report({"step": start.to_dict()["step"] + 1})


def test_gang_restart_resumes_from_the_last_checkpoint():
    run = RunConfig(failure_config=FailureConfig(max_failures=1))
    result = TorchTrainer(_flaky_loop, device="cpu", run_config=run).fit()
    assert result.error is None, result.error
    assert [m["step"] for m in result.metrics_history] == [0, 1]
    # Without a retry the same loop's error comes back.
    result = TorchTrainer(_flaky_loop, device="cpu").fit()
    assert isinstance(result.error, TrainingFailedError)


def test_gang_monitor_fails_the_worker_group_fast_on_rank_death():
    # The train worker group of two is watched by the shardgroup gang
    # monitor: a killed rank fails the next call at once, naming it.
    import time

    from ray_tpu_torch.train.worker_group import WorkerGroup

    group = WorkerGroup(2, resources_per_worker={"CPU": 0.5})
    try:
        assert group.execute(os.getpid) and group.dead_rank is None
        ray_tpu_torch.kill(group.workers[1])
        t0 = time.time()
        while group.dead_rank is None and time.time() - t0 < 15:
            time.sleep(0.05)
        assert group.dead_rank == 1 and time.time() - t0 < 5.0
        with pytest.raises(RuntimeError, match="lost rank 1/2"):
            group.execute(os.getpid)
    finally:
        group.shutdown()


def test_as_trainable_returns_metrics_or_raises():
    trainable = TorchTrainer(_direct_loop, device="cpu").as_trainable()
    assert trainable({})["step"] == 2
    with pytest.raises(TrainingFailedError):
        TorchTrainer(_failing_loop, device="cpu").as_trainable()({})


def test_stop_condition_and_callbacks():
    seen = []
    result = TorchTrainer(
        _loop, device="cpu", train_loop_config={"steps": 5},
        run_config=RunConfig(stop={"step": 1}, callbacks=[seen.append])).fit()
    assert result.error is None
    assert [m["step"] for m in result.metrics_history] == [0, 1]
    assert seen == result.metrics_history


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt2.GPT2(gpt2.GPT2Config.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchTrainer(_loop, train_loop_config={"steps": 1}).fit()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_build_dir_is_git_ignored():
    # The kernels are compiled at first use into the checkout; git must not
    # pick the libraries up.
    build_dir = os.path.relpath(_torch_env.KERNEL_BUILD_DIR, ROOT)
    assert not build_dir.startswith("..")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    assert build_dir.split(os.sep)[0] + "/" in ignored


# --------------------------------------------------------------------------- #
# datasets=: the Data-fed loop
# --------------------------------------------------------------------------- #


@ray_tpu_torch.remote
class _Tally:
    def __init__(self):
        self.ids = []

    def add(self, rank, ids):
        self.ids.append((rank, list(ids)))

    def get(self):
        return self.ids


def _ingest_loop(config):
    # The split hands blocks to whichever rank asks first, as the
    # reference's does. The ranks' loops start up to ~0.4 s apart (each
    # worker imports this file, JAX with it, to unpickle the loop), and one
    # rank drains all 4 blocks in ~0.15 s, so the later one could find none.
    # So each rank takes its first batch, then the two meet on the gloo
    # group: a rank waiting there holds at most 2 blocks (its prefetch
    # queue of 2 batches and the block in hand), and the other finds the
    # rest.
    shard = session.get_dataset_shard("train")
    batches = shard.iter_batches(batch_size=8)
    first = next(batches, None)
    torch.distributed.barrier()
    seen = [] if first is None else first["id"].tolist()
    for batch in batches:
        seen += batch["id"].tolist()
    tally = ray_tpu_torch.get_actor(config["tally"])
    ray_tpu_torch.get(tally.add.remote(session.get_world_rank(), seen))
    stats = session.get_ingest_stats()["train"]
    session.report({"rows": len(seen), "steps": stats["steps"],
                    "stall_frac": stats["stall_frac"],
                    "epochs": stats["epochs"]})


def test_datasets_two_gloo_workers_see_every_row_once(tmp_path):
    # The reference's tests/test_data.py::test_dataset_feeds_trainer_shards
    # and test_data_streaming.py::test_trainer_shards_report_ingest_stats:
    # one streaming_split over two gloo workers, each a prefetching
    # ShardIterator with step-stall accounting.
    tally = _Tally.options(name="ingest_tally").remote()
    result = TorchTrainer(
        _ingest_loop, device="cpu", train_loop_config={"tally":
                                                       "ingest_tally"},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="ingest", storage_path=str(tmp_path)),
        datasets={"train": rd.range(64, parallelism=4)}).fit()
    assert result.error is None, result.error
    seen = ray_tpu_torch.get(tally.get.remote())
    assert sorted(rank for rank, _ in seen) == [0, 1]
    assert sorted(i for _, ids in seen for i in ids) == list(range(64))
    m = result.metrics
    assert m["steps"] > 0 and m["epochs"] == 1
    assert 0.0 <= m["stall_frac"] <= 1.0
    ray_tpu_torch.kill(tally)


def _mesh_ingest_loop(config):
    """Reads its whole shard and reports its rows with its mesh
    coordinates (dp, tp)."""
    mesh = session.get_mesh()
    seen = []
    for batch in session.get_dataset_shard("train").iter_batches(
            batch_size=8):
        seen += batch["id"].tolist()
    every = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(
        every, (list(mesh.get_coordinate()), seen))
    session.report({"ranks": every})


def test_datasets_split_over_the_data_parallel_coordinate():
    """With `ScalingConfig(mesh=MeshSpec({"dp": 2, "tp": 2}))`, `datasets=`
    is split over dp, not over the 4 workers: the tp peers of a dp
    coordinate read the same rows in the same order, the two dp shards are
    disjoint, and together they hold every row once. (Half a CPU a
    worker: the split's reads need CPUs beside the 4 workers.)"""
    result = TorchTrainer(
        _mesh_ingest_loop, device="cpu",
        scaling_config=ScalingConfig(num_workers=4, cpus_per_worker=0.5,
                                     mesh=MeshSpec({"dp": 2, "tp": 2})),
        datasets={"train": rd.range(64, parallelism=4)}).fit()
    assert result.error is None, result.error
    ranks = result.metrics["ranks"]
    assert [coord for coord, _ in ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    (a, a_peer), (b, b_peer) = [(ranks[i][1], ranks[i + 1][1])
                                for i in (0, 2)]
    assert a == a_peer and b == b_peer and a and b
    assert not set(a) & set(b)
    assert sorted(a + b) == list(range(64))
    trainer = TorchTrainer(
        _mesh_ingest_loop, device="cpu",
        scaling_config=ScalingConfig(num_workers=4,
                                     mesh=MeshSpec({"dp": 2, "tp": 2})),
        datasets={"a": list(range(7))})
    assert [s["a"] for s in trainer._split_datasets()] == \
        [[0, 2, 4, 6], [0, 2, 4, 6], [1, 3, 5], [1, 3, 5]]


def test_plain_lists_are_sharded_round_robin():
    trainer = TorchTrainer(_ingest_loop, device="cpu",
                           scaling_config=ScalingConfig(num_workers=3),
                           datasets={"a": list(range(7)), "cfg": {"k": 1}})
    shards = trainer._split_datasets()
    assert [s["a"] for s in shards] == [[0, 3, 6], [1, 4], [2, 5]]
    assert all(s["cfg"] == {"k": 1} for s in shards)
    assert TorchTrainer(_ingest_loop, device="cpu")._split_datasets() is None


def _restart_ingest_loop(config):
    # The first incarnation takes two batches, checkpoints and dies; the
    # restarted gang gets its shard again (the same ShardIterator, shipped
    # anew) and reads on.
    shard = session.get_dataset_shard("train")
    start = session.get_checkpoint()
    seen = []
    for batch in shard.iter_batches(batch_size=8):
        seen += batch["id"].tolist()
        if start is None and len(seen) == 16:
            break
    tally = ray_tpu_torch.get_actor(config["tally"])
    ray_tpu_torch.get(tally.add.remote(0 if start is None else 1, seen))
    if start is None:
        session.report({"rows": len(seen)},
                       checkpoint=Checkpoint.from_dict({"rows": len(seen)}))
        raise RuntimeError("the first incarnation dies")
    session.report({"rows": len(seen)})


def test_dataset_shards_survive_gang_restart():
    # As in the reference, the split is made once per fit(): the restarted
    # worker resumes the split's epoch where the coordinator stands, so it
    # sees none of the first incarnation's rows (blocks its prefetch had
    # pulled but not handed to the loop are not seen again).
    tally = _Tally.options(name="restart_tally").remote()
    result = TorchTrainer(
        _restart_ingest_loop, device="cpu",
        train_loop_config={"tally": "restart_tally"},
        run_config=RunConfig(failure_config=FailureConfig(max_failures=1)),
        datasets={"train": rd.range(128, parallelism=16)}).fit()
    assert result.error is None, result.error
    seen = dict(ray_tpu_torch.get(tally.get.remote()))
    assert len(seen[0]) == 16 and len(seen[1]) > 0
    assert not set(seen[0]) & set(seen[1])
    assert set(seen[0]) | set(seen[1]) <= set(range(128))
    ray_tpu_torch.kill(tally)


def _one_batch_loop(config):
    shard = session.get_dataset_shard("train")
    for batch in shard.iter_batches(batch_size=100):
        break  # N steps: most of the epoch is never read
    session.report({"rows": len(batch["data"]),
                    "shuffle": shard.split_stats()["shuffle"]})


def test_an_abandoned_epoch_leaves_no_store_objects():
    # A loop that stops after one batch of a shuffled dataset (blocks past
    # the 100 KiB inline threshold, so they live in the store): fit()
    # closes the split, whose coordinator drops the execution, frees its
    # blocks and exits; the store returns to its count (frees are batched
    # on a 1 s timer, so poll with a deadline, as bench.py's ingest leak
    # check does).
    import time

    store = ray_tpu_torch._global_node.raylet.store
    baseline = store.stats()["num_objects"]
    ds = rd.range_tensor(4000, shape=(32,), parallelism=8) \
        .random_shuffle(seed=1)
    result = TorchTrainer(_one_batch_loop, device="cpu",
                          datasets={"train": ds}).fit()
    assert result.error is None, result.error
    assert result.metrics["rows"] == 100
    assert result.metrics["shuffle"]["windows"] >= 1
    assert result.metrics["shuffle"]["input_blocks"] == 8
    deadline = time.monotonic() + 20
    while store.stats()["num_objects"] > baseline \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    assert store.stats()["num_objects"] <= baseline


# --------------------------------------------------------------------------- #
# TorchPredictor / BatchPredictor against JaxPredictor
# --------------------------------------------------------------------------- #

# float32 on both sides, widths up to 512: logits differ by summation order
# only, 1e-4 (as tests/test_torch_gpt2.py holds the model's logits).
_PRED_TOL = dict(atol=1e-4, rtol=1e-4)
_PRED_SEQ = 64


def _predictor_pair(tmp_path):
    jcfg = jgpt2.GPT2Config(vocab_size=512, n_positions=_PRED_SEQ,
                            n_embd=128, n_layer=2, n_head=2,
                            dtype=jnp.float32)
    tcfg = gpt2.GPT2Config(vocab_size=512, n_positions=_PRED_SEQ,
                           n_embd=128, n_layer=2, n_head=2,
                           dtype=torch.float32)
    jmodel = jgpt2.GPT2(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, _PRED_SEQ), jnp.int32))
    params_np = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    ckpt = Checkpoint.from_state_dict(gpt2.params_from_jax(params_np),
                                      path=str(tmp_path / "ckpt"))
    ids = np.random.default_rng(2).integers(0, 512, (12, _PRED_SEQ),
                                            dtype=np.int32)
    spec = functools.partial(gpt2.GPT2, tcfg)
    return JaxPredictor(jmodel, params, input_column="ids"), ckpt, spec, ids


def test_torch_predictor_and_batch_predictor_match_jax(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    jpred, ckpt, spec, ids = _predictor_pair(tmp_path)
    want = jpred.predict({"ids": ids})["predictions"]
    tpred = TorchPredictor.from_checkpoint(ckpt, model=spec,
                                           input_column="ids",
                                           keep_columns=("row",),
                                           device="cpu")
    got = tpred.predict({"ids": ids, "row": np.arange(12)})
    assert got["predictions"].dtype == np.float32
    np.testing.assert_allclose(got["predictions"], want, **_PRED_TOL)
    np.testing.assert_array_equal(got["row"], np.arange(12))
    # The same scoring through Data: one pool actor (a CPU worker, so the
    # predictor is asked for the CPU), batches of 4, every row once.
    ds = rd.from_numpy(ids, column="ids")
    ds = ds.map_batches(lambda b: {"ids": b["ids"],
                                   "row": np.arange(len(b["ids"]))})
    scored = BatchPredictor.from_checkpoint(
        ckpt, TorchPredictor, model=spec, input_column="ids",
        device="cpu").predict(ds, batch_size=4, max_scoring_workers=1,
                              keep_columns=("row",))
    out = {}
    for batch in scored.iter_batches(batch_size=12):
        for row, pred in zip(batch["row"], batch["predictions"]):
            assert int(row) not in out
            out[int(row)] = pred
    assert sorted(out) == list(range(12))
    np.testing.assert_allclose(np.stack([out[i] for i in range(12)]), want,
                               **_PRED_TOL)


def test_torch_predictor_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour where CUDA is absent")
    _, ckpt, spec, _ = _predictor_pair(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchPredictor.from_checkpoint(ckpt, model=spec)


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "ray_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imports(node, in_function=False):
    """(top-level package, whether inside a function) of every import."""
    if isinstance(node, ast.Import):
        yield from ((a.name.split(".")[0], in_function) for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        yield (node.module or "").split(".")[0], in_function
    in_function = in_function or isinstance(
        node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
    for child in ast.iter_child_nodes(node):
        yield from _imports(child, in_function)


def test_port_imports_no_jax_and_no_ray_tpu():
    # Anywhere in a file: jax, flax, optax and the JAX package. At module
    # scope: triton, which a machine without a card may not have.
    banned_anywhere = {"jax", "jaxlib", "flax", "optax", "ray_tpu"}
    files = _port_files()
    assert len(files) > 10
    for rel in ("serve/controller.py", "serve/examples.py",
                "shardgroup/runtime.py", "inference/api.py",
                "chaos/deadline.py", "observability/export.py",
                "data/dataset.py", "data/streaming/ingest.py",
                "data/query/sort.py", "train/batch_predictor.py",
                "rllib/offline.py"):
        assert os.path.join(ROOT, "ray_tpu_torch", rel) in files, rel
    data_dir = os.path.join(ROOT, "ray_tpu_torch", "data") + os.sep
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for root, in_function in _imports(tree):
            assert root not in banned_anywhere, (path, root)
            assert in_function or root != "triton", (path, root)
            # Data tasks run in CPU workers forked from the forge's
            # template, which must keep CUDA uninitialised: no torch.
            assert not path.startswith(data_dir) or root != "torch", \
                (path, root)
