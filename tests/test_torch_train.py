"""The PyTorch port's trainer, device rule and import rule, on the CPU.

`TorchTrainer.fit` runs its loop in worker actors of the port's runtime,
which one module-scoped `ray_tpu_torch.init` starts; every loop below is a
module-level function, so the workers import it from this file.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import _torch_env, resolve_device
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.train import (Checkpoint, CheckpointConfig,
                                 FailureConfig, RunConfig, ScalingConfig,
                                 TorchTrainer, TrainingFailedError, session)

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
                "chaos/deadline.py", "observability/export.py"):
        assert os.path.join(ROOT, "ray_tpu_torch", rel) in files, rel
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for root, in_function in _imports(tree):
            assert root not in banned_anywhere, (path, root)
            assert in_function or root != "triton", (path, root)
