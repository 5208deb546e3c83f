"""The PyTorch port's trainer, device rule and import rule, on the CPU."""

import ast
import os

import pytest
import torch

from ray_tpu_torch import _torch_env, resolve_device
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchTrainer,
                                 session)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_more_than_one_worker_is_not_yet_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchTrainer(_loop, train_loop_config={"steps": 1}, device="cpu",
                     scaling_config=ScalingConfig(num_workers=2)).fit()


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
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for root, in_function in _imports(tree):
            assert root not in banned_anywhere, (path, root)
            assert in_function or root != "triton", (path, root)
