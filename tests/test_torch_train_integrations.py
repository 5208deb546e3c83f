"""The port's framework trainers (`ray_tpu_torch.train.integrations`)
against the JAX package's, on the CPU.

`TransformersTrainer` runs a tiny Hugging Face GPT-2's loop in one worker of
each package's cluster, from one seed: a manual AdamW loop, and a
`transformers.Trainer` whose logs `prepare_trainer` forwards to
`session.report`. The losses each reports must agree within 1e-6
(relative). Both runtimes are up at once in this process, and the two runs
go at once in one module fixture, one loop each (most of their time is
each worker importing `transformers`); the workers run torch on one
thread. The GBDT trainers' gate: where `xgboost` or
`lightgbm` is absent, constructing its trainer raises an ImportError that
names the package, as the reference's does.
"""

import importlib
import os
import threading

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch


@pytest.fixture(scope="module")
def clusters():
    """Both runtimes, whose workers import `transformers` without
    TensorFlow (USE_TF=0: its import alone is ~8 s a worker here)."""
    saved = os.environ.get("USE_TF")
    os.environ["USE_TF"] = "0"
    ray_tpu.init(num_cpus=2)
    ray_tpu_torch.init(num_cpus=2)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()
        if saved is None:
            os.environ.pop("USE_TF", None)
        else:
            os.environ["USE_TF"] = saved


def _tiny_gpt2():
    import torch
    from transformers import GPT2Config, GPT2LMHeadModel

    torch.set_num_threads(1)
    torch.manual_seed(0)
    return GPT2LMHeadModel(GPT2Config(n_embd=32, n_layer=1, n_head=2,
                                      n_positions=32, vocab_size=128))


def hf_loop(config):
    """Two AdamW steps on one seeded batch, every loss reported; then
    `transformers.Trainer` for 3 steps, its logs through `prepare_trainer`.
    One loop, so each worker imports `transformers` once."""
    import torch
    from transformers import Trainer, TrainingArguments

    train = importlib.import_module(f"{config['pkg']}.train")
    model = _tiny_gpt2()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    ids = torch.randint(0, 128, (4, 16),
                        generator=torch.Generator().manual_seed(1))
    losses = []
    for step in range(2):
        out = model(input_ids=ids, labels=ids)
        out.loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(out.loss))
        train.session.report({"manual_loss": losses[-1],
                              "losses": list(losses), "step": step})

    class DS(torch.utils.data.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            ids = torch.randint(0, 128, (16,),
                                generator=torch.Generator().manual_seed(i))
            return {"input_ids": ids, "labels": ids}

    args = TrainingArguments(
        output_dir=config["out"], max_steps=3, logging_steps=1,
        per_device_train_batch_size=4, report_to=[], disable_tqdm=True,
        use_cpu=True, save_strategy="no", seed=0)
    hf = Trainer(model=_tiny_gpt2(), args=args, train_dataset=DS())
    train.prepare_trainer(hf)
    hf.train()


def _fit(mod, tmp_path, out):
    train = importlib.import_module(f"{mod.__name__}.train")
    kwargs = {"device": "cpu"} if mod is ray_tpu_torch else {}
    scaling = train.ScalingConfig(num_workers=1, **(
        {"use_gpu": False} if mod is ray_tpu_torch else {}))
    out[mod.__name__] = train.TransformersTrainer(
        hf_loop, train_loop_config={
            "pkg": mod.__name__, "out": str(tmp_path / mod.__name__)},
        scaling_config=scaling,
        run_config=train.RunConfig(name=f"hf-{mod.__name__}",
                                   storage_path=str(tmp_path)),
        **kwargs).fit()


@pytest.fixture(scope="module")
def results(clusters, tmp_path_factory):
    """Each package's run of `hf_loop`, the two at once."""
    pytest.importorskip("transformers")
    tmp_path, out = tmp_path_factory.mktemp("hf"), {}
    threads = [threading.Thread(target=_fit, args=(mod, tmp_path, out))
               for mod in (ray_tpu, ray_tpu_torch)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert set(out) == {"ray_tpu", "ray_tpu_torch"}, out
    return out["ray_tpu"], out["ray_tpu_torch"]


def test_transformers_trainer_losses_equal_the_reference(results):
    ref, port = results
    manual = [m for m in port.metrics_history if "manual_loss" in m]
    assert [m["step"] for m in manual] == [0, 1]
    last = manual[-1]["losses"]
    assert len(last) == 2 and np.all(np.isfinite(last))
    np.testing.assert_allclose(
        last, [m for m in ref.metrics_history
               if "manual_loss" in m][-1]["losses"], rtol=1e-6, atol=0)


def test_prepare_trainer_reports_hf_logs_as_the_reference(results):
    ref, port = results

    def losses(result):
        return [m["loss"] for m in result.metrics_history if "loss" in m]

    # One report a logged step, each with HF's step number.
    assert [m.get("step") for m in port.metrics_history
            if "loss" in m] == [1, 2, 3]
    np.testing.assert_allclose(losses(port), losses(ref), rtol=1e-6, atol=0)
    assert "train_loss" in port.metrics and "train_loss" in ref.metrics


@pytest.mark.parametrize("trainer,package", [
    ("XGBoostTrainer", "xgboost"), ("LightGBMTrainer", "lightgbm")])
def test_gbdt_trainers_gated(trainer, package):
    """Without the library, construction fails with the reference's error,
    naming the package; with it, a trainer needs a 'train' dataset."""
    errors = []
    for mod in ("ray_tpu", "ray_tpu_torch"):
        cls = getattr(importlib.import_module(f"{mod}.train"), trainer)
        try:
            importlib.import_module(package)
        except ImportError:
            with pytest.raises(ImportError, match=package) as info:
                cls(params={})
            errors.append(str(info.value))
        else:
            with pytest.raises(ValueError, match="train"):
                cls(params={})
            errors.append("installed")
    assert errors[0] == errors[1]


def test_transformers_gate_names_the_package(monkeypatch):
    """With `transformers` hidden, both trainers and prepare_trainer raise
    the same ImportError."""
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    messages = []
    for mod in ("ray_tpu", "ray_tpu_torch"):
        train = importlib.import_module(f"{mod}.train")
        with pytest.raises(ImportError, match="transformers") as a:
            train.TransformersTrainer(lambda config: None)
        with pytest.raises(ImportError, match="transformers") as b:
            train.prepare_trainer(object())
        messages.append((str(a.value), str(b.value)))
    assert messages[0] == messages[1]
    assert "requires the 'transformers' package" in messages[1][0]


def test_port_trainer_defaults_to_the_card():
    """As every port trainer: workers hold a card unless device='cpu'."""
    from ray_tpu_torch.train import ScalingConfig, TransformersTrainer

    pytest.importorskip("transformers")
    trainer = TransformersTrainer(lambda config: None,
                                  scaling_config=ScalingConfig(num_workers=1))
    assert trainer._worker_device() == "cuda"
    assert TransformersTrainer(
        lambda config: None, scaling_config=ScalingConfig(num_workers=1),
        device="cpu")._worker_device() == "cpu"
