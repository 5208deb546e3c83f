"""Activation checkpointing (`remat`) in the PyTorch port, on the CPU.

Each block under `torch.utils.checkpoint` drops its activations after the
forward and recomputes them in the backward. The recompute runs the same
operations on the same inputs, and the checkpoint restores the global
generators before it, so dropout draws the same masks: logits and every
gradient must EQUAL those without remat, bit for bit, on GPT-2 (with
dropout 0 and 0.1), Llama and MoE `tiny`. Against the JAX models with
`remat=True` (float32, the JAX flash kernels in interpret mode where the
model takes them), logits agree to 1e-4 and gradients, which sum over the
batch, to 1e-4 of each tensor's largest element.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe

BATCH, SEQ = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")


# Per family: (JAX module, port module, model class name, config changes
# from `tiny`). GPT-2 at head dim 64 takes the flash kernels; Llama and MoE
# `tiny` take plain attention (use_flash=False in their presets).
FAMILIES = {
    "gpt2": (jgpt2, tgpt2, "GPT2", dict(n_head=2)),
    "llama": (jllama, tllama, "Llama", {}),
    "moe": (jmoe, tmoe, "MoE", dict(capacity_factor=2.0)),
}


def _configs(family, **kw):
    jmod, tmod, name, changes = FAMILIES[family]
    changes = dict(changes, **kw)
    return tuple(dataclasses.replace(getattr(mod, name + "Config").tiny(SEQ),
                                     dtype=dtype, **changes)
                 for mod, dtype in ((jmod, jnp.float32),
                                    (tmod, torch.float32)))


def _model(family, tcfg, state=None):
    _, tmod, name, _ = FAMILIES[family]
    if family == "gpt2":
        model = tmod.GPT2(tcfg, device="cpu", seed=0)
        if state is not None:
            model.load_state_dict(state)
        return model
    return getattr(tmod, name)(tcfg, device="cpu", seed=0, state=state)


def _ids(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 512, (BATCH, SEQ))).long()


def _loss_and_grads(model, ids, train=False, seed=0):
    model.zero_grad(set_to_none=True)
    torch.manual_seed(seed)
    logits = model(ids, deterministic=False) if train else model(ids)
    tgpt2.next_token_loss(logits, ids).backward()
    return logits.detach(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}


@pytest.mark.parametrize("family,dropout", [
    ("gpt2", 0.0), ("gpt2", 0.1), ("llama", 0.0), ("moe", 0.0)])
def test_remat_equals_no_remat_exactly(family, dropout):
    kw = dict(dropout=dropout) if family == "gpt2" else {}
    _, cfg = _configs(family, **kw)
    ids = _ids(1)
    plain = _model(family, cfg)
    remat = _model(family, dataclasses.replace(cfg, remat=True),
                   state=plain.state_dict())
    train = family == "gpt2"
    want_logits, want = _loss_and_grads(plain, ids, train)
    got_logits, got = _loss_and_grads(remat, ids, train)
    assert torch.equal(got_logits, want_logits)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    if dropout:
        # The masks are live: another seed gives other logits.
        other, _ = _loss_and_grads(remat, ids, train, seed=1)
        assert not torch.equal(other, got_logits)


def _jax_params(family, jcfg, ids):
    jmod, _, name, _ = FAMILIES[family]
    model = getattr(jmod, name)(jcfg)
    params = jax.jit(lambda: model.init(jax.random.PRNGKey(0),
                                        jnp.asarray(ids)))()
    return model, {"params": params["params"]}


@pytest.mark.parametrize("family", ["gpt2", "llama", "moe"])
def test_remat_matches_jax_remat(interpret, family):
    tmod = FAMILIES[family][1]
    jcfg, tcfg = _configs(family, remat=True)
    ids = _ids(2)
    jmodel, params = _jax_params(family, jcfg, ids.numpy().astype(np.int32))

    @jax.jit
    def loss_and_grads(p, x):
        def loss(p):
            logits = jmodel.apply(p, x)
            return jgpt2.next_token_loss(logits, x), logits
        (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return logits, grads

    logits_j, grads_j = loss_and_grads(params, jnp.asarray(ids.numpy(),
                                                           jnp.int32))
    to_np = lambda tree: jax.tree.map(np.asarray, fnn.meta.unbox(tree))
    state = tmod.params_from_jax(to_np(params))
    model = _model(family, tcfg, state=state)
    logits, grads = _loss_and_grads(model, ids)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               atol=1e-4, rtol=1e-4)
    want = tmod.params_from_jax(to_np(grads_j))
    assert set(grads) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(),
                                   atol=1e-4 * g.abs().max().item(), rtol=0,
                                   err_msg=name)
