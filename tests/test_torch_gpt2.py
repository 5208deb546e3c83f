"""The PyTorch port's GPT-2 against the JAX package's, on the CPU.

One flax parameter tree, made from a seed, is unboxed to numpy and loaded
into both models through `params_from_jax`. The JAX model runs its Pallas
flash kernels in interpret mode (head dim 64), the port its kernels' plain
versions. Float32 tolerances are set by summation order over widths up to
512: 1e-4 on logits and loss. After one AdamW step each parameter moves by
lr * g / (|g| + 1e-8) plus decay, about lr = 3e-4. Where a gradient is
within a few 1e-8 of zero (the key bias, whose gradient is zero in exact
arithmetic) that ratio turns float32 summation-order noise in g into a
visible part of the step, so parameters must agree to 1e-5, 3% of a step.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import gpt2 as tgpt2

SEQ, BATCH = 128, 2
FWD_TOL = dict(atol=1e-4, rtol=1e-4)


def _configs(dtype=jnp.float32, tdtype=torch.float32):
    jcfg = jgpt2.GPT2Config(vocab_size=512, n_positions=SEQ, n_embd=128,
                            n_layer=2, n_head=2, dtype=dtype)
    tcfg = tgpt2.GPT2Config(vocab_size=512, n_positions=SEQ, n_embd=128,
                            n_layer=2, n_head=2, dtype=tdtype)
    return jcfg, tcfg


def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, 512, (BATCH, SEQ),
                                                dtype=np.int32)


def _models(jcfg, tcfg, ids):
    jmodel = jgpt2.GPT2(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    params_np = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    tmodel = tgpt2.GPT2(tcfg, device="cpu")
    tmodel.load_state_dict(tgpt2.params_from_jax(params_np))
    return jmodel, params, tmodel


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")


def test_logits_and_loss_match_jax(interpret):
    jcfg, tcfg = _configs()
    ids = _ids()
    jmodel, params, tmodel = _models(jcfg, tcfg, ids)
    logits_j = jmodel.apply(params, jnp.asarray(ids))
    loss_j = jgpt2.next_token_loss(logits_j, jnp.asarray(ids))
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        logits = tmodel(tids)
        loss = tgpt2.next_token_loss(logits, tids)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **FWD_TOL)
    np.testing.assert_allclose(loss.item(), float(loss_j), **FWD_TOL)
    assert tgpt2.count_params(tmodel) == jgpt2.count_params(params)


def test_params_after_one_adamw_step_match_jax(interpret):
    jcfg, tcfg = _configs()
    ids = _ids(1)
    jmodel, params, tmodel = _models(jcfg, tcfg, ids)
    opt = optax.adamw(3e-4, weight_decay=0.1)
    jstep = jgpt2.make_train_step(jmodel, opt, donate=False)
    batch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(ids)}
    params_j, _, loss_j = jstep(params, opt.init(params), batch)

    tids = torch.from_numpy(ids).long()
    step = tgpt2.make_train_step(tmodel, tgpt2.adamw(tmodel))
    loss = step({"input_ids": tids, "labels": tids})
    np.testing.assert_allclose(loss.item(), float(loss_j), **FWD_TOL)
    want = tgpt2.params_from_jax(
        jax.tree.map(np.asarray, fnn.meta.unbox(params_j)))
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_bf16_forward_close_to_jax():
    # bf16 compute on f32 params: the two frameworks round at different
    # places (8 significant bits), so logits agree only to a few bf16 ulps
    # of their magnitude (~1, where one ulp is 2^-7 = 7.8e-3): 3e-2.
    jcfg, tcfg = _configs(jnp.bfloat16, torch.bfloat16)
    ids = _ids(2)
    jmodel, params, tmodel = _models(jcfg, tcfg, ids)
    logits_j = np.asarray(jmodel.apply(params, jnp.asarray(ids)).astype(
        jnp.float32))
    with torch.no_grad():
        logits = tmodel(torch.from_numpy(ids).long())
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(), logits_j,
                               atol=3e-2, rtol=0)


def test_next_token_loss_ignore_index_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 16, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (2, 16)).astype(np.int32)
    labels[0, 5:9] = -100
    want = float(jgpt2.next_token_loss(jnp.asarray(logits),
                                       jnp.asarray(labels)))
    got = tgpt2.next_token_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels).long()).item()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_eval_step_and_flops_per_token():
    tcfg = tgpt2.GPT2Config.tiny()
    model = tgpt2.GPT2(tcfg, device="cpu")
    ids = torch.from_numpy(_ids()).long() % tcfg.vocab_size
    loss = tgpt2.make_eval_step(model)({"input_ids": ids, "labels": ids})
    assert loss.shape == () and torch.isfinite(loss)
    # Uniform logits at init: loss near log(vocab).
    assert abs(loss.item() - np.log(tcfg.vocab_size)) < 0.5
    jcfg = jgpt2.GPT2Config.tiny()
    assert tgpt2.flops_per_token(tcfg, 128) == jgpt2.flops_per_token(jcfg, 128)
    assert dataclasses.asdict(tgpt2.GPT2Config.small())["n_embd"] == 768


def test_same_seed_same_weights_and_unported_options_raise():
    cfg = tgpt2.GPT2Config.tiny()
    a = tgpt2.GPT2(cfg, device="cpu", seed=7).state_dict()
    b = tgpt2.GPT2(cfg, device="cpu", seed=7).state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert abs(a["h.0.c_attn.weight"].std().item() - 0.02) < 2e-3
    assert abs(a["wpe"].std().item() - 0.01) < 1e-3
    # use_ring is ported (tests/test_torch_ring_attention.py): it builds.
    assert tgpt2.GPT2(dataclasses.replace(cfg, use_ring=True),
                      device="cpu").config.use_ring
    # remat is ported (tests/test_torch_remat.py): it builds.
    assert tgpt2.GPT2(dataclasses.replace(cfg, remat=True),
                      device="cpu").config.remat
