"""The PyTorch port's MLP against the JAX package's, on the CPU.

The flax tree, made from a seed, is carried into the port through
`params_from_jax`. Float32 throughout; widths up to 128, so outputs and
the loss agree to 1e-5 (summation order), and after one SGD(0.1) step each
parameter, which moves by 0.1 * its gradient, to 1e-6.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import mlp as jmlp
from ray_tpu_torch.models import mlp as tmlp

FEATURES = (128, 128, 10)


def _data(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 4, 8)).astype(np.float32),
            rng.integers(0, FEATURES[-1], n).astype(np.int32))


def _carry(x):
    jmodel = jmlp.MLP(features=FEATURES)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params_np = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    tmodel = tmlp.MLP(32, FEATURES, device="cpu")
    tmodel.load_state_dict(tmlp.params_from_jax(params_np))
    return jmodel, params, tmodel


def test_forward_and_loss_match_jax():
    x, y = _data()
    jmodel, params, tmodel = _carry(x)
    logits_j = jmodel.apply(params, jnp.asarray(x))
    loss_j = jmlp.classification_loss(logits_j, jnp.asarray(y))
    with torch.no_grad():
        logits = tmodel(torch.from_numpy(x))
        loss = tmlp.classification_loss(logits, torch.from_numpy(y).long())
    assert logits.shape == (16, FEATURES[-1])
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=1e-5,
                               rtol=1e-5)


def test_one_sgd_step_matches_jax():
    x, y = _data(1)
    jmodel, params, tmodel = _carry(x)
    opt = optax.sgd(0.1)
    params_j, _, loss_j = jmlp.make_train_step(jmodel, opt)(
        params, opt.init(params), {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    step = tmlp.make_train_step(tmodel,
                                torch.optim.SGD(tmodel.parameters(), lr=0.1))
    loss = step({"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()})
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=1e-5,
                               rtol=1e-5)
    want = tmlp.params_from_jax(
        jax.tree.map(np.asarray, fnn.meta.unbox(params_j)))
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


def test_init_is_lecun_normal_with_zero_biases():
    a = tmlp.MLP(512, (256, 10), device="cpu", seed=3).state_dict()
    b = tmlp.MLP(512, (256, 10), device="cpu", seed=3).state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    w = a["dense.0.weight"]
    assert w.shape == (256, 512)
    # Variance 1 / fan_in after the truncation at two standard deviations
    # of the untruncated normal.
    assert abs(w.var().item() * 512 - 1.0) < 0.05
    assert w.abs().max().item() <= 2 * np.sqrt(1 / 512) / 0.8796256610342398
    assert not torch.any(a["dense.0.bias"]) and not torch.any(
        a["dense.1.bias"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmlp.MLP(512)
