"""Training steps of the PyTorch port beyond GPT-2, on the CPU.

Llama trains through the generic `gpt2.make_train_step`, as in the JAX
package (`tests/test_llama.py`). One step of a 2-layer GQA Llama at head
dim 64, with the flash path on both sides (the JAX Pallas kernels in
interpret mode, the port's kernels' plain versions), float32, is held
against the JAX step on the same carried weights: the loss to 1e-4 (the
summation order over widths up to 256); the updated `wk` and `wv` element
by element to 1e-5, AdamW's first-step allowance (ROADMAP, queue 3: where
a gradient is near zero, g / (|g| + 1e-8) turns summation-order noise into
part of the step); every parameter on average to 1e-7 (the allowance's
noise sits on a few elements: one of `w_down`'s 49,152 moved 1.3e-5).
`wk` and `wv` take their gradients summed over each KV head's two query
heads, through the backward of the GQA repeat.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama

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


def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (BATCH, SEQ),
                                                dtype=np.int32)


def test_llama_gqa_adamw_step_matches_jax(interpret):
    common = dict(vocab_size=256, n_positions=SEQ, n_embd=256, n_layer=2,
                  n_head=4, n_kv_head=2, intermediate=192, use_flash=True)
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **common)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **common)
    assert tcfg.head_dim == 64
    jmodel = jllama.Llama(jcfg)
    ids = _ids(1)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                         jnp.asarray(ids)))()
    to_np = lambda tree: jax.tree.map(np.asarray, fnn.meta.unbox(tree))
    tmodel = tllama.Llama(tcfg, device="cpu",
                          state=tllama.params_from_jax(to_np(params)))

    opt = optax.adamw(3e-4, weight_decay=0.1)
    jstep = jgpt2.make_train_step(jmodel, opt, donate=False)
    batch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(ids)}
    params_j, _, loss_j = jstep(params, opt.init(params), batch)

    tids = torch.from_numpy(ids).long()
    step = tgpt2.make_train_step(tmodel, tgpt2.adamw(tmodel))
    loss = step({"input_ids": tids, "labels": tids})
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=1e-4,
                               rtol=1e-4)
    want = tllama.params_from_jax(to_np(params_j))
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        diff = (got[name] - value).abs()
        if name.endswith(("wk.weight", "wv.weight")):
            assert diff.max().item() <= 1e-5, name
        # Elsewhere the allowance's noise stays on a few near-zero
        # gradients: on average the parameters agree far closer.
        assert diff.mean().item() <= 1e-7, (name, diff.mean().item())
    # The step moved wk and wv (by about lr each), so the check above
    # compares updates, not unchanged weights.
    before = tllama.params_from_jax(to_np(params))
    for name in ("layers.0.wk.weight", "layers.1.wv.weight"):
        moved = (got[name] - before[name]).abs().mean().item()
        assert 1e-4 < moved < 1e-3, (name, moved)


def test_train_step_descends_the_objective_and_returns_the_shown_loss():
    cfg = tgpt2.GPT2Config.tiny(seq=32)
    ids = torch.from_numpy(_ids(2)[:, :32]).long()
    batch = {"input_ids": ids, "labels": ids}
    model = tgpt2.GPT2(cfg, device="cpu", seed=0)
    twin = tgpt2.GPT2(cfg, device="cpu", seed=0)

    def loss_fn(model, batch):
        logits = model(batch["input_ids"])
        ce = tgpt2.next_token_loss(logits, batch["labels"])
        # An objective other than the shown loss: CE plus a logit penalty.
        return ce + 0.5 * logits.float().square().mean(), ce

    step = tgpt2.make_train_step(
        model, torch.optim.SGD(model.parameters(), lr=0.5), loss_fn=loss_fn)
    shown = step(batch)

    # The twin takes the same SGD step by hand on the objective.
    objective, ce = loss_fn(twin, batch)
    assert torch.equal(shown, ce.detach())
    objective.backward()
    with torch.no_grad():
        for p in twin.parameters():
            p -= 0.5 * p.grad
    for (name, a), b in zip(model.state_dict().items(),
                            twin.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7, msg=name)
    # And the default objective is the cross-entropy, shown as it is.
    default = tgpt2.GPT2(cfg, device="cpu", seed=0)
    loss = tgpt2.make_train_step(
        default, torch.optim.SGD(default.parameters(), lr=0.5))(batch)
    assert torch.equal(loss, ce.detach())
    assert not any(torch.equal(a, b) for a, b in zip(
        default.state_dict().values(), model.state_dict().values())
        if a.dim() == 2)
