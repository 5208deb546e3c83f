"""The PyTorch port's MoE against the JAX package's, on the CPU.

One flax parameter tree, made from a seed (norm scales then moved off their
init of ones), is unboxed to numpy and carried into the port through
`params_from_jax`; the JAX side is jitted. Both run `MoEConfig.tiny()` in
float32 (plain attention, head dim 32). Tolerances: logits and the router
loss differ only in summation order over widths up to 256, 1e-4; the
dispatch tensor is 0/1 and must be equal; combine holds the renormalised
gates, float32 values near 0.5 computed in two frameworks, 1e-6. After one
SGD(0.1) step each parameter moves by 0.1 * its gradient: 1e-5.

Routing is discontinuous: a tie between a token's k-th and (k+1)-th
router probabilities could send it to either expert in either framework
(`jax.lax.top_k` breaks ties toward the lower index, `torch.topk` promises
no order). Each test that compares routing first asserts that the
reference's top k + 1 probabilities are at least 1e-5 apart at every
token, so a tie is reported, not hidden.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import moe as jmoe
from ray_tpu_torch.models import moe as tmoe

BATCH, SEQ = 2, 32
TIE_GAP = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**kw):
    return (dataclasses.replace(jmoe.MoEConfig.tiny(SEQ),
                                dtype=jnp.float32, **kw),
            dataclasses.replace(tmoe.MoEConfig.tiny(SEQ),
                                dtype=torch.float32, **kw))


def _carry(jcfg, tcfg, seed=0):
    """The JAX model, its parameters and the port's model on them. Only the
    "params" collection is carried: `init` also returns the "losses" it
    sowed, and applying the whole tree would add those stale values to the
    reference's summed router loss (`sow` appends)."""
    jmodel = jmoe.MoE(jcfg)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(seed),
                                         jnp.zeros((1, 8), jnp.int32)))()
    params = {"params": params["params"]}
    params_np = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    rng = np.random.default_rng(seed)

    def perturb(tree):
        return {k: (perturb(v) if isinstance(v, dict) else
                    (1 + 0.1 * rng.standard_normal(v.shape)).astype(
                        np.float32) if k == "scale" else v)
                for k, v in tree.items()}

    params_np = perturb(params_np)
    tmodel = tmoe.MoE(tcfg, device="cpu",
                      state=tmoe.params_from_jax(params_np))
    return jmodel, jax.tree.map(jnp.asarray, params_np), tmodel


def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, 512, (BATCH, SEQ),
                                                dtype=np.int32)


def _reference(jmodel, params, ids):
    """(logits, summed router loss, [(dispatch, combine)] per layer, [router
    probabilities [T, E]] per layer), all from the JAX model."""

    @jax.jit
    def run(p, x):
        logits, cols = jmodel.apply(p, x, capture_intermediates=True,
                                    mutable=["intermediates", "losses"])
        aux = sum(jax.tree.leaves(cols["losses"]), jnp.float32(0.0))
        inter = cols["intermediates"]
        routing, probs = [], []
        for i in range(jmodel.config.n_layer):
            layer = inter[f"layer_{i}"]
            routing.append((layer["moe"]["dispatch"][0],
                            layer["moe"]["combine"][0]))
            h = layer["mlp_norm"]["__call__"][0]
            wr = p["params"][f"layer_{i}"]["moe"]["router"]
            probs.append(jax.nn.softmax(
                h.reshape(-1, h.shape[-1]).astype(jnp.float32) @ wr, -1))
        return logits, aux, routing, probs

    return jax.tree.map(np.asarray, run(params, jnp.asarray(ids)))


def _assert_no_ties(probs, k):
    for p in probs:
        top = -np.sort(-p, axis=-1)[:, :k + 1]
        gaps = top[:, :-1] - top[:, 1:]
        assert gaps.min() > TIE_GAP, ("near tie in the reference's routing",
                                      gaps.min())


def test_logits_and_router_loss_match_jax():
    jcfg, tcfg = _configs()
    jmodel, params, tmodel = _carry(jcfg, tcfg)
    ids = _ids()
    logits_j, aux_j, _, probs = _reference(jmodel, params, ids)
    _assert_no_ties(probs, tcfg.top_k)
    with torch.no_grad():
        logits, aux = tmodel(torch.from_numpy(ids).long(), return_aux=True)
    np.testing.assert_allclose(logits.numpy(), logits_j, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(aux.item(), float(aux_j), atol=1e-4,
                               rtol=1e-4)
    assert tmodel(torch.from_numpy(ids).long()).shape == logits.shape


@pytest.mark.parametrize("capacity_factor,drops", [(2.0, False), (0.5, True)])
def test_dispatch_and_combine_match_jax(capacity_factor, drops):
    jcfg, tcfg = _configs(capacity_factor=capacity_factor)
    jmodel, params, tmodel = _carry(jcfg, tcfg, seed=1)
    ids = _ids(1)
    _, _, routing_j, probs = _reference(jmodel, params, ids)
    _assert_no_ties(probs, tcfg.top_k)
    with torch.no_grad():
        _, routing = tmodel(torch.from_numpy(ids).long(),
                            return_routing=True)
    t = BATCH * SEQ
    cap = tmoe.expert_capacity(tcfg, t)
    for (dispatch, combine), (dispatch_j, combine_j) in zip(routing,
                                                            routing_j):
        assert dispatch.shape == (t, tcfg.n_experts, cap)
        np.testing.assert_array_equal(dispatch.numpy(), dispatch_j)
        np.testing.assert_allclose(combine.numpy(), combine_j, atol=1e-6,
                                   rtol=0)
        # Every kept choice has one slot, no slot two tokens.
        assert dispatch.sum(dim=2).max() <= 1
        assert dispatch.sum(dim=0).max() <= 1
        kept = int(dispatch.sum())
        assert (kept < t * tcfg.top_k) == drops


def test_one_sgd_step_matches_jax():
    jcfg, tcfg = _configs()
    jmodel, params, tmodel = _carry(jcfg, tcfg, seed=2)
    ids = _ids(2)
    _, _, _, probs = _reference(jmodel, params, ids)
    _assert_no_ties(probs, tcfg.top_k)
    opt = optax.sgd(0.1)
    jstep = jmoe.make_moe_train_step(jmodel, opt, donate=False)
    batch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(ids)}
    params_j, _, ce_j = jstep(params, opt.init(params), batch)

    tids = torch.from_numpy(ids).long()
    step = tmoe.make_moe_train_step(
        tmodel, torch.optim.SGD(tmodel.parameters(), lr=0.1))
    ce = step({"input_ids": tids, "labels": tids})
    np.testing.assert_allclose(ce.item(), float(ce_j), atol=1e-5, rtol=0)
    want = tmoe.params_from_jax(
        jax.tree.map(np.asarray, fnn.meta.unbox(params_j)))
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_adam_steps_lower_the_cross_entropy():
    cfg = dataclasses.replace(tmoe.MoEConfig.tiny(SEQ), dtype=torch.float32)
    model = tmoe.MoE(cfg, device="cpu", seed=0)
    step = tmoe.make_moe_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3))
    ids = torch.from_numpy(_ids(3)).long()
    batch = {"input_ids": ids, "labels": ids}
    ces = [step(batch).item() for _ in range(10)]
    assert all(np.isfinite(ces)) and ces[-1] < ces[0] - 0.1, ces
    _, aux = model(ids, return_aux=True)
    assert torch.isfinite(aux) and aux.item() > 0


def test_presets_capacity_params_and_flops_match_jax():
    skip = {"dtype", "param_dtype"}
    for name in ("small", "tiny"):
        j = getattr(jmoe.MoEConfig, name)()
        t = getattr(tmoe.MoEConfig, name)()
        assert {k: v for k, v in dataclasses.asdict(j).items()
                if k not in skip} == \
            {k: v for k, v in dataclasses.asdict(t).items() if k not in skip}
        assert t.head_dim == j.head_dim
        assert tmoe.count_active_params(t) == jmoe.count_active_params(j)
        for seq in (128, 2048):
            assert tmoe.flops_per_token(t, seq) == jmoe.flops_per_token(j,
                                                                        seq)
        for n_tokens in (1, 7, 64, 8192):
            assert tmoe.expert_capacity(t, n_tokens) == \
                jmoe.expert_capacity(j, n_tokens)
    small = tmoe.MoEConfig.small()
    assert tmoe.count_active_params(small) == 229_179_392
    assert tmoe.expert_capacity(small, 4 * 2048) == 2560


def test_params_count_seed_and_router_dtype():
    cfg = dataclasses.replace(tmoe.MoEConfig.tiny(), param_dtype=torch.bfloat16)
    jcfg = jmoe.MoEConfig.tiny()
    a = tmoe.MoE(cfg, device="cpu", seed=7).state_dict()
    b = tmoe.MoE(cfg, device="cpu", seed=7).state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    # The router stays float32 whatever param_dtype is.
    assert a["layers.0.moe.router"].dtype == torch.float32
    assert a["layers.0.moe.w_gate"].dtype == torch.bfloat16
    shapes = jax.eval_shape(lambda: jmoe.MoE(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        fnn.meta.unbox(shapes["params"])))
    assert sum(t.numel() for t in a.values()) == n_jax
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmoe.MoE(cfg)


def test_bf16_dtype_flow():
    # bf16 compute: the router runs in float32 on the bf16 normed input,
    # dispatch and combine are float32, the block output is bf16. (bf16
    # logits are not compared with the reference: a near tie in bf16 router
    # probabilities sends a token to another expert in either framework.)
    cfg = tmoe.MoEConfig.tiny(SEQ)
    model = tmoe.MoE(cfg, device="cpu", seed=5)
    ids = torch.from_numpy(_ids(5)).long()
    with torch.no_grad():
        logits, aux, routing = model(ids, return_aux=True,
                                     return_routing=True)
        x = torch.randn(BATCH, SEQ, cfg.n_embd).to(torch.bfloat16)
        y, layer_aux, _, _ = model.layers[0].moe(x)
    assert logits.dtype == y.dtype == torch.bfloat16
    assert aux.dtype == layer_aux.dtype == torch.float32
    assert all(d.dtype == c.dtype == torch.float32 for d, c in routing)
    assert torch.isfinite(logits.float()).all() and torch.isfinite(aux)
