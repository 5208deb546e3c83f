"""The port's GPipe (`ray_tpu_torch.parallel.pipeline`) against the JAX
package's, on the CPU: the counterpart of tests/test_pipeline.py.

The JAX side runs `make_pp_train_step` on the 8 virtual CPU devices that
conftest sets; the port runs the same mesh shape as 4 spawned gloo ranks
(`GlooRanks`, one pool for the module), each holding its stage. Weights are
the reference's `init_pp_lm`, carried as numpy (dense weights are [in, out]
in both packages). This file imports JAX only inside the `ref` fixture: the
ranks import it.

Tolerances: both sides compute in float32 and differ in summation order
(softmax, matmuls): the reference's own 1e-4 on logits, and its 2e-4 atol /
2e-3 rtol on gradients (tests/test_pipeline.py); within the port, the
pipelined forward against `sequential_forward` bit for bit.
"""

import functools
import types

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ray_tpu_torch.models.gpt2 import next_token_loss
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel.pipeline import (from_microbatches,
                                             make_pp_train_step,
                                             sequential_forward,
                                             stack_stage_params,
                                             stage_shardings,
                                             to_microbatches,
                                             unstack_stage_params)

from gloo_ranks import GlooRanks

VOCAB, D, L, H, FF, S = 128, 32, 4, 4, 64, 16
LOGIT_TOL = dict(atol=1e-4, rtol=0)
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module")
def ranks():
    pool = GlooRanks(4, preload=__name__)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def ref():
    """The JAX package's side, on the CPU (conftest pins the platform)."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models.gpt2 import next_token_loss as jloss
    from ray_tpu.parallel import mesh, pipeline

    # The reference's init, once, jitted (its eager dispatch takes twice
    # as long); each pp regroups its stacked layers.
    init = jax.jit(functools.partial(
        pipeline.init_pp_lm, vocab=VOCAB, d_model=D, n_layer=L, n_head=H,
        d_ff=FF, n_positions=S, n_stages=1))
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    return types.SimpleNamespace(jax=jax, jnp=jnp, optax=optax, mesh=mesh,
                                 pipeline=pipeline, loss=jloss,
                                 params=params)


def _ref_params(ref, n_stages):
    """The reference's params with its trunk stacked for `n_stages`."""
    p = dict(ref.params)
    p["stages"] = {k: v.reshape(n_stages, L // n_stages, *v.shape[2:])
                   for k, v in p["stages"].items()}
    return p


def _ids(seed, b):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, S),
                                                dtype=np.int64)


def _torch(params_np):
    return {"stages": {k: torch.from_numpy(np.array(v))
                       for k, v in params_np["stages"].items()},
            **{k: torch.from_numpy(np.array(v))
               for k, v in params_np.items() if k != "stages"}}


def _placed(mesh, params):
    """Stages `Shard(0)` over pp, the rest replicated: stage_shardings."""
    sh = stage_shardings(mesh, params)
    out = {k: distribute_tensor(v, *sh[k]) for k, v in params.items()
           if k != "stages"}
    out["stages"] = {k: distribute_tensor(v, *sh["stages"][k])
                     for k, v in params["stages"].items()}
    return out


def _mesh(axes):
    return tmesh.build_mesh(tmesh.MeshSpec(axes), device_type="cpu")


def test_stack_unstack_roundtrip():
    layers = {"w": torch.arange(24.0).reshape(8, 3)}
    staged = stack_stage_params(layers, 4)
    assert staged["w"].shape == (4, 2, 3)
    assert torch.equal(unstack_stage_params(staged)["w"], layers["w"])
    with pytest.raises(ValueError):
        stack_stage_params(layers, 3)


def test_microbatch_roundtrip():
    x = torch.arange(32.0).reshape(8, 4)
    mb = to_microbatches(x, 4)
    assert mb.shape == (4, 2, 4)
    assert torch.equal(from_microbatches(mb), x)
    with pytest.raises(ValueError):
        to_microbatches(x, 3)


def _forward_rank(rank, axes, params_np, ids, m, remat):
    """The pipelined forward on DTensor-placed params, and whether it is
    bit-equal to sequential_forward."""
    mesh = _mesh(axes)
    params = _torch(params_np)
    _, forward = make_pp_train_step(mesh, H, m, torch.optim.SGD,
                                    remat_stage=remat)
    placed = _placed(mesh, params)
    assert all(isinstance(v, DTensor) for v in placed["stages"].values())
    ids = torch.from_numpy(ids)
    with torch.no_grad():
        y = forward(placed, ids)
        seq = sequential_forward(params, ids, H)
    return y.numpy(), torch.equal(y, seq)


@pytest.mark.parametrize("axes", [{"pp": 4}, {"dp": 2, "pp": 2}],
                         ids=["pp4", "dp2-pp2"])
def test_pipelined_forward_matches_sequential_and_reference(ranks, ref,
                                                            axes):
    """Every rank's pipelined logits equal sequential_forward's bit for
    bit, and the reference's pipelined forward on the same mesh shape."""
    pp = axes["pp"]
    params = _ref_params(ref, pp)
    ids = _ids(1, 8)
    jmesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(axes),
                                devices=ref.jax.devices()[:4])
    _, jforward = ref.pipeline.make_pp_train_step(
        jmesh, H, n_microbatches=4, optimizer=ref.optax.adam(1e-2))
    placed = ref.jax.device_put(params,
                                ref.pipeline.stage_shardings(jmesh, params))
    with jmesh:
        want = np.asarray(ref.jax.jit(jforward)(placed, ids))
    for y, bit_equal in ranks.run(_forward_rank, axes, params, ids, 4,
                                  False):
        assert bit_equal
        np.testing.assert_allclose(y, want, **LOGIT_TOL)


def _grad_rank(rank, axes, params_np, ids, m, remat):
    """next_token_loss's gradients through the pipelined forward: this
    rank's stage (its [1, L/P, ...] shard) and the replicated leaves."""
    mesh = _mesh(axes)
    params = _torch(params_np)
    leaves = {k: v for k, v in params.items() if k != "stages"}
    stages = {k: v[rank:rank + 1].clone() for k, v in
              params["stages"].items()}
    for t in list(leaves.values()) + list(stages.values()):
        t.requires_grad_()
    _, forward = make_pp_train_step(mesh, H, m, torch.optim.SGD,
                                    remat_stage=remat)
    ids = torch.from_numpy(ids)
    loss = next_token_loss(forward({"stages": stages, **leaves}, ids), ids)
    loss.backward()
    return (loss.item(), {k: v.grad[0].numpy() for k, v in stages.items()},
            {k: v.grad.numpy() for k, v in leaves.items()})


def test_pipelined_grads_match_reference(ranks, ref):
    """Every gradient (each rank's stage, and embed, pos and head on every
    rank) against the reference's jax.grad through its pipelined forward,
    at pp 4: the embedding's is nonzero only through stage 0, the head's
    the same on every rank."""
    params = _ref_params(ref, 4)
    ids = _ids(2, 4)
    jmesh = ref.mesh.build_mesh(ref.mesh.MeshSpec({"pp": 4}),
                                devices=ref.jax.devices()[:4])
    _, jforward = ref.pipeline.make_pp_train_step(
        jmesh, H, n_microbatches=2, optimizer=ref.optax.sgd(0.1))
    placed = ref.jax.device_put(params,
                                ref.pipeline.stage_shardings(jmesh, params))

    def loss(p):
        return ref.loss(jforward(p, ids), ids)

    with jmesh:
        want_loss, want = ref.jax.jit(ref.jax.value_and_grad(loss))(placed)
    want = ref.jax.tree.map(np.asarray, want)
    for rank, (got_loss, stage, rest) in enumerate(
            ranks.run(_grad_rank, {"pp": 4}, params, ids, 2, False)):
        assert abs(got_loss - float(want_loss)) < 1e-5
        for k, g in stage.items():
            np.testing.assert_allclose(g, want["stages"][k][rank],
                                       err_msg=f"stages/{k}", **GRAD_TOL)
        for k, g in rest.items():
            np.testing.assert_allclose(g, want[k], err_msg=k, **GRAD_TOL)
        assert np.abs(rest["embed"]).max() > 0


def test_remat_stage_same_result(ranks, ref):
    """remat_stage recomputes each stage in the backward: the same loss
    and the same gradients, bit for bit."""
    params = _ref_params(ref, 4)
    ids = _ids(3, 4)
    plain = ranks.run(_grad_rank, {"pp": 4}, params, ids, 2, False)
    remat = ranks.run(_grad_rank, {"pp": 4}, params, ids, 2, True)
    for (la, sa, ra), (lb, sb, rb) in zip(plain, remat):
        assert la == lb
        for a, b in ((sa, sb), (ra, rb)):
            assert all(np.array_equal(a[k], b[k]) for k in a)


def _train_rank(rank, axes, params_np, ids, steps):
    """`steps` Adam steps of make_pp_train_step on DTensor-placed params;
    the losses and this rank's stage after them."""
    mesh = _mesh(axes)
    params = _placed(mesh, _torch(params_np))
    step, _ = make_pp_train_step(
        mesh, H, 4, functools.partial(torch.optim.Adam, lr=1e-2))
    ids = torch.from_numpy(ids)
    state, losses = None, []
    for _ in range(steps):
        params, state, loss = step(params, state,
                                   {"input_ids": ids, "labels": ids})
        losses.append(loss.item())
    return losses, params["head"].to_local().numpy()


def test_pipelined_training_converges(ranks, ref):
    """Adam steps at dp 2 x pp 2 lower the loss, the first loss is the
    reference's, and every rank ends with the same (replicated) head: the
    gradients were summed over dp and are global over pp."""
    params = _ref_params(ref, 2)
    ids = _ids(1, 8)
    jmesh = ref.mesh.build_mesh(ref.mesh.MeshSpec({"dp": 2, "pp": 2}),
                                devices=ref.jax.devices()[:4])
    opt = ref.optax.adam(1e-2)
    jstep, _ = ref.pipeline.make_pp_train_step(jmesh, H, n_microbatches=4,
                                               optimizer=opt)
    p = ref.jax.device_put(params,
                           ref.pipeline.stage_shardings(jmesh, params))
    _, _, first = jstep(p, ref.jax.jit(opt.init)(p),
                        {"input_ids": ids, "labels": ids})
    results = ranks.run(_train_rank, {"dp": 2, "pp": 2}, params, ids, 6)
    for losses, head in results:
        assert losses == results[0][0]
        assert abs(losses[0] - float(first)) < 1e-5
        assert losses[-1] < losses[0]
        assert np.array_equal(head, results[0][1])
