"""The port's MoE expert parallelism against the JAX package's GSPMD step,
on the CPU.

The reference steps MoE on a mesh through GSPMD (`make_moe_train_step(
mesh=)`: the stacked expert weights carry the "expert" axis, which the
rules put on ep), which computes the single-device function over the
global batch. The port runs the same step in spawned gloo ranks
(`tests/gloo_ranks.py`), one rank a device: each ep rank holds E / ep
experts, the queue and the capacity are the global batch's, the combine is
reduced over ep and tp. The JAX side runs on conftest's virtual CPU
devices. Both sides run `MoEConfig.tiny(seq=32)` in float32 from one
numpy-seeded batch and one flax tree carried by `params_from_jax`.

Limits: the loss within 1e-5 relative (float32 summation order); after one
SGD step at lr 1 (so a parameter's change is its gradient) every parameter
within 1e-5; each layer's dispatch, gathered from the ranks, equal to the
reference's sown one, and its combine within 1e-6. Routing is
discontinuous: each case first asserts the reference's top-k + 1 router
probabilities are 1e-5 apart at every token (as tests/test_torch_moe.py
does), so a tie is reported, not hidden. JAX is imported only inside
fixtures: the ranks import this file.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel.sharding import shard_batch
from gloo_ranks import GlooRanks

BATCH, SEQ = 4, 32
LR = 1.0
LOSS_RTOL, PARAM_ATOL, COMBINE_ATOL = 1e-5, 1e-5, 1e-6
TIE_GAP = 1e-5
MESHES = {"ep4": {"ep": 4}, "dp2_ep2": {"dp": 2, "ep": 2},
          "ep2_tp2": {"tp": 2, "ep": 2}, "fsdp2_ep2": {"fsdp": 2, "ep": 2},
          "sp2_ep2": {"sp": 2, "ep": 2}}
# The reference's own test's mesh, and FSDP2 over expert weights split on
# three axes.
WIDE = {"dp2_ep2_tp2": {"dp": 2, "tp": 2, "ep": 2},
        "fsdp2_ep2_tp2": {"fsdp": 2, "tp": 2, "ep": 2}}


@pytest.fixture(scope="module")
def ranks():
    pool = GlooRanks(4, timeout_s=120, preload=__name__)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def wide_ranks():
    pool = GlooRanks(8, timeout_s=120, preload=__name__)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def ref():
    """The JAX package's side, on the CPU (conftest pins the platform)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import optax
    from flax import traverse_util

    from ray_tpu.models import gpt2, moe
    from ray_tpu.parallel import mesh, sharding

    return types.SimpleNamespace(jax=jax, jnp=jnp, fnn=fnn, optax=optax,
                                 traverse_util=traverse_util, gpt2=gpt2,
                                 moe=moe, mesh=mesh, sharding=sharding)


def _config(capacity_factor=1.25):
    return dataclasses.replace(tmoe.MoEConfig.tiny(seq=SEQ),
                               dtype=torch.float32,
                               capacity_factor=capacity_factor)


def _ids(seed):
    return np.random.default_rng(seed).integers(0, 512, (BATCH, SEQ),
                                                dtype=np.int32)


_REFERENCES = {}


def _reference(ref, capacity_factor, seed, ids):
    """The JAX model's flax tree from `seed` (norm scales moved off their
    init of ones) as numpy, and its single-device forward's per-layer
    dispatch, combine and router probabilities on `ids` (made once for
    each capacity factor and seed)."""
    key = (capacity_factor, seed, ids.tobytes())
    if key not in _REFERENCES:
        _REFERENCES[key] = _make_reference(ref, capacity_factor, seed, ids)
    return _REFERENCES[key]


def _make_reference(ref, capacity_factor, seed, ids):
    jax, jnp = ref.jax, ref.jnp
    jcfg = dataclasses.replace(ref.moe.MoEConfig.tiny(seq=SEQ),
                               dtype=jnp.float32,
                               capacity_factor=capacity_factor)
    model = ref.moe.MoE(jcfg)
    params = jax.jit(lambda: model.init(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, 8), jnp.int32)))()
    tree = jax.tree.map(np.asarray, ref.fnn.meta.unbox(
        {"params": params["params"]}))
    rng = np.random.default_rng(seed)

    def perturb(t):
        return {k: (perturb(v) if isinstance(v, dict) else
                    (1 + 0.1 * rng.standard_normal(v.shape)).astype(
                        np.float32) if k == "scale" else v)
                for k, v in t.items()}

    tree = perturb(tree)

    @jax.jit
    def run(p, x):
        _, cols = model.apply(p, x, capture_intermediates=True,
                              mutable=["intermediates", "losses"])
        out = []
        for i in range(jcfg.n_layer):
            layer = cols["intermediates"][f"layer_{i}"]
            h = layer["mlp_norm"]["__call__"][0]
            wr = p["params"][f"layer_{i}"]["moe"]["router"]
            out.append((layer["moe"]["dispatch"][0],
                        layer["moe"]["combine"][0],
                        jax.nn.softmax(h.reshape(-1, h.shape[-1]) @ wr, -1)))
        return out

    routing = jax.tree.map(np.asarray, run(jax.tree.map(jnp.asarray, tree),
                                           jnp.asarray(ids)))
    for _, _, probs in routing:
        top = -np.sort(-probs, axis=-1)[:, :jcfg.top_k + 1]
        gaps = top[:, :-1] - top[:, 1:]
        assert gaps.min() > TIE_GAP, ("near tie in the reference's routing",
                                      gaps.min())
    return model, tree, routing


def _jax_mesh_step(ref, model, tree, axes, ids):
    """The reference's `make_moe_train_step(mesh=)` (SGD at LR) on a mesh
    of virtual devices: (params after the step, numpy; loss)."""
    jax, jnp = ref.jax, ref.jnp
    n = int(np.prod(list(axes.values())))
    mesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(axes),
                               devices=jax.devices()[:n])
    shardings = ref.gpt2.mesh_shardings_for(model, mesh, (BATCH, SEQ))
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            {"params": shardings["params"]})
    opt = ref.optax.sgd(LR)
    sharding = ref.sharding.named_sharding(mesh, "batch", "seq")
    batch = {k: jax.device_put(jnp.asarray(ids), sharding)
             for k in ("input_ids", "labels")}
    step = ref.moe.make_moe_train_step(model, opt, mesh=mesh, donate=False)
    new, _, loss = step(params, opt.init(params), batch)
    return tmoe.params_from_jax(
        jax.tree.map(np.asarray, ref.fnn.meta.unbox(new))), float(loss)


def _mesh_step(rank, axes, state, ids, capacity_factor):
    """`MoE(mesh=, state=)` on this rank's shard: its routing (a forward
    before the step), one SGD step at LR, and (global loss, whole
    parameters after the step, per-layer (dispatch, combine) of its tokens
    and experts, its (data shard, sp, ep) coordinates)."""
    mesh = tmesh.build_mesh(tmesh.MeshSpec(axes), device_type="cpu")
    model = tmoe.MoE(_config(capacity_factor), mesh=mesh, state=state)
    # The optimizer takes the parameters before any forward: after one,
    # FSDP2's root module holds its unsharded parameters until the next.
    step = tmoe.make_moe_train_step(
        model, torch.optim.SGD(model.parameters(), lr=LR), mesh=mesh)
    t = torch.from_numpy(ids).long()
    batch = shard_batch({"input_ids": t, "labels": t}, mesh)
    with torch.no_grad():
        _, routing = model(batch["input_ids"], return_routing=True)
    loss = step(batch).item()
    coords = (tmesh.data_parallel_rank(mesh), tmesh.axis_rank(mesh, "sp"),
              tmesh.axis_rank(mesh, "ep"))
    return loss, tmoe.full_state(model), routing, coords


def _assemble(got, axes, cfg):
    """Each layer's global [T, E, C] dispatch and combine from the ranks'
    pieces (rows by data shard, positions by sp shard, experts by ep); tp
    peers must hold the same pieces."""
    n_data = axes.get("dp", 1) * axes.get("fsdp", 1)
    sp, ep = axes.get("sp", 1), axes.get("ep", 1)
    b, s, e = BATCH // n_data, SEQ // sp, cfg.n_experts // ep
    out = []
    for layer in range(cfg.n_layer):
        cap = got[0][2][layer][0].shape[-1]
        whole = [np.full((BATCH, SEQ, cfg.n_experts, cap), np.nan,
                         np.float32) for _ in range(2)]
        for _, _, routing, (d, p, q) in got:
            for w, piece in zip(whole, routing[layer]):
                piece = piece.numpy().reshape(b, s, e, cap)
                block = w[d * b:(d + 1) * b, p * s:(p + 1) * s,
                          q * e:(q + 1) * e]
                assert np.isnan(block).all() or np.array_equal(block, piece)
                block[...] = piece
        out.append([w.reshape(BATCH * SEQ, cfg.n_experts, cap)
                    for w in whole])
    return out


def _check(ref, pool, axes, capacity_factor=1.25, seed=0):
    """The port's mesh step against the reference's on `axes`; returns the
    reference's routing."""
    ids = _ids(seed)
    model, tree, routing = _reference(ref, capacity_factor, seed, ids)
    jnew, jloss = _jax_mesh_step(ref, model, tree, axes, ids)
    got = pool.run(_mesh_step, axes, tmoe.params_from_jax(tree), ids,
                   capacity_factor)
    for loss, params, _, _ in got:
        assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
        assert params.keys() == jnew.keys()
        for name, want in jnew.items():
            np.testing.assert_allclose(params[name].numpy(), want.numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=name)
    cfg = _config(capacity_factor)
    for (dispatch, combine), (jdispatch, jcombine, _) in zip(
            _assemble(got, axes, cfg), routing):
        np.testing.assert_array_equal(dispatch, jdispatch)
        np.testing.assert_allclose(combine, jcombine, atol=COMBINE_ATOL,
                                   rtol=0)
    return routing


@pytest.mark.parametrize("name", list(MESHES))
def test_moe_mesh_step_matches_reference(ranks, ref, name):
    """One SGD step of `MoE(mesh=)` at ep 4, dp 2 x ep 2, ep 2 x tp 2,
    fsdp 2 x ep 2 and sp 2 x ep 2 (4 ranks): the global loss, every
    parameter after the step, and each layer's dispatch and combine
    against the reference's GSPMD step on the same mesh."""
    _check(ref, ranks, MESHES[name])


@pytest.mark.parametrize("name", list(WIDE))
def test_moe_mesh_step_on_eight_ranks_matches_reference(wide_ranks, ref,
                                                        name):
    """8 ranks: the reference's own expert-parallel mesh
    (tests/test_models.py's dp 2 x ep 2 x tp 2), where the partial sums
    close over ep and tp together and the router's logits stay
    replicated; and fsdp 2 x ep 2 x tp 2, FSDP2 over expert weights split
    over ep and tp."""
    _check(ref, wide_ranks, WIDE[name])


def _per_rank_queue(cfg, probs, shards):
    """The kept (token, expert) pairs [T, E] of a routing that queues and
    sizes capacity per rank: `shards` index arrays of each rank's tokens,
    each given `_dispatch` over its own tokens at its own token count's
    capacity. What a global queue must not be."""
    p = torch.from_numpy(np.array(probs))
    gate_vals, gate_idx = torch.topk(p, cfg.top_k, dim=-1)
    kept = np.zeros(p.shape, bool)
    for idx in shards:
        dispatch, _ = tmoe._dispatch(
            gate_idx[idx], gate_vals[idx], cfg.n_experts,
            tmoe.expert_capacity(cfg, len(idx)))
        kept[idx] = dispatch.sum(-1).numpy() > 0
    return kept


@pytest.mark.parametrize("name", ["dp2_ep2", "sp2_ep2"])
def test_tight_capacity_fills_the_global_queue(ranks, ref, name):
    """At capacity factor 0.5 drops cross the ranks' borders: a queue per
    rank (its tokens alone, its own capacity) keeps other tokens than the
    reference's global queue, and the port's mesh step keeps the global
    queue's (its dispatch equal to the reference's in every layer)."""
    axes = MESHES[name]
    cfg = _config(0.5)
    routing = _check(ref, ranks, axes, capacity_factor=0.5, seed=2)
    tokens = np.arange(BATCH * SEQ).reshape(BATCH, SEQ)
    if "dp" in axes:
        shards = [tokens[:BATCH // 2].ravel(), tokens[BATCH // 2:].ravel()]
    else:
        shards = [tokens[:, :SEQ // 2].ravel(), tokens[:, SEQ // 2:].ravel()]
    for dispatch, _, probs in routing:
        kept = dispatch.sum(-1) > 0
        assert kept.sum() < BATCH * SEQ * cfg.top_k        # drops happen
        assert (_per_rank_queue(cfg, probs, shards) != kept).any()


def _placed(rank, axes, seed):
    """`MoE(mesh=, seed=)`: its whole parameters and its expert shard's
    local shape."""
    mesh = tmesh.build_mesh(tmesh.MeshSpec(axes), device_type="cpu")
    model = tmoe.MoE(_config(), mesh=mesh, seed=seed)
    w = model.layers[0].moe.w_gate
    return tmoe.full_state(model), tuple(getattr(w, "to_local",
                                                 lambda: w)().shape)


@pytest.mark.parametrize("axes", [{"tp": 2, "ep": 2}, {"fsdp": 2, "ep": 2}])
def test_seeded_placement_equals_the_unsharded_model(ranks, axes):
    """Each parameter drawn whole and cut to this rank's piece: gathered
    back, the model equals `MoE(cfg, seed=)` bit for bit; each rank holds
    E / ep experts (and f / tp of their hidden columns, d / fsdp of their
    input rows)."""
    cfg = _config()
    whole = tmoe.MoE(cfg, device="cpu", seed=3).state_dict()
    want_shape = (cfg.n_experts // 2,
                  cfg.n_embd // axes.get("fsdp", 1),
                  cfg.intermediate // axes.get("tp", 1))
    for params, shape in ranks.run(_placed, axes, 3):
        assert shape == want_shape
        assert params.keys() == whole.keys()
        for name, want in whole.items():
            assert torch.equal(params[name], want), name


@pytest.fixture
def fake_world():
    """8 ranks of a fake process group in this process: placements need no
    peers."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def test_mesh_refuses_experts_ep_does_not_divide(fake_world):
    cfg = dataclasses.replace(_config(), n_experts=6)
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"ep": 4}), devices=range(4),
                            device_type="cpu")
    with pytest.raises(ValueError, match="ep=4"):
        tmoe.MoE(cfg, mesh=mesh, seed=0)
    with pytest.raises(ValueError, match="tp=8"):
        tmoe.validate_mesh(_config(), tmesh.build_mesh(
            tmesh.MeshSpec({"tp": 8}), device_type="cpu"))


def _read_back(placements, names, ndim):
    dims = [[] for _ in range(ndim)]
    for name, pl in zip(names, placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
    return tuple(None if not d else (d[0] if len(d) == 1 else tuple(d))
                 for d in dims)


def _entries(spec, ndim):
    out = []
    for i in range(ndim):
        e = spec[i] if i < len(spec) else None
        if isinstance(e, (tuple, list)):
            e = tuple(e) if len(e) > 1 else (e[0] if e else None)
        out.append(e)
    return tuple(out)


def test_mesh_shardings_match_reference(fake_world, ref):
    """`mesh_shardings_for` on the port's names against the reference's
    on the flax tree at dp 2 x fsdp 2 x ep 2 (with tp 2 over 8 ranks in
    the second mesh): each parameter split on the same dims over the same
    axes (a dense weight is the flax kernel transposed)."""
    jax = ref.jax
    model = tmoe.MoE(_config(), device="cpu")
    jmodel = ref.moe.MoE(ref.moe.MoEConfig.tiny(seq=SEQ))
    for axes in ({"dp": 2, "fsdp": 2, "ep": 2}, WIDE["dp2_ep2_tp2"]):
        mesh = tmesh.build_mesh(tmesh.MeshSpec(axes), devices=range(8),
                                device_type="cpu")
        jmesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(axes),
                                    devices=jax.devices()[:8])
        flat = ref.traverse_util.flatten_dict(
            ref.gpt2.mesh_shardings_for(jmodel, jmesh, (BATCH, SEQ))
            ["params"], sep="/")
        got = tmoe.mesh_shardings_for(model, mesh)
        assert len(got) == len(flat)
        for name, p in model.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers":
                parts = [f"layer_{parts[1]}"] + parts[2:]
            leaf = parts[-1]
            flip = leaf == "weight" and not parts[-2].endswith("norm")
            if leaf == "weight":
                parts[-1] = "scale" if parts[-2].endswith("norm") \
                    else "kernel"
            want = _entries(flat["/".join(parts)].spec, p.dim())
            if flip:
                want = want[::-1]
            assert _read_back(got[name], mesh.mesh_dim_names, p.dim()) \
                == want, name
