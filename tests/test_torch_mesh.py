"""The port's mesh layer (`ray_tpu_torch.parallel`) against the JAX
package's, on the CPU.

Parity with tests/test_mesh.py. The JAX side lays its meshes over the 8
virtual CPU devices that conftest sets; the port lays its DeviceMeshes over
8 ranks of a fake process group in this process (placements, shapes and
rank layouts need no peers), and the one computation, a sharded matmul,
runs in 2 spawned gloo processes. A port placement is compared with the
reference's PartitionSpec by reading it back per tensor dim. The JAX side
is imported by the `ref` fixture, not at the top: the spawned ranks import
this file, and start in half the time without JAX.
"""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import distributed as tdist
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsharding
from test_torch_ring_attention import GlooRanks

MESHES = [{"dp": 2, "fsdp": 2, "tp": 2}, {"dp": 2, "sp": 2, "tp": 2},
          {"dp": 8}, {"fsdp": 4, "tp": 2}, {"tp": 2, "dp": -1}]
LOGICAL = [("batch", "embed"), ("embed", "mlp"), ("batch", "seq", "embed"),
           ("vocab", "embed"), ("batch", "seq", "heads", None),
           ("mlp", "embed"), ("expert", "embed", "mlp"), (None, "embed"),
           ("norm",)]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's side, on the CPU (conftest pins the platform)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2, llama
    from ray_tpu.parallel import mesh, sharding

    return types.SimpleNamespace(jax=jax, jnp=jnp, gpt2=gpt2, llama=llama,
                                 mesh=mesh, sharding=sharding)


@pytest.fixture
def fake_world():
    """8 ranks of a fake process group: this process is rank 0, and every
    collective is a no-op."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def _entries(spec, ndim):
    """A PartitionSpec (either package's) as one entry per tensor dim: None,
    an axis, or a tuple of several, in order."""
    out = []
    for i in range(ndim):
        e = spec[i] if i < len(spec) else None
        if isinstance(e, (tuple, list)):
            e = tuple(e) if len(e) > 1 else (e[0] if e else None)
        out.append(e)
    return tuple(out)


def _read_back(placements, names, ndim):
    """The per-dim entries that DTensor placements on a mesh say."""
    dims = [[] for _ in range(ndim)]
    for name, pl in zip(names, placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
    return tuple(None if not d else (d[0] if len(d) == 1 else tuple(d))
                 for d in dims)


def test_meshspec_resolution_matches_reference(ref):
    for axes, n in [({"dp": -1}, 8), ({"dp": 2, "tp": -1}, 8),
                    ({"fsdp": -1, "tp": 2}, 4), ({"dp": 1, "sp": 4}, 4)]:
        assert tmesh.MeshSpec(axes).resolved(n) == \
            ref.mesh.MeshSpec(axes).resolved(n)
    for axes in ({"dp": 3}, {"dp": -1, "tp": -1}):
        for spec in (tmesh.MeshSpec(axes), ref.mesh.MeshSpec(axes)):
            with pytest.raises(ValueError):
                spec.resolved(8)
    assert tmesh.MeshSpec.for_training(dp=2, sp=2).axes == \
        ref.mesh.MeshSpec.for_training(dp=2, sp=2).axes


def test_axis_order_is_canonical(ref):
    spec = tmesh.MeshSpec({"tp": 2, "dp": 2, "sp": 2, "zz": 1})
    assert spec.axis_names() == ("dp", "sp", "tp", "zz")
    assert spec.axis_names() == ref.mesh.MeshSpec(spec.axes).axis_names()
    assert tmesh.AXIS_ORDER == ref.mesh.AXIS_ORDER


@pytest.mark.parametrize("axes,dcn", [
    ({"dp": 2, "fsdp": 2, "tp": 2}, ()), ({"dp": 2, "tp": 4}, ("dp",)),
    ({"dp": 2, "tp": 4}, ("tp",)), ({"sp": 4, "dp": 2}, ())])
def test_build_mesh_layout_matches_reference(fake_world, axes, dcn, ref):
    """Axis names, shape and which rank sits where (device id = rank), DCN
    axes slowest."""
    got = tmesh.build_mesh(tmesh.MeshSpec(axes, dcn_axes=dcn),
                           device_type="cpu")
    want = ref.mesh.build_mesh(ref.mesh.MeshSpec(axes, dcn_axes=dcn))
    assert got.mesh_dim_names == want.axis_names
    assert tmesh.mesh_shape_summary(got) == ref.mesh.mesh_shape_summary(want)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.mesh.numpy(), ids)
    if dcn:
        assert got.mesh_dim_names[0] == dcn[0]


def test_build_mesh_needs_cuda_unless_cpu_is_asked(fake_world):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.build_mesh(tmesh.MeshSpec({"dp": -1}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.local_mesh("dp")
    assert tmesh.mesh_shape_summary(tmesh.local_mesh("sp", "cpu")) == \
        {"sp": 8}


def test_build_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tmesh.build_mesh(tmesh.MeshSpec({"dp": 1}), device_type="cpu")


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "-".join(a))
def test_rules_give_the_reference_partition_specs(fake_world, axes, ref):
    got_mesh = tmesh.build_mesh(tmesh.MeshSpec(axes), device_type="cpu")
    want_mesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(axes))
    for logical in LOGICAL:
        mesh, placements = tsharding.named_sharding(got_mesh, *logical)
        assert mesh is got_mesh and len(placements) == got_mesh.ndim
        want = ref.sharding.named_sharding(want_mesh, *logical).spec
        assert _read_back(placements, got_mesh.mesh_dim_names,
                          len(logical)) == _entries(want, len(logical)), \
            (axes, logical)
    _, batch = tsharding.batch_sharding(got_mesh)
    assert _read_back(batch, got_mesh.mesh_dim_names, 1) == _entries(
        ref.sharding.batch_sharding(want_mesh).spec, 1)
    _, rep = tsharding.replicated(got_mesh)
    assert _read_back(rep, got_mesh.mesh_dim_names, 2) == (None, None)


def test_logical_axis_rules_prune_absent_axes_as_reference(ref):
    for mesh_axes in (None, ("dp",), ("dp", "tp"), ("fsdp", "sp", "tp")):
        for overrides in (None, {"embed": None, "kv": "tp"}):
            assert tsharding.logical_axis_rules(overrides, mesh_axes) == \
                ref.sharding.logical_axis_rules(overrides, mesh_axes)


def test_validate_divisibility(fake_world, ref):
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"dp": 4, "sp": 2}),
                            device_type="cpu")
    jm = ref.mesh.build_mesh(ref.mesh.MeshSpec({"dp": 4, "sp": 2}))
    for fn, m in ((tmesh.validate_divisibility, mesh),
                  (ref.mesh.validate_divisibility, jm)):
        fn(m, batch_size=8, seq_len=128)
        with pytest.raises(ValueError):
            fn(m, batch_size=6)
        with pytest.raises(ValueError):
            fn(m, batch_size=8, seq_len=127)


def test_shard_params_places_leaves(fake_world, ref):
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"dp": 2, "tp": 4}),
                            device_type="cpu")
    params = {"w": torch.ones(16, 8), "b": torch.ones(8), "n": torch.ones(8)}
    axes = {"w": ("embed", "mlp"), "b": None, "n": ()}
    placed = tsharding.shard_params(params, mesh, axes)
    assert _read_back(placed["w"].placements, mesh.mesh_dim_names, 2) == \
        (None, "tp")
    assert placed["w"].to_local().shape == (16, 2)
    for name in ("b", "n"):
        assert all(p.is_replicate() for p in placed[name].placements)
        assert placed[name].to_local().shape == (8,)
    jm = ref.mesh.build_mesh(ref.mesh.MeshSpec({"dp": 2, "tp": 4}))
    want = ref.sharding.shard_params(
        {k: ref.jnp.ones(tuple(v.shape)) for k, v in params.items()
         if k != "n"}, jm, {"w": axes["w"], "b": None})
    assert want["w"].sharding.spec[1] == "tp"
    assert want["b"].sharding.is_fully_replicated


def test_with_logical_constraint(fake_world):
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"dp": 2, "tp": 4}),
                            device_type="cpu")
    x = torch.ones(4, 8)
    assert tsharding.with_logical_constraint(x, mesh, "batch", "mlp") is x
    d = tsharding.shard_params({"x": x}, mesh, {"x": ("batch", None)})["x"]
    moved = tsharding.with_logical_constraint(d, mesh, None, "mlp")
    assert _read_back(moved.placements, mesh.mesh_dim_names, 2) == \
        (None, "tp")


def _llama_names_of_reference_paths(n_layer):
    """Reference flax path ("layer_0/wq/kernel") -> (port name, whether
    the port's tensor is the reference's transpose)."""
    out = {"embed": ("embed", False),
           "final_norm/scale": ("final_norm.weight", False),
           "lm_head/kernel": ("lm_head.weight", True)}
    for i in range(n_layer):
        for norm in ("attn_norm", "mlp_norm"):
            out[f"layer_{i}/{norm}/scale"] = (f"layers.{i}.{norm}.weight",
                                              False)
        for dense in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            out[f"layer_{i}/{dense}/kernel"] = (f"layers.{i}.{dense}.weight",
                                                True)
    return out


def test_llama_rules_match_the_reference_on_port_names(ref):
    """match_partition_rules over the port's state dict gives each
    parameter the reference's spec (a dense weight's dims reversed)."""
    import flax.linen as fnn

    cfg = ref.llama.LlamaConfig.tiny()
    ids = ref.jnp.zeros((1, 8), ref.jnp.int32)
    params = fnn.meta.unbox(ref.jax.eval_shape(
        lambda: ref.llama.Llama(cfg).init(ref.jax.random.PRNGKey(0), ids)
    )["params"])
    want = ref.sharding.match_partition_rules(
        ref.llama.LLAMA_PARTITION_RULES, params)
    want_flat = {"/".join(str(k.key) for k in path): spec for path, spec
                 in ref.jax.tree_util.tree_flatten_with_path(
                     want, is_leaf=lambda x: isinstance(
                         x, ref.jax.sharding.PartitionSpec))[0]}
    model = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu")
    state = dict(model.state_dict())
    got = tsharding.match_partition_rules(tllama.LLAMA_PARTITION_RULES,
                                          state)
    names = _llama_names_of_reference_paths(cfg.n_layer)
    assert sorted(n for n, _ in names.values()) == sorted(state)
    for path, spec in want_flat.items():
        name, transposed = names[path]
        ndim = state[name].dim()
        entries = _entries(spec, ndim)
        if transposed:
            entries = entries[::-1]
        assert _entries(got[name], ndim) == entries, (path, name)
    state["scalar"] = torch.tensor(1.0)
    assert tsharding.match_partition_rules(
        tllama.LLAMA_PARTITION_RULES, state)["scalar"] == \
        tsharding.PartitionSpec()
    state["layers.0.renamed.weight"] = torch.ones(2, 2)
    with pytest.raises(ValueError, match="no partition rule"):
        tsharding.match_partition_rules(tllama.LLAMA_PARTITION_RULES, state)


def test_shard_params_by_rules_prunes_absent_axes(fake_world):
    model = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu")
    state = {k: v for k, v in model.state_dict().items()
             if k.startswith(("embed", "layers.0.", "lm_head"))}
    tp_mesh = tmesh.build_mesh(tmesh.MeshSpec({"sp": 4, "tp": 2}),
                               device_type="cpu")
    placed = tsharding.shard_params_by_rules(
        state, tp_mesh, tllama.LLAMA_PARTITION_RULES)
    names = tp_mesh.mesh_dim_names
    assert _read_back(placed["layers.0.wq.weight"].placements, names, 2) == \
        ("tp", None)
    assert _read_back(placed["layers.0.wo.weight"].placements, names, 2) == \
        (None, "tp")
    assert _read_back(placed["embed"].placements, names, 2) == ("tp", None)
    dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    sp_mesh = tmesh.build_mesh(tmesh.MeshSpec({"sp": 4}), device_type="cpu")
    placed = tsharding.shard_params_by_rules(
        state, sp_mesh, tllama.LLAMA_PARTITION_RULES)
    assert all(p.is_replicate() for t in placed.values()
               for p in t.placements)


@pytest.mark.parametrize("axes", MESHES[:4], ids=lambda a: "-".join(a))
def test_gpt2_param_shardings_match_reference(fake_world, axes, ref):
    """logical_param_specs and mesh_shardings_for give each parameter the
    placements the reference's annotations resolve to."""
    cfg = tgpt2.GPT2Config.tiny()
    model = tgpt2.GPT2(cfg, device="cpu")
    mesh = tmesh.build_mesh(tmesh.MeshSpec(axes), device_type="cpu")
    got = tgpt2.mesh_shardings_for(model, mesh)
    want = ref.gpt2.mesh_shardings_for(
        ref.gpt2.GPT2(ref.gpt2.GPT2Config.tiny()),
        ref.mesh.build_mesh(ref.mesh.MeshSpec(axes)), (1, 8))["params"]
    shapes = {n: p.dim() for n, p in model.named_parameters()}
    assert set(got) == set(shapes)
    for name, placements in got.items():
        parts = name.split(".")
        if len(parts) == 1:
            node, transposed = want[name], False
        else:
            node = want if parts[0] != "h" else want[f"h_{parts[1]}"]
            module, leaf = parts[-2], parts[-1]
            flax_leaf = {"weight": "kernel" if "ln" not in module
                         else "scale", "bias": "bias"}[leaf]
            node = node[module][flax_leaf]
            transposed = flax_leaf == "kernel"
        entries = _entries(node.spec, shapes[name])
        if transposed:
            entries = entries[::-1]
        assert _read_back(placements, mesh.mesh_dim_names,
                          shapes[name]) == entries, (axes, name)


def test_gpt2_init_sharded_places_the_seeded_weights(fake_world, ref):
    cfg = tgpt2.GPT2Config.tiny()
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"dp": 2, "fsdp": 2, "tp": 2}),
                            device_type="cpu")
    state = tgpt2.init_sharded(cfg, mesh, seed=0)
    ref = tgpt2.GPT2(cfg, device="cpu", seed=0)
    shardings = tgpt2.mesh_shardings_for(ref, mesh)
    for name, p in ref.named_parameters():
        assert tuple(state[name].placements) == shardings[name], name
        assert state[name].shape == p.shape


def test_validate_tp_accepts_and_refuses_as_reference(ref):
    """tests/test_shardgroup.py's case: 4 heads / 2 kv heads / 352 / 512."""
    for validate, cfg in (
            (tllama.validate_tp, tllama.LlamaConfig.tiny()),
            (ref.llama.validate_tp, ref.llama.LlamaConfig.tiny())):
        validate(cfg, 2)
        with pytest.raises(ValueError):
            validate(cfg, 8)         # kv heads (2) don't split 8 ways


def test_initialize_distributed_alone_forms_no_group():
    ctx = tdist.initialize_distributed()
    try:
        assert ctx.initialized and ctx.is_coordinator
        assert ctx.backend is None and not dist.is_initialized()
        assert tdist.distributed_context() is ctx
        assert tdist.process_count() == 1 and tdist.process_index() == 0
        assert tdist.initialize_distributed() is ctx
        with pytest.raises(RuntimeError, match="differently"):
            tdist.initialize_distributed("127.0.0.1:1", 2, 1, device="cpu")
    finally:
        tdist.shutdown_distributed()
    assert tdist.distributed_context() is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdist.initialize_distributed("127.0.0.1:1", 1, 0)
    tdist.shutdown_distributed()


def _matmul_rank(rank, x, w):
    """One of 2 gloo ranks: x @ w with x over dp, and with w's columns over
    tp, each gathered whole."""
    assert tdist.process_count() == 2 and tdist.process_index() == rank
    assert tdist.distributed_context().backend == "gloo"
    results = []
    for axes, x_axes, w_axes in (({"dp": 2}, ("batch", None), None),
                                 ({"tp": 2}, None, ("embed", "mlp"))):
        mesh = tmesh.build_mesh(tmesh.MeshSpec(axes), device_type="cpu")
        p = tsharding.shard_params(
            {"x": torch.from_numpy(x), "w": torch.from_numpy(w)}, mesh,
            {"x": x_axes, "w": w_axes})
        results.append((p["x"] @ p["w"]).full_tensor().numpy())
    return results


@pytest.fixture(scope="module", autouse=True)
def pair():
    """2 spawned gloo ranks (`GlooRanks` of the ring attention tests),
    started with the module's first test so that they are up by the
    last."""
    ranks = GlooRanks(2)
    yield ranks
    ranks.close()


def test_sharded_matmul_matches_single_device(ref, pair):
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16) / 64
    w = np.random.default_rng(0).standard_normal((16, 32), np.float32)
    jm = ref.mesh.build_mesh(ref.mesh.MeshSpec({"dp": 2, "tp": 4}))
    want = np.asarray(ref.jax.jit(lambda a, b: a @ b)(
        ref.jax.device_put(x, ref.sharding.named_sharding(jm, "batch", None)),
        ref.jax.device_put(w, ref.sharding.named_sharding(jm, "embed",
                                                          "mlp"))))
    np.testing.assert_allclose(want, x @ w, rtol=1e-5, atol=1e-5)
    for results in pair.run(_matmul_rank, x, w):
        for result in results:
            np.testing.assert_allclose(result, want, rtol=1e-5, atol=1e-5)
