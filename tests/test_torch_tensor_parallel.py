"""The port's tensor, data and fully-sharded parallelism against the JAX
package's mesh step, on the CPU.

The reference steps GPT-2 on a mesh through GSPMD (`make_train_step(
mesh=)`, its logical constraints resolved by the rules); the port steps
the same model in 4 spawned gloo ranks (`tests/gloo_ranks.py`), one rank a
device, its parameters DTensors (`GPT2(mesh=)`): tp Megatron-style with a
vocab-parallel head and loss, FSDP2 over fsdp, the ring over sp with
global positions. The JAX side runs on 4 of conftest's 8 virtual CPU
devices with its attention as its own mesh tests run it, both sides in
float32, from one numpy-seeded batch and `params_from_jax` weights.

Limits: the loss within 1e-5 relative (float32 summation order); after
one AdamW step (lr 3e-4) each parameter within 1e-5 absolute, 3% of a
step, as tests/test_torch_gpt2.py holds the single-device step (where a
gradient is zero in exact arithmetic, the key bias, its rounding noise
becomes part of the step: ROADMAP queue 3, "AdamW's first step"). JAX is
imported only inside fixtures: the ranks import this file.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel.sharding import shard_batch
from ray_tpu_torch.parallel.tensor_parallel import (MeshContext, full_state,
                                                    next_token_loss_parts,
                                                    sync_gradients)
from gloo_ranks import GlooRanks

BATCH, SEQ = 4, 32
LR = 3e-4
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
MESHES = {"dp2_tp2": {"dp": 2, "tp": 2}, "fsdp2_tp2": {"fsdp": 2, "tp": 2},
          "sp2_tp2": {"sp": 2, "tp": 2}}


@pytest.fixture(scope="module", autouse=True)
def ranks():
    pool = GlooRanks(4, timeout_s=120, preload=__name__)
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

    from ray_tpu.models import gpt2, llama
    from ray_tpu.parallel import mesh, sharding

    return types.SimpleNamespace(jax=jax, jnp=jnp, fnn=fnn, optax=optax,
                                 traverse_util=traverse_util, gpt2=gpt2,
                                 llama=llama, mesh=mesh, sharding=sharding)


def _gpt2_config():
    return dataclasses.replace(tgpt2.GPT2Config.tiny(seq=SEQ),
                               dtype=torch.float32)


def _batch(seed, ignore_first_half=False):
    ids = np.random.default_rng(seed).integers(0, 512, (BATCH, SEQ),
                                               dtype=np.int32)
    labels = ids.copy()
    if ignore_first_half:
        # Every ignored label in dp shard 0: its mean and shard 1's differ
        # in weight from the global mean.
        labels[:BATCH // 2, SEQ // 4:] = -100
    return ids, labels


def _jax_mesh_step(ref, axes, ids, labels):
    """The reference's `make_train_step(mesh=)` on a mesh of 4 virtual
    devices: (initial params, params after one AdamW step, loss), numpy."""
    jax, jnp = ref.jax, ref.jnp
    cfg = dataclasses.replace(ref.gpt2.GPT2Config.tiny(seq=SEQ),
                              dtype=jnp.float32)
    model = ref.gpt2.GPT2(cfg)
    mesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(axes),
                               devices=jax.devices()[:4])
    params = ref.gpt2.init_sharded(model, mesh, (BATCH, SEQ), seed=0)
    opt = ref.optax.adamw(LR, weight_decay=0.1)
    sharding = ref.sharding.named_sharding(mesh, "batch", "seq")
    batch = {"input_ids": jax.device_put(jnp.asarray(ids), sharding),
             "labels": jax.device_put(jnp.asarray(labels), sharding)}
    step = ref.gpt2.make_train_step(model, opt, mesh=mesh, donate=False)
    new, _, loss = step(params, jax.jit(opt.init)(params), batch)

    def host(p):
        return tgpt2.params_from_jax(
            jax.tree.map(np.asarray, ref.fnn.meta.unbox(p)))

    return host(params), host(new), float(loss)


def _gpt2_mesh_step(rank, axes, state, ids, labels):
    """One AdamW step of `GPT2(mesh=)` on this rank's shard: (global loss,
    the parameters after it, whole)."""
    mesh = tmesh.build_mesh(tmesh.MeshSpec(axes), device_type="cpu")
    model = tgpt2.GPT2(_gpt2_config(), mesh=mesh, state=state)
    step = tgpt2.make_train_step(model, tgpt2.adamw(model, lr=LR),
                                 mesh=mesh)
    batch = shard_batch({"input_ids": torch.from_numpy(ids).long(),
                         "labels": torch.from_numpy(labels).long()}, mesh)
    loss = step(batch).item()
    return loss, full_state(model)


def _check_step(got, jloss, jnew):
    for loss, params in got:
        assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
        assert params.keys() == jnew.keys()
        for name, want in jnew.items():
            np.testing.assert_allclose(params[name].numpy(), want.numpy(),
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_gpt2_mesh_step_matches_reference(ranks, ref, name):
    """One AdamW step at dp 2 x tp 2, fsdp 2 x tp 2 and sp 2 x tp 2: the
    global loss and every updated parameter (after `full_tensor()`)
    against the reference's GSPMD step on the same mesh."""
    axes = MESHES[name]
    ids, labels = _batch(3)
    init, jnew, jloss = _jax_mesh_step(ref, axes, ids, labels)
    got = ranks.run(_gpt2_mesh_step, axes, init, ids, labels)
    _check_step(got, jloss, jnew)


def test_global_loss_with_ignored_labels_in_one_dp_shard(ranks, ref):
    """sum(nll * mask) / sum(mask) over the GLOBAL batch at dp 2 x tp 2,
    every ignore_index label in dp shard 0: the numerator and denominator
    are reduced apart, so the loss and step are the reference's, not the
    mean of the two shards' means (which differs here)."""
    axes = MESHES["dp2_tp2"]
    ids, labels = _batch(4, ignore_first_half=True)
    init, jnew, jloss = _jax_mesh_step(ref, axes, ids, labels)
    got = ranks.run(_gpt2_mesh_step, axes, init, ids, labels)
    _check_step(got, jloss, jnew)
    model = tgpt2.GPT2(_gpt2_config(), device="cpu", state=init)
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long())
    half = BATCH // 2
    labels_t = torch.from_numpy(labels).long()
    means = [tgpt2.next_token_loss(logits[s], labels_t[s]).item()
             for s in (slice(0, half), slice(half, BATCH))]
    assert abs(np.mean(means) - jloss) > 100 * LOSS_RTOL * abs(jloss)


# --------------------------------------------------------------------------- #
# Llama: tp execution against the reference's shard_params_tp model
# --------------------------------------------------------------------------- #


def _llama_config():
    return dataclasses.replace(tllama.LlamaConfig.tiny(seq=SEQ),
                               dtype=torch.float32)


def _llama_tp_rank(rank, state, ids):
    """Llama tiny at dp 2 x tp 2 (2 query and 1 KV head a rank): this
    rank's logits [its rows, its vocab shard] and the global loss's
    gradients, whole."""
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"dp": 2, "tp": 2}),
                            device_type="cpu")
    model = tllama.Llama(_llama_config(), mesh=mesh, state=state)
    ctx = model.mesh_ctx
    heads = model.layers[0].wq.weight.to_local().shape[0] // \
        _llama_config().head_dim
    batch = shard_batch({"input_ids": torch.from_numpy(ids).long()}, mesh)
    logits = model(batch["input_ids"])
    objective, shown = next_token_loss_parts(logits, batch["input_ids"], ctx)
    objective.backward()
    sync_gradients(model.parameters(), ctx)
    grads = {n: p.grad.full_tensor() for n, p in model.named_parameters()}
    return (logits.detach(), shown.item(), grads, heads,
            tmesh.data_parallel_rank(mesh), ctx.tp_rank)


def test_llama_tp2_forward_and_gradients_match_reference(ranks, ref):
    """The port's tp execution of Llama (wq/wk/wv/gate/up column-parallel,
    wo/w_down row-parallel, vocab-parallel embed and head, GQA's 4/2 heads
    as 2/1 a rank) against the reference's model on its
    `shard_params_tp` placement over a tp 2 mesh: logits, loss and every
    gradient, float32, within 1e-5 (atol and rtol)."""
    jax, jnp = ref.jax, ref.jnp
    jcfg = dataclasses.replace(ref.llama.LlamaConfig.tiny(seq=SEQ),
                               dtype=jnp.float32)
    model = ref.llama.Llama(jcfg)
    ids = _batch(5)[0]
    params = jax.jit(lambda: model.init(jax.random.PRNGKey(0),
                                        jnp.asarray(ids)))()
    mesh = ref.mesh.build_mesh(ref.mesh.MeshSpec({"tp": 2}),
                               devices=jax.devices()[:2])
    sharded = ref.llama.shard_params_tp(model, params, mesh)

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(ids))
        return ref.gpt2.next_token_loss(logits, jnp.asarray(ids)), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(sharded)
    jlogits = np.asarray(jlogits)
    state = tllama.params_from_jax(
        jax.tree.map(np.asarray, ref.fnn.meta.unbox(params)))
    want_grads = tllama.params_from_jax(
        jax.tree.map(np.asarray, ref.fnn.meta.unbox(jgrads)))
    tol = dict(atol=1e-5, rtol=1e-5)
    vocab = jcfg.vocab_size // 2
    for logits, loss, grads, heads, dp, tp in ranks.run(_llama_tp_rank,
                                                        state, ids):
        assert heads == 2
        rows = slice(dp * BATCH // 2, (dp + 1) * BATCH // 2)
        cols = slice(tp * vocab, (tp + 1) * vocab)
        np.testing.assert_allclose(logits.numpy(), jlogits[rows, :, cols],
                                   **tol)
        np.testing.assert_allclose(loss, float(jloss), **tol)
        assert grads.keys() == want_grads.keys()
        for name, want in want_grads.items():
            np.testing.assert_allclose(grads[name].numpy(), want.numpy(),
                                       err_msg=name, **tol)


def _llama_tp_step_rank(rank, state, ids, axes):
    """One AdamW step of Llama tiny on `axes`: (loss, whole gradients)."""
    mesh = tmesh.build_mesh(tmesh.MeshSpec(axes), device_type="cpu")
    model = tllama.Llama(_llama_config(), mesh=mesh, state=state)
    step = tgpt2.make_train_step(model, tgpt2.adamw(model, lr=LR),
                                 mesh=mesh)
    t = torch.from_numpy(ids).long()
    loss = step(shard_batch({"input_ids": t, "labels": t}, mesh)).item()
    return loss, {n: p.grad.full_tensor()
                  for n, p in model.named_parameters()}


@pytest.mark.parametrize("axes", [{"dp": 2, "tp": 2}, {"sp": 2, "tp": 2},
                                  {"fsdp": 2, "tp": 2}])
def test_llama_mesh_step_matches_one_device(ranks, axes):
    """Llama's step on a mesh (dp, sp and fsdp each with tp) against the
    same step on one device (the port's own, which
    tests/test_torch_training.py holds to the reference's): the global
    loss and the gradients the step descended, after the mesh's
    reductions, within 1e-5 (atol and rtol). Gradients, not the updated
    weights: AdamW's first step turns their rounding noise into part of
    the step where one is near zero (ROADMAP queue 3), which the
    reference tests above bound for GPT-2."""
    cfg = _llama_config()
    ids = _batch(6)[0]
    model = tllama.Llama(cfg, device="cpu", seed=0)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = tgpt2.make_train_step(model, tgpt2.adamw(model, lr=LR))
    t = torch.from_numpy(ids).long()
    want = step({"input_ids": t, "labels": t}).item()
    for loss, grads in ranks.run(_llama_tp_step_rank, state, ids, axes):
        assert abs(loss - want) <= LOSS_RTOL * abs(want)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(grads[name].numpy(), p.grad.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


# --------------------------------------------------------------------------- #
# Widths, shardings and shards of the batch
# --------------------------------------------------------------------------- #


@pytest.fixture
def fake_world():
    """8 ranks of a fake process group in this process: placements need no
    peers."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def test_validate_tp_refuses_as_reference(ref):
    # tests/test_shardgroup.py::test_llama_tp_validation
    cfg = tllama.LlamaConfig.tiny()
    jcfg = ref.llama.LlamaConfig.tiny()
    for fn, c in ((tllama.validate_tp, cfg), (ref.llama.validate_tp, jcfg)):
        fn(c, 2)                      # 4 heads / 2 kv heads / 352 / 512
        with pytest.raises(ValueError):
            fn(c, 8)                  # kv heads (2) don't split 8 ways
    with pytest.raises(ValueError, match="n_kv_head"):
        tllama.validate_tp(cfg, 4)


def _entries(spec, ndim):
    out = []
    for i in range(ndim):
        e = spec[i] if i < len(spec) else None
        if isinstance(e, (tuple, list)):
            e = tuple(e) if len(e) > 1 else (e[0] if e else None)
        out.append(e)
    return tuple(out)


def _read_back(placements, names, ndim):
    dims = [[] for _ in range(ndim)]
    for name, pl in zip(names, placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
    return tuple(None if not d else (d[0] if len(d) == 1 else tuple(d))
                 for d in dims)


@pytest.mark.parametrize("axes", [{"tp": 2}, {"dp": 2, "fsdp": 2, "tp": 2}])
def test_llama_tp_shardings_match_reference(fake_world, ref, axes):
    """`tp_shardings` on the port's names against the reference's on the
    flax tree (tests/test_shardgroup.py and test_llama.py's meshes): each
    parameter split on the same dims over the same axes (a flax kernel
    [in, out] is the port's weight transposed)."""
    jax, jnp = ref.jax, ref.jnp
    cfg = tllama.LlamaConfig.tiny()
    model = tllama.Llama(cfg, device="cpu")
    n = int(np.prod(list(axes.values())))
    mesh = tmesh.build_mesh(tmesh.MeshSpec(axes), devices=range(n),
                            device_type="cpu")
    jmesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(axes),
                                devices=jax.devices()[:n])
    jmodel = ref.llama.Llama(ref.llama.LlamaConfig.tiny())
    jshard = ref.llama.tp_shardings(jmodel, jmesh)
    flat = ref.traverse_util.flatten_dict(
        ref.fnn.meta.unbox(jshard)["params"], sep="/")
    got = tllama.tp_shardings(model, mesh)
    assert len(got) == len(flat)
    for name, p in model.named_parameters():
        parts = name.split(".")
        if name == "embed":
            key, flip = "embed", False
        elif parts[0] == "layers":
            leaf = "scale" if parts[2].endswith("norm") else "kernel"
            key, flip = f"layer_{parts[1]}/{parts[2]}/{leaf}", leaf == "kernel"
        else:
            leaf = "scale" if parts[0].endswith("norm") else "kernel"
            key, flip = f"{parts[0]}/{leaf}", leaf == "kernel"
        want = _entries(flat[key].spec, p.dim())
        if flip:
            want = want[::-1]
        _, placements = got[name]
        assert _read_back(placements, mesh.mesh_dim_names, p.dim()) == want, \
            name
    placed = tllama.shard_params_tp(model, model.state_dict(), mesh)
    assert placed["embed"].to_local().shape[0] == cfg.vocab_size // 2


def test_shard_batch_and_data_parallel_coords(fake_world):
    """`shard_batch` gives rank 0 its rows (dp, then fsdp) and sequence
    shard (sp) of a global batch; `data_parallel_coords` names, without a
    group, the shard each rank of a mesh reads, tp and sp peers alike."""
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"dp": 2, "fsdp": 2, "sp": 2}),
                            device_type="cpu")
    x = np.arange(8 * 6).reshape(8, 6)
    got = shard_batch({"ids": x}, mesh)["ids"]
    np.testing.assert_array_equal(got, x[:2, :3])
    assert tmesh.data_parallel_size(mesh) == 4
    assert tmesh.data_parallel_rank(mesh) == 0
    coords = tmesh.data_parallel_coords(
        tmesh.MeshSpec({"dp": 2, "tp": 2}), 4)
    assert coords == [(0, 2), (0, 2), (1, 2), (1, 2)]
    coords = tmesh.data_parallel_coords(
        tmesh.MeshSpec({"dp": 2, "fsdp": 2, "sp": 2}), 8)
    assert [c for c, _ in coords] == [0, 0, 1, 1, 2, 2, 3, 3]
    with pytest.raises(ValueError, match="split"):
        shard_batch(np.zeros((3, 6)), mesh)
    with pytest.raises(ValueError, match="n_head"):
        tmesh.validate_divisibility(
            tmesh.build_mesh(tmesh.MeshSpec({"tp": 8}), device_type="cpu"),
            8, n_head=12)


def _mesh_context_rank(rank):
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"dp": 2, "tp": 2}),
                            device_type="cpu")
    ctx = MeshContext.of(mesh)
    return (ctx.tp_size, ctx.tp_rank, len(ctx.loss_groups),
            len(ctx.grad_groups), ctx.fsdp)


def test_mesh_context_groups(ranks):
    """A rank's tp line and the groups its losses and gradients sum over:
    dp 2 x tp 2 sums both over dp, tp ranks in order."""
    got = ranks.run(_mesh_context_rank)
    assert [(tp, r) for tp, r, *_ in got] == [(2, 0), (2, 1), (2, 0), (2, 1)]
    assert all(g[2:] == (1, 1, False) for g in got)
