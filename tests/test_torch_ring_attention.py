"""The port's ring attention (`ray_tpu_torch.ops.ring_attention`) and the
models' sequence-parallel paths against the JAX package's, on the CPU.

Inputs are drawn from numpy seeds. The JAX side runs `ring_attention_sharded`
(and the models) on the 8 virtual CPU devices that conftest sets; the port
side runs in 4 spawned processes, the ranks of one gloo group, which the
module's `ranks` fixture starts once and every test reuses. Each rank gets
the same global inputs, as every device of the reference's global arrays
does, and returns what it computed: every rank must hold the whole output
and the whole gradients. On the CPU the ring's chunks run the flash
kernels' plain versions. The JAX side is imported by the `ref` fixture,
not at the top: the ranks import this file, and start in half the time
without JAX.

Tolerances: both rings compute in float32 and differ in summation order
(the reference's running max/sum against the port's logsumexp merge, over
rows of 32-128 keys): 1e-5 (atol and rtol) on outputs and gradients; the
Llama parity keeps the reference's own test's atol 5e-6, rtol 1e-5 on the
logits, and holds its sp gradients (up to ~200 for sum(logits^2)) to the
same model's without the mesh within 1e-5 of each tensor's largest value
(float32 noise measured there: 2e-7 to 8e-7 of it).
"""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops.ring_attention import (ring_attention,
                                              ring_attention_sharded,
                                              ring_backward_step,
                                              ring_forward_step)
from ray_tpu_torch.parallel import mesh as tmesh

from gloo_ranks import GlooRanks

TOL = dict(atol=1e-5, rtol=1e-5)
LLAMA_TOL = dict(atol=5e-6, rtol=1e-5)   # tests/test_train_pipeline.py:303


@pytest.fixture(scope="module")
def ranks():
    pool = GlooRanks(4)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def ref():
    """The JAX package's side, on the CPU (conftest pins the platform)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2, llama
    from ray_tpu.ops.ring_attention import ring_attention_sharded
    from ray_tpu.parallel import mesh

    return types.SimpleNamespace(jax=jax, jnp=jnp, fnn=fnn, gpt2=gpt2,
                                 llama=llama, mesh=mesh,
                                 ring_attention_sharded=ring_attention_sharded)


def _qkvw(seed, b, h, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d), dtype=np.float32)
            for _ in range(4)]


def _ring_rank(rank, axes, causal, q, k, v, w):
    """sum(ring_attention_sharded(q, k, v) * w) and its gradients."""
    mesh = tmesh.build_mesh(tmesh.MeshSpec(axes), device_type="cpu")
    x = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ring_attention_sharded(*x, mesh, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    return [out.detach().numpy()] + [t.grad.numpy() for t in x]


@pytest.mark.parametrize("axes,causal,b,s", [
    ({"dp": 2, "sp": 2}, True, 4, 128),
    ({"sp": 4}, True, 2, 128),
    ({"sp": 4}, False, 2, 128)], ids=["dp2-sp2", "sp4", "sp4-noncausal"])
def test_ring_matches_reference_outputs_and_gradients(ranks, ref, axes,
                                                      causal, b, s):
    """tests/test_ops.py:91-131's cases (dp 2 x sp 4 there, 8 devices):
    the outputs and the gradients of sum(out * w), on every rank."""
    q, k, v, w = _qkvw(3, b, 2, s, 32)
    jmesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(axes),
                                devices=ref.jax.devices()[:4])

    def loss(q, k, v):
        out = ref.ring_attention_sharded(q, k, v, jmesh, causal=causal)
        return ref.jnp.sum(out * w), out

    (_, want_out), want_grads = ref.jax.jit(ref.jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    want = [want_out] + list(want_grads)
    for got in ranks.run(_ring_rank, axes, causal, q, k, v, w):
        for name, g, x in zip(("out", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, np.asarray(x), err_msg=name, **TOL)


def _sp1_rank(rank, q, k, v, w):
    """At sp 1 (or no sp axis) the sharded ring is flash_attention, and a
    ring of one rank computes what flash_attention does: outputs and
    gradients bit-equal. Each call returns the failures it saw."""
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"dp": 4, "sp": 1}),
                            device_type="cpu")
    no_sp = tmesh.build_mesh(tmesh.MeshSpec({"dp": 4}), device_type="cpu")
    one = mesh.get_group("sp")

    def run(fn):
        x = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fn(*x)
        (out * torch.from_numpy(w)).sum().backward()
        return [out.detach()] + [t.grad for t in x]

    want = run(lambda *x: tattn.flash_attention(*x, True))
    bad = []
    for name, fn in (
            ("sp 1", lambda *x: ring_attention_sharded(*x, mesh)),
            ("no sp", lambda *x: ring_attention_sharded(*x, no_sp)),
            ("ring of one", lambda *x: ring_attention(*x, group=one))):
        if not all(torch.equal(g, t) for g, t in zip(run(fn), want)):
            bad.append(name)
    return dist.get_world_size(one), bad


def test_sp1_is_flash_attention_bit_equal(ranks):
    q, k, v, w = _qkvw(4, 2, 2, 64, 32)
    for size, bad in ranks.run(_sp1_rank, q, k, v, w):
        assert size == 1 and bad == []


def _indivisible_rank(rank):
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"dp": 2, "sp": 2}),
                            device_type="cpu")
    errors = []
    for b, s in ((3, 64), (2, 63)):
        x = torch.zeros(b, 2, s, 32)
        try:
            ring_attention_sharded(x, x, x, mesh)
        except ValueError as e:
            errors.append(str(e))
    return errors


def test_ring_refuses_shapes_the_mesh_cannot_split(ranks):
    for errors in ranks.run(_indivisible_rank):
        assert len(errors) == 2
        assert "dp*fsdp=2" in errors[0] and "sp=2" in errors[1]


def lockstep_ring(q, k, v, do, sp: int, causal: bool, scale: float):
    """All `sp` ranks of a ring stepped in lockstep in this process, each
    handed at step i the chunk it would receive there, (my - i) mod sp, and
    the traveling dK/dV of that chunk, in the order the ring adds to them.
    q, k, v, do: whole [bh, seq, d]. Returns (out, lse, dq, dk, dv), whole,
    each in its input's type (lse float32)."""
    c = q.shape[1] // sp
    qs, ks, vs, dos = ([x.contiguous() for x in t.split(c, dim=1)]
                       for t in (q, k, v, do))
    states = [None] * sp
    for i in range(sp):
        for my in range(sp):
            src = (my - i) % sp
            states[my] = ring_forward_step(states[my], qs[my], ks[src],
                                           vs[src], my * c, src * c, causal,
                                           scale)
    outs = [st[0].to(q.dtype) for st in states]
    grads = [[torch.zeros(qs[0].shape, dtype=torch.float32, device=q.device)
              for _ in range(sp)] for _ in range(3)]
    dq, dk, dv = grads
    for i in range(sp):
        for my in range(sp):
            src = (my - i) % sp
            dq_c, dk[src], dv[src] = ring_backward_step(
                dk[src], dv[src], qs[my], ks[src], vs[src], dos[my], outs[my],
                states[my][1], my * c, src * c, causal, scale)
            if dq_c is not None:
                dq[my] += dq_c
    return (torch.cat(outs, dim=1), torch.cat([st[1] for st in states], 1),
            *(torch.cat(g, dim=1).to(q.dtype) for g in grads))


def test_step_functions_stepped_in_one_process_equal_mha_reference(
        monkeypatch):
    """The 4 ranks of an sp 4 ring stepped in lockstep equal the plain
    attention over the whole sequence, outputs and gradients; causal runs
    the kernel on 10 chunks (4 causal, 6 full), non-causal on 16."""
    sp, bh, s, d = 4, 4, 128, 32
    calls = []
    fwd = tattn._flash_forward
    monkeypatch.setattr(tattn, "_flash_forward", lambda q, k, v, causal,
                        scale: calls.append(causal) or fwd(q, k, v, causal,
                                                           scale))
    for causal in (True, False):
        calls.clear()
        q, k, v, w = (torch.from_numpy(a)[0] for a in _qkvw(5, 1, bh, s, d))
        out, _, *grads = lockstep_ring(q, k, v, w, sp, causal, d ** -0.5)
        assert calls.count(True) == (sp if causal else 0)
        assert len(calls) == (sp * (sp + 1) // 2 if causal else sp * sp)
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        want = tattn.mha_reference(*(t[None] for t in x), causal=causal)[0]
        (want * w).sum().backward()
        torch.testing.assert_close(out, want.detach(), **TOL)
        for got, t in zip(grads, x):
            torch.testing.assert_close(got, t.grad, **TOL)


def _float32(cfg):
    import dataclasses

    return dataclasses.replace(cfg, dtype=torch.float32)


def _llama_rank(rank, state, ids):
    """Llama tiny (float32) with sp_mesh on a ("sp" 2, "tp" 2) mesh: each
    sp ring spans 2 ranks, tp holds duplicates. The logits, and the
    gradients of their sum against the same model without the mesh."""
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"sp": 2, "tp": 2}),
                            device_type="cpu")
    import dataclasses

    cfg = _float32(tllama.LlamaConfig.tiny())
    ids = torch.from_numpy(ids)
    out = []
    for sp_mesh in (mesh, None):
        model = tllama.Llama(dataclasses.replace(cfg, sp_mesh=sp_mesh),
                             device="cpu",
                             state={n: t.clone() for n, t in state.items()})
        logits = model(ids)
        (logits * logits).sum().backward()
        out.append((logits.detach().numpy(),
                    {n: p.grad.numpy() for n, p in model.named_parameters()}))
    return out


def test_llama_sp_matches_reference(ranks, ref):
    """The reference's test_llama_sp_ring_attention_parity
    (tests/test_train_pipeline.py:281-305) on LlamaConfig.tiny in float32
    (head dim 32, a width the kernels take): the port's sp logits against
    the reference's sp logits, on every rank; the sp gradients equal the
    port's without the mesh, so every rank holds the whole gradient."""
    import dataclasses

    cfg = dataclasses.replace(ref.llama.LlamaConfig.tiny(),
                              dtype=ref.jnp.float32)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16),
                                            dtype=np.int32)
    model = ref.llama.Llama(cfg)
    params = ref.jax.jit(model.init)(ref.jax.random.PRNGKey(0), ids)["params"]
    mesh = ref.mesh.build_mesh(ref.mesh.MeshSpec({"sp": 2}),
                               devices=ref.jax.devices()[:2])
    sp_model = ref.llama.Llama(dataclasses.replace(cfg, sp_mesh=mesh))
    want = np.asarray(ref.jax.jit(
        lambda p, x: sp_model.apply({"params": p}, x))(params, ids))
    np.testing.assert_allclose(want, np.asarray(ref.jax.jit(
        lambda p, x: model.apply({"params": p}, x))(params, ids)), **LLAMA_TOL)
    state = tllama.params_from_jax(
        ref.jax.tree.map(np.asarray, ref.fnn.meta.unbox(params)))
    for (sp_logits, sp_grads), (logits, grads) in ranks.run(
            _llama_rank, state, ids):
        np.testing.assert_allclose(sp_logits, want, **LLAMA_TOL)
        np.testing.assert_allclose(logits, want, **LLAMA_TOL)
        for name, g in grads.items():
            np.testing.assert_allclose(sp_grads[name], g, err_msg=name,
                                       atol=1e-5 * np.abs(g).max(), rtol=0)


def _gpt2_rank(rank, state, ids):
    """GPT-2 tiny (float32, use_ring) on this rank's sequence shard of the
    ids, over the sp group of a ("sp" 2, "tp" 2) mesh."""
    mesh = tmesh.build_mesh(tmesh.MeshSpec({"sp": 2, "tp": 2}),
                            device_type="cpu")
    import dataclasses

    cfg = dataclasses.replace(_float32(tgpt2.GPT2Config.tiny(seq=32)),
                              use_ring=True)
    model = tgpt2.GPT2(cfg, device="cpu", sp_group=mesh.get_group("sp"))
    model.load_state_dict(state)
    sp, i = 2, mesh.get_coordinate()[mesh.mesh_dim_names.index("sp")]
    shard = ids.shape[1] // sp
    with torch.no_grad():
        logits = model(torch.from_numpy(ids[:, i * shard:(i + 1) * shard]))
    return i, logits.numpy()


def test_gpt2_use_ring_matches_reference_under_shard_map(ranks, ref):
    """GPT-2 tiny with use_ring at sp 2, each rank on its sequence shard,
    against the reference's under `shard_map` (ids and logits split over
    sp). Positions restart at 0 on every shard in both: `wpe[None, :s]`
    takes the shard's length (a reference behaviour the port keeps)."""
    import dataclasses

    from jax.sharding import PartitionSpec as P

    cfg = dataclasses.replace(ref.gpt2.GPT2Config.tiny(seq=32),
                              dtype=ref.jnp.float32)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32),
                                            dtype=np.int32)
    params = ref.jax.jit(ref.gpt2.GPT2(cfg).init)(ref.jax.random.PRNGKey(0),
                                                  ids)
    ring_model = ref.gpt2.GPT2(dataclasses.replace(cfg, use_ring=True))
    mesh = ref.mesh.build_mesh(ref.mesh.MeshSpec({"sp": 2}),
                               devices=ref.jax.devices()[:2])
    fn = ref.jax.shard_map(lambda p, x: ring_model.apply(p, x), mesh=mesh,
                           in_specs=(P(), P(None, "sp")),
                           out_specs=P(None, "sp"), check_vma=False)
    want = np.asarray(ref.jax.jit(fn)(params, ids))
    state = tgpt2.params_from_jax(
        ref.jax.tree.map(np.asarray, ref.fnn.meta.unbox(params)))
    shard = ids.shape[1] // 2
    for i, logits in ranks.run(_gpt2_rank, state, ids):
        np.testing.assert_allclose(
            logits, want[:, i * shard:(i + 1) * shard], **TOL)
