"""The PyTorch port's Llama against the JAX package's, on the CPU.

One flax parameter tree, made from a seed (norm scales then moved off their
init of ones, so the scale path is checked too), is unboxed to numpy and
carried into the port through `params_from_jax`. The JAX model runs its
Pallas flash kernels in interpret mode where it takes them (head dim a
multiple of 64; at 32 it answers with its plain attention), the port its
kernels' plain versions. Tolerances: float32 differs only in summation
order over widths up to 256, 1e-4 on logits; bf16 compute rounds at other
places in the two frameworks (8 significant bits): 2e-2.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama

F32 = dict(atol=1e-4, rtol=1e-4)


def _within(got, want, tol) -> bool:
    """|got - want| <= tol * (typical + |want|), element by element, where
    typical is the rms of the element's row (and at least a tenth of the
    tensor's)."""
    g = torch.tensor(np.asarray(got, np.float32))
    w = torch.tensor(np.asarray(want, np.float32))
    typical = torch.maximum(w.square().mean(dim=-1, keepdim=True).sqrt(),
                            w.square().mean().sqrt() / 10)
    return bool(((g - w).abs() <= tol * (typical + w.abs())).all())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # Tiny shapes: one intra-op thread each, so parallel test workers do
    # not oversubscribe the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")


def _configs(head_dim=32, dtype="float32", **kw):
    common = dict(vocab_size=256, n_positions=64, n_embd=4 * head_dim,
                  n_layer=2, n_head=4, n_kv_head=2, intermediate=192)
    common.update(kw)
    return (jllama.LlamaConfig(dtype=getattr(jnp, dtype), **common),
            tllama.LlamaConfig(dtype=getattr(torch, dtype), **common))


def _apply(jmodel, method=None):
    """The JAX model's apply, jitted (its eager dispatch is slow)."""
    return jax.jit(functools.partial(jmodel.apply, method=method))


def _carry(jcfg, tcfg, seed=0):
    jmodel = jllama.Llama(jcfg)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(seed),
                                         jnp.zeros((1, 8), jnp.int32)))()
    params_np = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    rng = np.random.default_rng(seed)

    def perturb(tree):
        return {k: (perturb(v) if isinstance(v, dict) else
                    (1 + 0.1 * rng.standard_normal(v.shape)).astype(
                        np.float32) if k == "scale" else v)
                for k, v in tree.items()}

    params_np = perturb(params_np)
    tmodel = tllama.Llama(tcfg, device="cpu",
                          state=tllama.params_from_jax(params_np))
    return jmodel, jax.tree.map(jnp.asarray, params_np), tmodel


def _ids(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _np(t):
    return t.detach().float().numpy()


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 6, 32)).astype(np.float32)
    pos2 = rng.integers(0, 100, (2, 6)).astype(np.int32)
    for pos in (np.arange(3, 9, dtype=np.int32), pos2):
        want = jax.jit(jllama.apply_rope, static_argnums=2)(
            jnp.asarray(x), jnp.asarray(pos), 10000.0)
        got = tllama.apply_rope(torch.from_numpy(x),
                                torch.from_numpy(pos).long(), 10000.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5),
                          (jnp.bfloat16, torch.bfloat16, 2e-2)):
        jcfg = jllama.LlamaConfig(dtype=jdt)
        want = jax.jit(jllama.RMSNorm(jcfg).apply)(
            {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
        norm = tllama.RMSNorm(32, 1e-5, tdt)
        norm.weight.data = torch.from_numpy(scale)
        got = norm(torch.from_numpy(x))
        assert got.dtype == tdt
        assert _within(_np(got), np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("head_dim", [32, 64])
def test_forward_matches_jax_with_flash_and_gqa(interpret, head_dim):
    jcfg, tcfg = _configs(head_dim)
    assert tcfg.use_flash and tcfg.n_head // tcfg.n_kv_head == 2
    jmodel, jparams, tmodel = _carry(jcfg, tcfg)
    ids = _ids((2, 64), tcfg.vocab_size)
    want = _apply(jmodel)(jparams, jnp.asarray(ids))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_bf16_forward_close_to_jax():
    jcfg, tcfg = _configs(32, "bfloat16")
    jmodel, jparams, tmodel = _carry(jcfg, tcfg, seed=1)
    ids = _ids((2, 32), tcfg.vocab_size, seed=1)
    want = np.asarray(_apply(jmodel)(jparams, jnp.asarray(ids)), np.float32)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
    assert got.dtype == torch.bfloat16
    # Logits here are within 1 in size, where one bf16 ulp is 2^-8 to 2^-7:
    # the two frameworks round the products and norms of two layers at
    # other places, and differ by one or two ulps of a logit.
    np.testing.assert_allclose(_np(got), want, atol=2e-2, rtol=2e-2)


def test_decode_matches_full_forward():
    # As tests/test_llama.py: prefill in one shot, then token by token, and
    # rows decoding at their own offsets. float32: summation order only.
    _, tcfg = _configs(32, use_flash=False)
    model = tllama.Llama(tcfg, device="cpu", seed=0)
    ids = torch.from_numpy(_ids((2, 10), tcfg.vocab_size)).long()
    with torch.no_grad():
        full = model(ids)
    cache = tllama.make_cache(tcfg, 2, 32, device="cpu")
    pf, cache = model.decode(ids, cache, torch.zeros(2, dtype=torch.long))
    np.testing.assert_allclose(pf.numpy(), full.numpy(), **F32)
    cache = tllama.make_cache(tcfg, 2, 32, device="cpu")
    for t in range(ids.shape[1]):
        lg, cache = model.decode(ids[:, t:t + 1], cache,
                                 torch.full((2,), t))
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   **F32)
    # Per-row offsets: after the shared prefill, row 0 decodes position 4
    # and row 1 position 7 in one call.
    cache = tllama.make_cache(tcfg, 2, 32, device="cpu")
    model.decode(ids, cache, torch.zeros(2, dtype=torch.long))
    lg, _ = model.decode(torch.stack([ids[0, 4:5], ids[1, 7:8]]), cache,
                         torch.tensor([4, 7]))
    np.testing.assert_allclose(lg[0, 0].numpy(), full[0, 4].numpy(), **F32)
    np.testing.assert_allclose(lg[1, 0].numpy(), full[1, 7].numpy(), **F32)


def test_decode_and_decode_paged_match_jax():
    jcfg, tcfg = _configs(32, use_flash=False)
    jmodel, jparams, tmodel = _carry(jcfg, tcfg, seed=2)
    ids = _ids((2, 9), tcfg.vocab_size, seed=2)
    # Dense cache: a 5-token prefill, then single tokens at per-row offsets.
    jcache = jllama.make_cache(jcfg, 2, 16)
    tcache = tllama.make_cache(tcfg, 2, 16, device="cpu")
    steps = [(ids[:, :5], [0, 0])] + [(ids[:, t:t + 1], [t, t])
                                      for t in range(5, 9)]
    decode = _apply(jmodel, jllama.Llama.decode)
    for chunk, pos in steps:
        want, jcache = decode(jparams, jnp.asarray(chunk), jcache,
                              jnp.asarray(pos, jnp.int32))
        got, tcache = tmodel.decode(torch.from_numpy(chunk).long(), tcache,
                                    torch.tensor(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for (jk, jv), (tk, tv) in zip(jcache, tcache):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **F32)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32)
    # Paged arena: shuffled tables, a padded chunk whose masked tail goes
    # to the trash block, then single tokens.
    bt = np.asarray([[3, 1, 6, 0], [7, 2, 5, 0]], np.int32)
    jarena = jllama.make_paged_arena(jcfg, 8, 4)
    tarena = tllama.make_paged_arena(tcfg, 8, 4, device="cpu")
    chunk = np.concatenate([ids[:, :5], np.zeros((2, 3), np.int32)], 1)
    wm = np.zeros((2, 8), bool)
    wm[:, :5] = True
    steps = [(chunk, [0, 0], wm)] + [
        (ids[:, t:t + 1], [t, t], np.ones((2, 1), bool)) for t in range(5, 9)]
    decode_paged = _apply(jmodel, jllama.Llama.decode_paged)
    for toks, pos, mask in steps:
        want, jarena = decode_paged(
            jparams, jnp.asarray(toks), jarena, jnp.asarray(bt),
            jnp.asarray(pos, jnp.int32), jnp.asarray(mask))
        got, tarena = tmodel.decode_paged(
            torch.from_numpy(toks).long(), tarena,
            torch.from_numpy(bt).long(), torch.tensor(pos),
            torch.from_numpy(mask))
        valid = mask.all(0)
        np.testing.assert_allclose(got.numpy()[:, valid],
                                   np.asarray(want)[:, valid], **F32)
    for (jk, jv), (tk, tv) in zip(jarena, tarena):
        # Block 0 took the masked writes in both, in whatever order the
        # duplicates landed: compare the blocks that are read.
        np.testing.assert_allclose(tk[1:].numpy(), np.asarray(jk)[1:], **F32)
        np.testing.assert_allclose(tv[1:].numpy(), np.asarray(jv)[1:], **F32)


def test_paged_matches_dense_with_masks_and_trash_writes():
    # As tests/test_llama.py:159, plus chunked prefill with a masked tail:
    # the pads land in trash block 0 only, blocks in no table stay zero,
    # and the paged logits agree with the dense cache's.
    _, tcfg = _configs(32, use_flash=False)
    model = tllama.Llama(tcfg, device="cpu", seed=3)
    ids = torch.from_numpy(_ids((2, 14), tcfg.vocab_size, seed=3)).long()
    cache = tllama.make_cache(tcfg, 2, 32, device="cpu")
    arena = tllama.make_paged_arena(tcfg, 16, 4, device="cpu")
    bt = torch.tensor([[3, 1, 6, 2, 0, 0, 0, 0],
                       [7, 13, 8, 12, 0, 0, 0, 0]])
    unused = [b for b in range(1, 16) if b not in bt]
    for start in (0, 4, 8):                       # chunks of 4; last padded
        n = min(4, 10 - start)
        toks = torch.zeros(2, 4, dtype=torch.long)
        toks[:, :n] = ids[:, start:start + n]
        wm = torch.zeros(2, 4, dtype=torch.bool)
        wm[:, :n] = True
        pos = torch.full((2,), start)
        lg, arena = model.decode_paged(toks, arena, bt, pos, wm)
        ref, cache = model.decode(ids[:, start:start + n], cache, pos)
        np.testing.assert_allclose(lg[:, :n].numpy(), ref.numpy(), **F32)
    for t in range(10, 14):
        lg, arena = model.decode_paged(ids[:, t:t + 1], arena, bt,
                                       torch.full((2,), t),
                                       torch.ones(2, 1, dtype=torch.bool))
        ref, cache = model.decode(ids[:, t:t + 1], cache, torch.full((2,), t))
        np.testing.assert_allclose(lg.numpy(), ref.numpy(), **F32)
    for k, v in arena:
        assert k[0].abs().sum() > 0 and v[0].abs().sum() > 0   # the pads
        assert not k[unused].any() and not v[unused].any()


def _banks(cfg, n_rows, rank, seeds, module):
    """Per-layer banks [n_rows, ...] with adapter i + 1 in row i + 1."""
    shapes = tllama.lora_bank_shapes(cfg, n_rows, rank)
    banks = [[np.zeros(s, np.float32) for s in shapes]
             for _ in range(cfg.n_layer)]
    for row, seed in enumerate(seeds, start=1):
        for layer, rows in zip(banks, module.make_adapter_weights(
                cfg, rank=rank, seed=seed)):
            for bank, w in zip(layer, rows):
                bank[row] = np.asarray(w, np.float32)
    return banks


def test_lora_side_term_matches_jax_and_leaves_kv_alone():
    jcfg, tcfg = _configs(32, use_flash=False)
    jmodel, jparams, tmodel = _carry(jcfg, tcfg, seed=4)
    jbanks = [tuple(map(jnp.asarray, layer))
              for layer in _banks(jcfg, 3, 4, (11, 22), jllama)]
    tbanks = [tuple(map(torch.from_numpy, layer))
              for layer in _banks(tcfg, 3, 4, (11, 22), tllama)]
    ids = _ids((3, 6), tcfg.vocab_size, seed=4)
    bt = np.asarray([[1, 2], [3, 4], [5, 6]], np.int32)
    aidx = np.asarray([0, 1, 2], np.int32)
    wm = np.ones((3, 6), bool)
    pos = np.zeros(3, np.int32)
    want, _ = _apply(jmodel, jllama.Llama.decode_paged)(
        jparams, jnp.asarray(ids), jllama.make_paged_arena(jcfg, 8, 4),
        jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(wm), jbanks,
        jnp.asarray(aidx))
    args = (torch.from_numpy(ids).long(), None, torch.from_numpy(bt).long(),
            torch.from_numpy(pos).long(), torch.from_numpy(wm))
    arenas = []
    for banks in (tbanks, None):
        arena = tllama.make_paged_arena(tcfg, 8, 4, device="cpu")
        got, _ = tmodel.decode_paged(
            args[0], arena, *args[2:], banks,
            None if banks is None else torch.from_numpy(aidx).long())
        arenas.append(arena)
        if banks is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
            with_lora = got
    # Row 0 routes to the identity row; the adapters steer rows 1 and 2.
    np.testing.assert_array_equal(with_lora[0].numpy(), got[0].numpy())
    assert not torch.allclose(with_lora[1], got[1])
    # The side term never enters the residual stream: K/V bit-identical.
    for (k1, v1), (k2, v2) in zip(*arenas):
        assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_make_adapter_weights_bit_identical_to_jax():
    jcfg = jllama.LlamaConfig.tiny()
    tcfg = tllama.LlamaConfig.tiny()
    want = jllama.make_adapter_weights(jcfg, rank=8, seed=11)
    got = tllama.make_adapter_weights(tcfg, rank=8, seed=11)
    assert len(got) == len(want) == tcfg.n_layer
    for jrows, trows in zip(want, got):
        for j, t in zip(jrows, trows):
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                np.asarray(j).view(np.uint16))


def test_compute_copy_is_the_same_model():
    cfg = tllama.LlamaConfig.tiny()
    model = tllama.Llama(cfg, device="cpu", seed=5)
    copy = model.compute_copy()
    assert copy.layers[0].wq.weight.dtype == torch.bfloat16
    assert copy.embed.dtype == torch.bfloat16
    # Norm scales are shared, in float32.
    assert (copy.final_norm.weight.data_ptr()
            == model.final_norm.weight.data_ptr())
    ids = torch.from_numpy(_ids((2, 12), cfg.vocab_size, seed=5)).long()
    with torch.no_grad():
        assert torch.equal(copy(ids), model(ids))
    bt = torch.tensor([[1, 2], [3, 4]])
    wm = torch.ones(2, 12, dtype=torch.bool)
    pos = torch.zeros(2, dtype=torch.long)
    a, _ = model.decode_paged(ids, tllama.make_paged_arena(
        cfg, 8, 8, device="cpu"), bt, pos, wm)
    b, _ = copy.decode_paged(ids, tllama.make_paged_arena(
        cfg, 8, 8, device="cpu"), bt, pos, wm)
    assert torch.equal(a, b)


def test_presets_seeds_flops_and_unported_options():
    skip = {"dtype", "param_dtype", "sp_mesh"}
    for name in ("llama7b", "small", "tiny"):
        j = dataclasses.asdict(getattr(jllama.LlamaConfig, name)())
        t = dataclasses.asdict(getattr(tllama.LlamaConfig, name)())
        assert {k: v for k, v in j.items() if k not in skip} == \
            {k: v for k, v in t.items() if k not in skip}
        assert tllama.flops_per_token(getattr(tllama.LlamaConfig, name)(),
                                      512) == jllama.flops_per_token(
            getattr(jllama.LlamaConfig, name)(), 512)
    cfg = tllama.LlamaConfig.tiny()
    a = tllama.Llama(cfg, device="cpu", seed=7).state_dict()
    b = tllama.Llama(cfg, device="cpu", seed=7).state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert a["embed"].dtype == torch.float32
    assert abs(a["layers.0.wq.weight"].std().item() - 0.02) < 2e-3
    assert torch.equal(a["final_norm.weight"], torch.ones(cfg.n_embd))
    with pytest.raises(NotImplementedError, match="ROADMAP M8"):
        tllama.Llama(dataclasses.replace(cfg, sp_mesh=object()), device="cpu")
    # remat is ported (tests/test_torch_remat.py): it builds.
    assert tllama.Llama(dataclasses.replace(cfg, remat=True),
                        device="cpu").config.remat
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tllama.Llama(cfg)
