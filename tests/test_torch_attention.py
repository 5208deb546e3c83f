"""The PyTorch port's flash attention against the JAX package's.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode, as tests/test_ops.py runs them) and the port's plain kernel
versions and `flash_attention`, on the CPU. Tolerances are the JAX package's
own for its kernels against its reference: 2e-5 forward, 5e-4 gradients
(float32; only the order of summation differs). The CUDA kernels
themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

B, H, S, D = 1, 2, 256, 64
BLOCK = 128
SCALE = 1.0 / 8.0
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)


def _inputs(seed, n=4, shape=(B, H, S, D)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t3(a):
    """numpy [b, h, s, d] -> torch [b*h, s, d]."""
    return torch.from_numpy(np.array(a)).reshape(-1, *a.shape[2:])


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("causal", [True, False])
def test_forward_plain_version_matches_jax_kernel(interpret, causal):
    q, k, v, _ = _inputs(0)
    out_j, lse_j = jattn._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal, SCALE,
                                        BLOCK, BLOCK)
    for fn in (tattn.flash_forward_reference, tattn._flash_forward):
        out, lse = fn(_t3(q), _t3(k), _t3(v), causal, SCALE)
        np.testing.assert_allclose(out.reshape(B, H, S, D).numpy(),
                                   np.asarray(out_j), **FWD_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0],
                                   **FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_plain_versions_match_jax_kernels(interpret, causal):
    q, k, v, g = _inputs(1)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out_j, lse_j = jattn._flash_forward(jq, jk, jv, causal, SCALE, BLOCK,
                                        BLOCK)
    dq_j, dk_j, dv_j = jattn._flash_backward(jq, jk, jv, out_j, lse_j, jg,
                                             causal, SCALE, BLOCK, BLOCK)
    out = _t3(np.asarray(out_j))
    lse = torch.from_numpy(np.asarray(lse_j)[..., 0].copy())
    do = _t3(g)
    delta = tattn.bwd_delta(out, do)
    args = (_t3(q), _t3(k), _t3(v), do, lse, delta, causal, SCALE)
    dq = tattn.flash_bwd_dq_reference(*args)
    dk, dv = tattn.flash_bwd_dkv_reference(*args)
    # K2's wrapper on the CPU: the plain dQ and the plain delta it computes.
    dq_w, delta_w = tattn._bwd_dq(_t3(q), _t3(k), _t3(v), do, out, lse,
                                  causal, SCALE)
    assert torch.equal(dq_w, dq) and torch.equal(delta_w, delta)
    assert all(torch.equal(a, b) for a, b in zip(tattn._bwd_dkv(*args),
                                                 (dk, dv)))
    # delta as the JAX package's _flash_backward computes it (:289-291).
    delta_j = jnp.sum(jg.astype(jnp.float32) * out_j.astype(jnp.float32),
                      axis=-1)
    np.testing.assert_allclose(delta.reshape(B, H, S).numpy(),
                               np.asarray(delta_j), **GRAD_TOL)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.reshape(B, H, S, D).numpy(),
                                   np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_forward_and_grads_match_jax(interpret, causal):
    import jax

    q, k, v, g = _inputs(2)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out_j, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(
        a, b, c, causal, None, BLOCK, BLOCK), jq, jk, jv)
    grads_j = vjp(jg)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    for got, want in zip(grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_seq_mismatch_is_mha_reference(causal):
    # seq_q != seq_k: the causal mask aligns sequence ends, as in the JAX
    # package's mha_reference (which its flash_attention also answers with).
    q, = _inputs(3, n=1, shape=(1, 2, 32, D))
    k, v = _inputs(4, n=2, shape=(1, 2, 128, D))
    want = np.asarray(jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (tattn.mha_reference(tq, tk, tv, causal=causal),
                tattn.flash_attention(tq, tk, tv, causal)):
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


# F1: the head dims and the type the reference's kernels take beyond
# d 32/64/128 and float32/bf16. In 16 bits the JAX kernel rounds P before
# PV and both round the result: float16 keeps 11 significant bits (2^-11
# relative each rounding), bf16 8.
F16_TOL = dict(atol=5e-3, rtol=5e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)  # bf16 keeps 8 significant bits


@pytest.mark.parametrize("d,dtype", [(192, "float32"), (256, "float32"),
                                     (64, "float16"), (256, "float16"),
                                     (192, "bfloat16"), (256, "bfloat16"),
                                     (192, "float16")])
def test_new_head_dims_and_float16_match_jax_kernels(interpret, d, dtype):
    import jax

    q, k, v, g = _inputs(7, shape=(1, 2, 128, d))
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    out_j, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(
        a, b, c, True, None, BLOCK, BLOCK), jq, jk, jv)
    grads_j = vjp(jg)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                  .requires_grad_() for a in (jq, jk, jv))
    out = tattn.flash_attention(tq, tk, tv, True)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(np.array(
                                    jg, np.float32)).to(tdt))
    assert out.dtype == tdt and all(x.dtype == tdt for x in grads)
    ftol, gtol = {"float32": (FWD_TOL, GRAD_TOL),
                  "float16": (F16_TOL, F16_TOL),
                  "bfloat16": (BF16_TOL, BF16_TOL)}[dtype]
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(out_j, np.float32), **ftol)
    for got, want in zip(grads, grads_j):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **gtol)


@pytest.mark.parametrize("d", [320, 384])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dims_above_256_match_jax_kernels(interpret, causal, d):
    # A multiple of 64 above 256: the reference's _use_pallas runs its
    # kernels there (128 x 128 blocks), and the port's wide kernels answer
    # it; on the CPU their plain versions. float32, the kernels' own
    # tolerances (2e-5 forward, 5e-4 gradients).
    import jax

    q, k, v, g = _inputs(11, shape=(1, 2, 128, d))
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    assert jattn._use_pallas(jq, jk, BLOCK, BLOCK, causal)
    out_j, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(
        a, b, c, causal, None, BLOCK, BLOCK), jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    for got, want in zip(grads, vjp(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    assert all(t.wide for t in (tattn.TILES[name, torch.float32][d]
                                for name in tattn.KERNELS))


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_96_is_answered_like_the_reference(interpret, causal):
    # d % 64 != 0 with no kernel: the reference's _use_pallas sends it to
    # mha_reference, and so does the port, forward and backward.
    import jax

    q, k, v, g = _inputs(8, shape=(1, 2, 128, 96))
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out_j, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(
        a, b, c, causal, None, BLOCK, BLOCK), jq, jk, jv)
    want_ref = jattn.mha_reference(jq, jk, jv, causal=causal)
    np.testing.assert_array_equal(np.asarray(out_j), np.asarray(want_ref))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = tattn.kernel_launches()
    out = tattn.flash_attention(tq, tk, tv, causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    for got, want in zip(grads, vjp(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    assert tattn.kernel_launches() == before


def test_wrapper_takes_float16():
    # float16 has kernels now: the wrappers answer it (on the CPU, with the
    # plain versions), in float16, as they answer float32.
    q, k, v, do = (torch.randn(2, 64, D) for _ in range(4))
    out, lse = tattn._flash_forward(*(t.half() for t in (q, k, v)), True,
                                    SCALE)
    want, want_lse = tattn.flash_forward_reference(q, k, v, True, SCALE)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), **F16_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **F16_TOL)


def test_mha_reference_bf16_rounds_probs_like_jax():
    # Probabilities are cast to v's dtype before the PV product; bf16 keeps
    # 8 significant bits, so one bf16 rounding apart is 2^-8 relative.
    q, k, v = _inputs(5, n=3, shape=(1, 2, 64, D))
    want = np.asarray(jattn.mha_reference(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))).astype(
            jnp.float32))
    got = tattn.mha_reference(*(torch.from_numpy(a).bfloat16()
                                for a in (q, k, v))).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_cpu_calls_are_not_kernel_launches():
    before = tattn.kernel_launches()
    q, k, v, g = (_t3(a) for a in _inputs(6, shape=(1, 2, 64, D)))
    out, lse = tattn._flash_forward(q, k, v, True, SCALE)
    tattn._flash_backward(q, k, v, out, lse, g, True, SCALE)
    assert tattn.kernel_launches() == before
    assert set(before) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}


@pytest.mark.parametrize("bad", ["meta", "float64", "strided", "head_dim",
                                 "shape"])
def test_wrapper_rejects_what_the_kernels_do_not_take(bad):
    # The kernel wrappers refuse what no kernel is compiled for: float64, a
    # head dim without a kernel (48), other devices and layouts.
    q, k, v = (torch.randn(2, 64, D) for _ in range(3))
    if bad == "meta":
        q, k, v = (t.to("meta") for t in (q, k, v))
    elif bad == "float64":
        q, k, v = (t.double() for t in (q, k, v))
    elif bad == "strided":
        q = torch.randn(2, D, 64).transpose(1, 2)
    elif bad == "head_dim":
        q, k, v = (torch.randn(2, 64, 48) for _ in range(3))
    else:
        v = torch.randn(2, 32, D)
    with pytest.raises(ValueError):
        tattn._flash_forward(q, k, v, True, SCALE)


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided"])
def test_bwd_dq_rejects_an_out_unlike_q(bad):
    # K2 reads O beside dO to sum delta: it must be q's shape, dtype and
    # layout, as dO must.
    q, k, v, do = (torch.randn(2, 64, D) for _ in range(4))
    lse = torch.zeros(2, 64)
    out = {"shape": torch.randn(2, 32, D),
           "dtype": torch.randn(2, 64, D).bfloat16(),
           "strided": torch.randn(2, D, 64).transpose(1, 2)}[bad]
    with pytest.raises(ValueError):
        tattn._bwd_dq(q, k, v, do, out, lse, True, SCALE)


def test_tile_table_fits_hopper_shared_memory():
    # Each kernel's tiles come from one table (`TILES`, one entry per
    # kernel, dtype and head dim); every block fits Hopper's 227 KB, and the
    # head dims the kernels are not compiled for are refused.
    for (name, dtype), by_d in tattn.TILES.items():
        assert name in tattn.KERNELS
        assert set(by_d) == set(tattn.head_dims(dtype))
        for d, t in by_d.items():
            # wgmma's M is 64 rows per warpgroup, and the dK/dV kernel starts
            # its causal q loop at key0 / stream: both must divide evenly.
            assert t.rows % 64 == 0
            assert t.rows % t.stream == 0 and t.stages >= 2
            # Every body is a TMA ring feeding the tensor cores: the Hopper
            # bodies in 16 bits, the 3xTF32 ones in float32. Above 256, d
            # is a run-time argument of every body, and in float32 at every
            # head dim; a block of a body with d at run time owns a chunk of
            # the output's columns. From d 192 up, the 16-bit dK/dV block's
            # two warpgroups share its keys (split 2); the float32 dK/dV
            # block's own 64 keys each, as dQ's own their queries.
            assert t.wide == (d > 256 or dtype == torch.float32)
            assert (t.cols > 0) == t.wide
            assert t.split == (2 if name == "flash_bwd_dkv" and 128 < d
                               and dtype != torch.float32 else 1)
    assert len(tattn.TILES) == 3 * len(tattn.KERNELS)
    assert set(tattn.HEAD_DIMS) == {32, 64, 128, 192, 256}
    # One wide instance a type serves every multiple of 64 above 256 up to
    # the largest whose blocks fit: 704 in float32, 1024 in 16 bits.
    assert tattn.WIDE_MAX_D == {torch.float32: 704, torch.bfloat16: 1024,
                                torch.float16: 1024}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        assert tattn.head_dims(dtype)[5:] == tuple(
            range(320, tattn.WIDE_MAX_D[dtype] + 1, 64))
        for d in tattn.head_dims(dtype):
            smem = tattn.kernel_smem_bytes(d, dtype)
            assert set(smem) == set(tattn.KERNELS)
            assert max(smem.values()) <= tattn.SMEM_LIMIT
    with pytest.raises(ValueError):
        tattn.kernel_smem_bytes(96)
    # Past that cap the kernels refuse the head dim, naming the cap.
    for dtype, d in ((torch.float32, 768), (torch.bfloat16, 1088)):
        q = torch.randn(1, 2, 32, d, dtype=dtype)
        with pytest.raises(ValueError,
                           match=str(tattn.WIDE_MAX_D[dtype])):
            tattn.flash_attention(q, q, q, True)
        with pytest.raises(ValueError):
            tattn.kernel_smem_bytes(d, dtype)


def test_tile_table_mirrors_the_cuda_sources():
    # The Hopper bodies fix their tiles in flash_common.cuh (FwdTiles,
    # DqTiles, DkvTiles, each specialised at 192 and 256; above d 256
    # WideFwdTiles, WideDqTiles and WideDkvTiles), the float32 bodies in
    # namespace tf32; the table the wrappers and chip_smoke.py read must
    # agree.
    import os
    import re

    src = open(os.path.join(os.path.dirname(tattn.__file__), os.pardir,
                            "csrc", "flash_common.cuh")).read()
    # The float32 bodies (namespace tf32): rows, the rows of a streamed
    # tile, the forward's ring A slots and V's, one slot of A fewer above
    # `wider` columns of O; the backward pair's ring A slots, the widest
    # chunk of dK/dV's columns, and ring B's slots (one above 128 columns a
    # slot, else two); the boxes' columns and the blocks that fill the
    # card, which set the output's column chunks (`f32_cols`).
    f32 = tuple(map(int, re.search(
        r"namespace tf32 \{\s*constexpr int ROWS = (\d+), TILE = (\d+), "
        r"STAGES = (\d+), V_STAGES = (\d+);", src).groups()))
    assert f32[3] == tattn._V_STAGES
    wider = int(re.search(r"return cols > (\d+) \? STAGES - 1 : STAGES;",
                          src).group(1))
    assert wider == 128
    bwd_stages = int(re.search(r"constexpr int BWD_STAGES = (\d+);",
                               src).group(1))
    assert bwd_stages == tattn._F32_BWD_STAGES
    dq_widest, dkv_widest = map(int, re.search(
        r"constexpr int DQ_WIDEST = (\d+), DKV_WIDEST = (\d+);",
        src).groups())
    assert tattn._F32_WIDEST == {"flash_fwd": 256, "flash_bwd_dq": dq_widest,
                                 "flash_bwd_dkv": dkv_widest}
    assert int(re.search(r"constexpr int STAT = TILE \+ 4, STAT_LD = (\d+);",
                         src).group(1)) == tattn._F32_STAT_LD
    b_wider = int(re.search(r"return b_cols > (\d+) \? 1 : 2;",
                            src).group(1))
    assert b_wider == 128
    for name, per_col in (("flash_bwd_dq", 1), ("flash_bwd_dkv", 2)):
        for cols in (32, 64, 128, 256):
            assert tattn._f32_b_stages(name, cols) == (
                1 if per_col * cols > b_wider else 2)
    assert int(re.search(r"constexpr int CHUNK = (\d+);", src).group(1)) \
        == tattn._F32_CHUNK
    assert int(re.search(r"constexpr int FILL = (\d+);", src).group(1)) \
        == tattn._FILL
    # The 16-bit forward above 256 (WideFwdTiles): rows, the keys of a
    # tile, ring A's slots and V's; O's column chunks of 192 or 256.
    ring_wide = tuple(map(int, re.search(
        r"struct WideFwdTiles \{\s*static constexpr int ROWS = (\d+), "
        r"TILE = (\d+), STAGES = (\d+), V_STAGES = (\d+);", src).groups()))
    assert ring_wide[3] == tattn._V_STAGES
    # The 16-bit dQ and dK/dV above 256 (WideDqTiles, WideDkvTiles): rows,
    # the rows of a streamed tile, ring A's slots and ring B's.
    ring_wide_bwd = {}
    for struct, name in (("WideDqTiles", "flash_bwd_dq"),
                         ("WideDkvTiles", "flash_bwd_dkv")):
        rows, tile, stages, b_stages = map(int, re.search(
            r"struct " + struct + r" \{\s*static constexpr int ROWS = "
            r"(\d+), TILE = (\d+), STAGES = (\d+), B_STAGES = (\d+);",
            src).groups())
        assert b_stages == tattn._B_STAGES
        ring_wide_bwd[name] = (rows, tile, stages)
    assert int(re.search(r"SMEM_LIMIT = (\d+);", src).group(1)) \
        == tattn.SMEM_LIMIT
    for struct, name in (("FwdTiles", "flash_fwd"),
                         ("DqTiles", "flash_bwd_dq"),
                         ("DkvTiles", "flash_bwd_dkv")):
        # TILE is one number, or "D == 128 ? a : b".
        body = re.search(struct + r" \{[^}]*ROWS = (\d+), TILE = "
                         r"(?:D == 128 \? (\d+) : )?(\d+), STAGES = (\d+);",
                         src)
        rows, tile128, tile, stages = body.groups()
        # The specialisations at 192 and 256, in every kernel; dK/dV's two
        # warpgroups share their keys there (split 2).
        spec = {int(d): tuple(map(int, rest)) for d, *rest in re.findall(
            struct + r"<(\d+)> \{\s*static constexpr int ROWS = (\d+), "
            r"TILE = (\d+), STAGES = (\d+);", src)}
        assert set(spec) == {192, 256}
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            for d, t in tattn.TILES[name, dtype].items():
                if dtype == torch.float32:
                    cols = tattn.f32_cols(name, d)
                    n = (f32[2] - (cols > wider) if name == "flash_fwd"
                         else bwd_stages)
                    assert t == tattn.Tile(*f32[:2], n, wide=True,
                                           cols=cols)
                    assert cols <= tattn._F32_WIDEST[name]
                elif t.wide:
                    m = d // 64
                    cols = -(-m // -(-m // 4)) * 64
                    if name == "flash_fwd":
                        assert t == tattn.Tile(*ring_wide[:3],
                                               wide=True, cols=cols)
                    else:
                        assert t == tattn.Tile(
                            *ring_wide_bwd[name],
                            2 if name == "flash_bwd_dkv" else 1, wide=True,
                            cols=cols)
                elif d in spec:
                    assert t == tattn.Tile(
                        *spec[d], 2 if name == "flash_bwd_dkv" else 1)
                else:
                    want = tile128 if d == 128 and tile128 else tile
                    assert t == tattn.Tile(int(rows), int(want), int(stages))


@pytest.mark.parametrize("d", [32, 64, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fwd_ring_shared_memory(d, dtype):
    # The 16-bit forward block keeps Q of its 128 rows and streams K and V
    # through the slots: 3 slots of 128 keys up to d 128; 64-key tiles
    # above, 3 slots at d 192 and 2 at d 256 (Q and a slot take 48 and
    # 64 KB each). One mbarrier for Q and two per slot, four above d 128
    # (K and V are released apart); 1024 bytes to align the swizzle.
    # chip_smoke.py checks these against what flash_fwd_smem asks for on
    # the card.
    t = tattn.TILES["flash_fwd", dtype][d]
    stream, stages = {192: (64, 3), 256: (64, 2)}.get(d, (128, 3))
    assert t == tattn.Tile(128, stream, stages)
    bars = (4 if d > 128 else 2) * stages
    want = 128 * d * 2 + stages * 2 * stream * d * 2 + 8 * (1 + bars) + 1024
    assert tattn.kernel_smem_bytes(d, dtype)["flash_fwd"] == want
    assert want <= tattn.SMEM_LIMIT


@pytest.mark.parametrize("d", range(320, 1025, 64))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wide_fwd_ring_shared_memory(d, dtype):
    # The 16-bit forward above d 256 holds no row of Q or K whole: ring A's
    # 6 slots each take a 64-column chunk of Q's 128 rows and of K's 64
    # keys, ring B's 2 slots V's 64 keys x the block's chunk of O's
    # columns; a full and an empty mbarrier a slot; 1024 bytes to align the
    # swizzle. O's d columns are split into c chunks of 192 or 256, as few
    # as 256 each allow, of one width, each chunk starting inside d, so the
    # block fits at every head dim the 16-bit types take.
    t = tattn.TILES["flash_fwd", dtype][d]
    chunks = -(-d // 256)
    cols = -(-(d // 64) // chunks) * 64
    assert tattn.wide_chunks(d) == (chunks, cols)
    assert cols in (192, 256) and (chunks - 1) * cols < d <= chunks * cols
    assert t == tattn.Tile(128, 64, 6, wide=True, cols=cols)
    want = 6 * (128 + 64) * 64 * 2 + 2 * 64 * cols * 2 + 8 * 2 * (6 + 2) \
        + 1024
    assert tattn.kernel_smem_bytes(d, dtype)["flash_fwd"] == want
    assert want <= tattn.SMEM_LIMIT


@pytest.mark.parametrize("d", tattn.head_dims(torch.float32))
def test_f32_fwd_ring_shared_memory(d):
    # The float32 forward (3xTF32), d at run time at every float32 head
    # dim: each of ring A's slots takes a 32-column (128-byte) chunk of Q's
    # 128 rows, of K's 64 keys and of those keys' small TF32 parts, 4 slots
    # (3 beside V's tiles of 256 columns); ring B's 2 slots V's 64 keys x
    # the block's chunk of O's columns (the power of two from 32 to 256
    # that covers d: the whole of d up to 256, and above as few chunks of
    # 256 as cover it); a full, a ready and an empty mbarrier a slot of A,
    # a full and an empty one a slot of B; 1024 bytes to align the
    # swizzle. No block grows with d. chip_smoke.py checks these against
    # what flash_fwd_smem asks for on the card.
    t = tattn.TILES["flash_fwd", torch.float32][d]
    cols = {32: 32, 64: 64, 128: 128}.get(d, 256)
    chunks = -(-d // cols)
    stages = 3 if cols == 256 else 4
    assert t == tattn.Tile(128, 64, stages, wide=True, cols=cols)
    assert chunks == -(-d // 256)
    assert (chunks - 1) * cols < d <= chunks * cols
    want = stages * (128 + 2 * 64) * 32 * 4 + 2 * 64 * cols * 4 \
        + 8 * (3 * stages + 2 * 2) + 1024
    assert tattn.kernel_smem_bytes(d, torch.float32)["flash_fwd"] == want
    assert want <= tattn.SMEM_LIMIT


@pytest.mark.parametrize("bh,seq,d,cols", [
    # Grids that fill the card: the power of two that covers d, up to 256.
    (24, 2048, 64, 64), (24, 2048, 192, 256), (24, 2048, 256, 256),
    (24, 2048, 384, 256), (24, 2048, 704, 256),
    # chip_smoke.py's small float32 shapes (4 to 8 row blocks): chunks of
    # 64 columns; d 32 and 64 have no narrower chunk.
    (4, 256, 256, 64), (2, 256, 512, 64), (3, 200, 128, 64), (5, 77, 32, 32),
    (4, 256, 64, 64),
    # In between: half as many columns while the grid holds fewer than
    # 132 blocks.
    (16, 1024, 256, 128), (2, 2048, 704, 128), (6, 2048, 192, 128)])
def test_f32_fwd_column_chunks_fill_the_card(bh, seq, d, cols):
    # The launcher splits O's columns further where the row blocks alone
    # leave the card's 132 SMs idle (flash_common.cuh tf32::cols): every
    # chunk starts inside d, the chunks cover it, and the grid reaches 132
    # blocks unless the chunks are down to 64 columns (32 at d 32). The
    # widths are the four instances the source compiles.
    blocks = bh * -(-seq // 128)
    got = tattn.f32_cols("flash_fwd", d, blocks)
    assert got == cols
    chunks = -(-d // got)
    assert (chunks - 1) * got < d <= chunks * got
    assert blocks * chunks >= 132 or got == min(d, 64)
    assert got in (32, 64, 128, 256)
    assert got <= tattn.TILES["flash_fwd", torch.float32][d].cols


@pytest.mark.parametrize("d", tattn.head_dims(torch.float32))
@pytest.mark.parametrize("name", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_f32_bwd_ring_shared_memory(name, d):
    # The float32 backward pair (3xTF32), d at run time at every float32
    # head dim: a block owns 128 rows (queries; keys) and one chunk of its
    # gradients' columns, the power of two from 32 that covers d, up to
    # 128 (a dK/dV block holds two gradients). Ring A's 4
    # slots each take a 32-column (128-byte) chunk of the owned rows, of
    # the 64 streamed rows and of their small TF32 parts, as the forward's;
    # ring B's slots the streamed rows x the block's columns (K's; Q's and
    # dO's, with lse and delta from the 16-byte boundary at or before the
    # tile's first row, 96 floats each), 1 slot where that is
    # more than 128 columns, else 2; a float32 buffer of the block's
    # [128 x 64] dP; dQ's 128 rows' lse and delta; a full, a ready and an
    # empty mbarrier a slot of A, a full and an empty one a slot of B;
    # 1024 bytes to align the swizzle. No block grows with d. chip_smoke.py
    # checks these against what flash_bwd_smem asks for on the card.
    dkv = name == "flash_bwd_dkv"
    t = tattn.TILES[name, torch.float32][d]
    widest = 128
    cols = {32: 32, 64: 64}.get(d, 128)
    assert t == tattn.Tile(128, 64, 4, wide=True, cols=cols)
    chunks = -(-d // cols)
    assert chunks == -(-d // widest) and (chunks - 1) * cols < d
    b_cols = cols * (2 if dkv else 1)
    b_slots = 1 if b_cols > 128 else 2
    want = (4 * (128 + 2 * 64) * 32 * 4
            + b_slots * (64 * b_cols * 4 + (2 * 96 * 4 if dkv else 0))
            + 128 * 64 * 4 + (0 if dkv else 128 * 2 * 4)
            + 8 * (3 * 4 + 2 * b_slots) + 1024)
    assert tattn.kernel_smem_bytes(d, torch.float32)[name] == want
    assert want <= tattn.SMEM_LIMIT


@pytest.mark.parametrize("name,bh,seq,d,cols", [
    # Grids that fill the card: the power of two that covers d, up to 128.
    ("flash_bwd_dq", 24, 2048, 64, 64), ("flash_bwd_dq", 24, 2048, 192, 128),
    ("flash_bwd_dq", 24, 2048, 704, 128),
    ("flash_bwd_dkv", 24, 2048, 128, 128),
    ("flash_bwd_dkv", 24, 2048, 256, 128),
    ("flash_bwd_dkv", 24, 2048, 704, 128),
    # chip_smoke.py's small float32 shapes (4 to 8 row blocks): chunks of
    # 64 columns; d 32 has no narrower chunk.
    ("flash_bwd_dq", 4, 256, 256, 64), ("flash_bwd_dkv", 2, 256, 512, 64),
    ("flash_bwd_dkv", 5, 77, 32, 32),
    # In between: half as many columns while the grid holds fewer than 132
    # blocks.
    ("flash_bwd_dq", 16, 1024, 256, 128), ("flash_bwd_dq", 2, 2048, 704, 128),
    ("flash_bwd_dkv", 2, 1024, 128, 64)])
def test_f32_bwd_column_chunks_fill_the_card(name, bh, seq, d, cols):
    # The launchers split the gradients' columns further where the row
    # blocks alone leave the card's 132 SMs idle (tf32::cols, as the
    # forward's): every chunk starts inside d, the chunks cover it, and the
    # grid reaches 132 blocks unless the chunks are down to 64 columns (32
    # at d 32). The widths are the instances the source compiles.
    blocks = bh * -(-seq // 128)
    got = tattn.f32_cols(name, d, blocks)
    assert got == cols
    chunks = -(-d // got)
    assert (chunks - 1) * got < d <= chunks * got
    assert blocks * chunks >= 132 or got == min(d, 64)
    assert got in (32, 64, 128)
    assert got <= tattn.TILES[name, torch.float32][d].cols


def _mismatch(got, want, tol):
    """max |got - want| / (tol * (row rms + |want|)), the row rms floored
    at a tenth of the tensor's, as chip_smoke.py and the card tests hold
    the kernels."""
    typical = torch.maximum(want.square().mean(dim=-1, keepdim=True).sqrt(),
                            want.square().mean().sqrt() / 10)
    return ((got - want).abs() / (tol * (typical + want.abs()))).max().item()


def test_tf32_split_keeps_float32_accuracy():
    # The float32 forward splits each operand x into big + small, both TF32
    # (10 mantissa bits, the 13 low bits 0) as mma reads them: big is x
    # truncated, and what big + small misses is at most 2^-20 of x, where
    # big alone misses up to 2^-10 and x rounded once up to 2^-11.
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        4096).astype(np.float32)) * torch.logspace(-20, 20, 4096)
    big, small = tattn.split_tf32(x)
    for part in (big, small, tattn.round_tf32(x)):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((big - x).abs() <= 2.0 ** -10 * x.abs()).all()
    assert (big.abs() <= x.abs()).all() and (small.abs() <= x.abs()).all()
    assert ((tattn.round_tf32(x) - x).abs() <= 2.0 ** -11 * x.abs()).all()
    assert ((big + small - x).abs() <= 2.0 ** -20 * x.abs()).all()
    # Rounding ties go away from zero, as cvt.rna.tf32.f32 rounds.
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert tattn.round_tf32(tie).tolist() == [1 + 2.0 ** -10,
                                              -(1 + 2.0 ** -10)]
    assert tattn.truncate_tf32(tie).tolist() == [1.0, -1.0]


@pytest.mark.parametrize("d", [64, 256, 704])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_limit_rejects_single_pass_tf32(d, causal):
    # The float32 forward is held to 1e-4 of its plain version, element by
    # element against each row's rms (chip_smoke.py TOL, the card tests).
    # Its 3xTF32 products sit far inside that limit; one TF32 pass (Q, K, V
    # and P rounded once to 10 mantissa bits) is well outside it, which is
    # why the kernel splits every operand.
    q, k, v = (torch.from_numpy(a).reshape(2, 256, d)
               for a in _inputs(12, n=3, shape=(1, 2, 256, d)))
    scale = d ** -0.5
    want, want_lse = tattn.flash_forward_reference(q, k, v, causal, scale)
    out3, lse3 = tattn.flash_forward_tf32_reference(q, k, v, causal, scale)
    out1, _ = tattn.flash_forward_tf32_reference(q, k, v, causal, scale,
                                                 passes=1)
    assert _mismatch(out3, want, 1e-4) < 0.2
    assert _mismatch(lse3, want_lse, 1e-4) < 0.2
    assert _mismatch(out1, want, 1e-4) > 5


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_3xtf32_forward_matches_jax_kernel(interpret, d, causal):
    # The float32 kernel's arithmetic (3xTF32 products, float32 sums) against
    # the JAX package's float32 kernel, at its own float32 tolerance.
    q, k, v = _inputs(14, n=3, shape=(1, 2, 128, d))
    scale = d ** -0.5
    out_j, lse_j = jattn._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal, scale,
                                        BLOCK, BLOCK)
    out, lse = tattn.flash_forward_tf32_reference(_t3(q), _t3(k), _t3(v),
                                                  causal, scale)
    np.testing.assert_allclose(out.reshape(1, 2, 128, d).numpy(),
                               np.asarray(out_j), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0],
                               **FWD_TOL)


def _f32_backward_inputs(seed, shape, causal):
    """float32 q, k, v, dO, lse and delta [bh, seq, d] from numpy, the
    forward's from its plain version."""
    q, k, v, do = (torch.from_numpy(a).reshape(-1, *shape[2:])
                   for a in _inputs(seed, shape=shape))
    scale = shape[-1] ** -0.5
    out, lse = tattn.flash_forward_reference(q, k, v, causal, scale)
    return q, k, v, do, lse, tattn.bwd_delta(out, do), scale


@pytest.mark.parametrize("d", [64, 256, 704])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_limit_rejects_single_pass_tf32_backward(d, causal):
    # The float32 backward pair is held to 5e-4 of its plain version,
    # element by element against each row's rms (chip_smoke.py TOL, the
    # card tests). Its 3xTF32 products sit inside that limit (causal dQ,
    # whose row 0 is 0 in exact arithmetic, the closest); one TF32 pass
    # (every operand rounded once to 10 mantissa bits) breaks it on each of
    # dQ, dK and dV, which is why the kernels split every operand.
    q, k, v, do, lse, delta, scale = _f32_backward_inputs(
        16, (1, 2, 256, d), causal)
    args = (q, k, v, do, lse, delta, causal, scale)
    want = (tattn.flash_bwd_dq_reference(*args),
            *tattn.flash_bwd_dkv_reference(*args))
    three = tattn.flash_bwd_tf32_reference(*args)
    one = tattn.flash_bwd_tf32_reference(*args, passes=1)
    for got3, got1, w in zip(three, one, want):
        assert _mismatch(got3, w, 5e-4) < 0.5
        assert _mismatch(got1, w, 5e-4) > 2


@pytest.mark.parametrize("d", [64, 256, 704])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_3xtf32_backward_matches_jax_kernel(interpret, d, causal):
    # The float32 backward kernels' arithmetic (3xTF32 products, float32
    # sums) against the JAX package's float32 backward kernels, from the
    # JAX forward's out and lse, at their own float32 tolerance.
    q, k, v, g = _inputs(17, shape=(1, 2, 128, d))
    scale = d ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out_j, lse_j = jattn._flash_forward(jq, jk, jv, causal, scale, BLOCK,
                                        BLOCK)
    grads_j = jattn._flash_backward(jq, jk, jv, out_j, lse_j, jg, causal,
                                    scale, BLOCK, BLOCK)
    lse = torch.from_numpy(np.asarray(lse_j)[..., 0].copy())
    delta = tattn.bwd_delta(_t3(np.asarray(out_j)), _t3(g))
    grads = tattn.flash_bwd_tf32_reference(_t3(q), _t3(k), _t3(v), _t3(g),
                                           lse, delta, causal, scale)
    for got, want in zip(grads, grads_j):
        np.testing.assert_allclose(got.reshape(1, 2, 128, d).numpy(),
                                   np.asarray(want), **GRAD_TOL)


def _chunks_cover(d, cols):
    """The 16-bit blocks above d 256 own chunks of `cols` of the output's
    columns, as few as 256 columns each allow: each chunk starts inside d,
    and the last may run past it."""
    chunks = -(-d // 256)
    assert tattn.wide_chunks(d) == (chunks, cols)
    assert cols in (192, 256) and cols % 64 == 0
    assert all(c * cols < d for c in range(chunks))
    assert chunks * cols >= d


@pytest.mark.parametrize("d", range(320, 1025, 64))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wide_dq_ring_shared_memory(d, dtype):
    # The 16-bit dQ block above d 256 holds no row of Q, dO, K or V whole:
    # ring A's 4 slots each take a 64-column chunk of Q's and dO's 128 rows
    # and of K's and V's 64 keys; ring B's 1 slot K's 64 keys x the block's
    # chunk of dQ's columns; a full and an empty mbarrier a slot; 1024
    # bytes to align the swizzle. So the block fits at every head dim the
    # 16-bit types take.
    t = tattn.TILES["flash_bwd_dq", dtype][d]
    cols = -(-(d // 64) // -(-d // 256)) * 64
    _chunks_cover(d, cols)
    assert t == tattn.Tile(128, 64, 4, wide=True, cols=cols)
    want = 4 * 2 * (128 + 64) * 64 * 2 + 1 * 64 * cols * 2 \
        + 8 * 2 * (4 + 1) + 1024
    assert tattn.kernel_smem_bytes(d, dtype)["flash_bwd_dq"] == want
    assert want <= tattn.SMEM_LIMIT


@pytest.mark.parametrize("d", range(320, 1025, 64))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wide_dkv_ring_shared_memory(d, dtype):
    # The 16-bit dK/dV block above d 256: 64 keys that both warpgroups
    # share (split 2), ring A's 4 slots each a 64-column chunk of K, V and
    # of the 64 queries' Q and dO; ring B's 1 slot the queries' Q and dO x
    # the block's chunk of columns with their lse and delta (float32); one
    # float32 P^T buffer of [64 keys x 64 queries] with a full and an empty
    # mbarrier; a full and an empty mbarrier a slot; 1024 bytes to align
    # the swizzle.
    t = tattn.TILES["flash_bwd_dkv", dtype][d]
    cols = -(-(d // 64) // -(-d // 256)) * 64
    _chunks_cover(d, cols)
    assert t == tattn.Tile(64, 64, 4, 2, wide=True, cols=cols)
    want = (4 * 2 * (64 + 64) * 64 * 2
            + 1 * (2 * 64 * cols * 2 + 2 * 64 * 4)
            + 64 * 64 * 4 + 8 * 2 + 8 * 2 * (4 + 1) + 1024)
    assert tattn.kernel_smem_bytes(d, dtype)["flash_bwd_dkv"] == want
    assert want <= tattn.SMEM_LIMIT


def test_import_ends_with_the_16_bit_head_dim_cap():
    # None of the 16-bit blocks above d 256 grows with d, so a search for
    # the largest head dim whose blocks fit would never end there: the cap
    # is a named constant, and importing the module must end.
    import os
    import subprocess
    import sys

    code = ("import torch\n"
            "from ray_tpu_torch.ops import attention as a\n"
            "assert a.HALF_WIDE_MAX_D == 1024\n"
            "print(a.WIDE_MAX_D[torch.bfloat16], "
            "a.WIDE_MAX_D[torch.float16], a.WIDE_MAX_D[torch.float32])")
    package = os.path.dirname(os.path.dirname(os.path.abspath(tattn.__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(package))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["1024", "1024", "704"]
    for dtype in (torch.bfloat16, torch.float16):
        assert tattn.WIDE_MAX_D[dtype] == tattn.HALF_WIDE_MAX_D == 1024
        assert max(tattn.TILES["flash_bwd_dkv", dtype]) == 1024


@pytest.mark.parametrize("d", [32, 64, 128, 192, 256])
def test_dq_ring_shared_memory(d):
    # The bf16 dQ block keeps Q, dO and O (128 rows each; above d 128 O
    # stays in device memory) and streams K and V through 4 slots (5 and 3
    # of 32 keys at d 192 and 256), with no lse or delta in the slots (each
    # thread reads its rows' own); one mbarrier for the resident tiles and
    # two per slot; 1024 bytes to align the swizzle. chip_smoke.py checks
    # these against what flash_bwd_smem asks for on the card.
    t = tattn.TILES["flash_bwd_dq", torch.bfloat16][d]
    stages = {192: 5, 256: 3}.get(d, 4)
    assert (t.rows, t.stages) == (128, stages)
    resident = 3 if d <= 128 else 2
    want = (resident * 128 * d * 2 + stages * 2 * t.stream * d * 2
            + 8 * (1 + 2 * stages) + 1024)
    assert tattn.kernel_smem_bytes(d)["flash_bwd_dq"] == want
    assert want <= tattn.SMEM_LIMIT


@pytest.mark.parametrize("d", [32, 64, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dkv_ring_shared_memory(d, dtype):
    # The 16-bit dK/dV block keeps K and V of its keys (128; 64 above d
    # 128, which both warpgroups share) and streams Q and dO with their
    # queries' lse and delta (float32) through the slots; above d 128 warp
    # group 0 hands P^T to warpgroup 1 through two float32 buffers of
    # [64 keys x stream queries], each with a full and an empty mbarrier.
    # One mbarrier for the resident tiles and two per slot; 1024 bytes to
    # align the swizzle. chip_smoke.py checks these against what
    # flash_bwd_smem asks for on the card.
    t = tattn.TILES["flash_bwd_dkv", dtype][d]
    rows = 128 if d <= 128 else 64
    assert t.rows == rows and t.split == (1 if d <= 128 else 2)
    slot = 2 * t.stream * d * 2 + 2 * t.stream * 4
    handoff = 0 if d <= 128 else 2 * 64 * t.stream * 4 + 4 * 8
    want = (2 * rows * d * 2 + t.stages * slot + handoff
            + 8 * (1 + 2 * t.stages) + 1024)
    assert tattn.kernel_smem_bytes(d, dtype)["flash_bwd_dkv"] == want
    assert want <= tattn.SMEM_LIMIT


def test_time_attention_needs_the_card():
    # The timing script measures the card only: without CUDA it exits 2
    # and prints no result.
    from ray_tpu_torch import time_attention

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour where CUDA is absent")
    assert time_attention.main(["--d", "64"]) == 2
