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
                                     (192, "bfloat16")])
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
            assert t.rows % (64 if t.ring else 16) == 0
            assert t.rows % t.stream == 0 and t.stages >= (2 if t.ring else 1)
            # The Hopper bodies take the 16-bit types up to d 128, the wide
            # bodies every type above 256.
            assert t.ring == (dtype != torch.float32 and d <= 128)
            assert t.wide == (d > 256)
            assert t.split == (2 if name == "flash_bwd_dkv"
                               and 128 < d <= 256 else 1)
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
    # Past that limit the tiles do not fit a block: a resource limit, named
    # in the message, as the reference's VMEM is one.
    for dtype, d in ((torch.float32, 768), (torch.bfloat16, 1088)):
        q = torch.randn(1, 2, 32, d, dtype=dtype)
        with pytest.raises(ValueError,
                           match=str(tattn.WIDE_MAX_D[dtype])):
            tattn.flash_attention(q, q, q, True)
        with pytest.raises(ValueError):
            tattn.kernel_smem_bytes(d, dtype)


def test_tile_table_mirrors_the_cuda_sources():
    # The Hopper bodies (16-bit, d <= 128) fix their tiles in
    # flash_common.cuh (FwdTiles, DqTiles, DkvTiles), the CUDA-core bodies
    # in BLOCK and PlainTiles; the table the wrappers and chip_smoke.py read
    # must agree.
    import os
    import re

    src = open(os.path.join(os.path.dirname(tattn.__file__), os.pardir,
                            "csrc", "flash_common.cuh")).read()
    block = int(re.search(r"constexpr int BLOCK = (\d+);", src).group(1))
    # PlainTiles: STREAM = D > 128 ? a : b, SPLIT = D > 128 ? c : e.
    plain = re.search(r"PlainTiles \{\s*static constexpr int STREAM = "
                      r"D > 128 \? (\d+) : (\d+), SPLIT = D > 128 \? (\d+) "
                      r": (\d+);", src)
    s_big, s_small, split_big, split_small = map(int, plain.groups())
    # The wide bodies: ROWS, and the streamed rows of each kernel.
    wide = re.search(r"constexpr int ROWS = (\d+), THREADS = \d+;\s*"
                     r"constexpr int FWD_STREAM = (\d+), DQ_STREAM = (\d+), "
                     r"DKV_STREAM = (\d+);", src)
    wide_rows, fwd_s, dq_s, dkv_s = map(int, wide.groups())
    wide_stream = {"flash_fwd": fwd_s, "flash_bwd_dq": dq_s,
                   "flash_bwd_dkv": dkv_s}
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
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            for d, t in tattn.TILES[name, dtype].items():
                if t.wide:
                    assert t == tattn.Tile(wide_rows, wide_stream[name], 1,
                                           False, wide=True)
                elif t.ring:
                    want = tile128 if d == 128 and tile128 else tile
                    assert t == tattn.Tile(int(rows), int(want), int(stages),
                                           True)
                else:
                    split = split_big if d > 128 else split_small
                    assert t == tattn.Tile(
                        block, s_big if d > 128 else s_small, 1, False,
                        split if name == "flash_bwd_dkv" else 1)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_dq_ring_shared_memory(d):
    # The bf16 dQ block keeps Q, dO and O (128 rows each) and streams K and
    # V through 4 slots, with no lse or delta in the slots (each thread
    # reads its rows' own); one mbarrier for the resident tiles and two per
    # slot; 1024 bytes to align the swizzle. chip_smoke.py checks these
    # against what flash_bwd_smem asks for on the card.
    t = tattn.TILES["flash_bwd_dq", torch.bfloat16][d]
    assert t.ring and (t.rows, t.stages) == (128, 4)
    want = 3 * 128 * d * 2 + 4 * 2 * t.stream * d * 2 + 8 * 9 + 1024
    assert tattn.kernel_smem_bytes(d)["flash_bwd_dq"] == want
    assert want <= tattn.SMEM_LIMIT


def test_time_attention_needs_the_card():
    # The timing script measures the card only: without CUDA it exits 2
    # and prints no result.
    from ray_tpu_torch import time_attention

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour where CUDA is absent")
    assert time_attention.main(["--d", "64"]) == 2
