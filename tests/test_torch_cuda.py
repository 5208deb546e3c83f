"""The port's CUDA kernels against their plain PyTorch versions, Llama (its
GQA training backward too), the serving engine, RLlib's learner update and
V-trace, TorchPredictor against the CPU's, the accelerator registry's
name for the card, ring attention's mesh and chunk steps, the pipeline
stage trainer and GPipe, GPT-2's and MoE's mesh steps, the serving
engine at tp 2, a GPU actor's worker killed by the chaos plane whose
card goes to the next grant, and an ActorPool scorer granted the card and a
dynamic resource, on a card.

Needs a CUDA card, `nvcc` and no JAX:

    python -m pytest tests/test_torch_cuda.py -q

Every test marked `cuda` skips where CUDA is absent: the kernels have no
CPU mode. The last test checks the behaviour there.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as tattn


def _within(got, want, tol) -> bool:
    """|got - want| <= tol * (typical + |want|), element by element, as
    chip_smoke.py checks: typical is the rms of the element's row, and at
    least a tenth of the tensor's rms (a causal row's size follows its
    position; row 0 of dQ is 0 in exact arithmetic)."""
    g, w = got.float(), want.float()
    typical = torch.maximum(w.square().mean(dim=-1, keepdim=True).sqrt(),
                            w.square().mean().sqrt() / 10)
    return bool(((g - w).abs() <= tol * (typical + w.abs())).all())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,seq,d,bh", [
    (torch.float32, True, 256, 64, 3), (torch.float32, False, 200, 128, 3),
    (torch.bfloat16, True, 130, 32, 3), (torch.bfloat16, False, 1024, 64, 3),
    # Llama's head dim on the Hopper bodies (two 64-column TMA boxes a row).
    (torch.bfloat16, True, 1024, 128, 3),
    # A ragged last tile in several heads: a tensor map that ran across
    # heads would read the next head's rows there; at d 128 too (Llama's
    # head dim, two boxes a row).
    (torch.bfloat16, True, 200, 64, 6), (torch.bfloat16, True, 200, 128, 8),
    # float16 on the Hopper bodies, and d 192 and 256: all three kernels on
    # the Hopper bodies in 16 bits, on the 3xTF32 ones in float32.
    (torch.float16, True, 1024, 64, 3), (torch.float16, False, 200, 128, 3),
    (torch.float16, True, 130, 32, 3), (torch.bfloat16, True, 300, 192, 3),
    (torch.float16, True, 300, 256, 3), (torch.bfloat16, False, 256, 256, 2),
    (torch.float32, True, 200, 256, 2), (torch.float32, False, 130, 192, 2),
    # Above 256, d at run time, up to the largest head dim whose tiles fit
    # (1024 in 16 bits, 704 in float32): the Hopper bodies with d at run
    # time in 16 bits, the 3xTF32 ones in float32.
    (torch.bfloat16, True, 300, 384, 3), (torch.float16, False, 200, 384, 2),
    (torch.float32, True, 130, 384, 2), (torch.bfloat16, True, 77, 1024, 1),
    (torch.float32, False, 64, 704, 1)])
def test_kernels_match_plain_versions_on_card(card, dtype, causal, seq, d,
                                              bh):
    # float32: 3xTF32 products (about 2^-22 of each) and summation order
    # (1e-4 forward; 5e-4 gradients, which go through one more product
    # with cancelling terms, dP - delta); bf16 and float16: the kernels round P and dS to the
    # input type for the products (bf16 8 significant bits: 2e-2; float16
    # 11: 5e-3). delta is a float32 sum of the same products in both: 1e-4.
    tol = {torch.float32: (1e-4, 5e-4), torch.bfloat16: (2e-2, 2e-2),
           torch.float16: (5e-3, 5e-3)}[dtype]
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v, do = (torch.randn(bh, seq, d, generator=gen, device=card,
                               dtype=dtype) for _ in range(4))
    scale = d ** -0.5
    before = tattn.kernel_launches()
    out, lse = tattn._flash_forward(q, k, v, causal, scale)
    dq, delta_k = tattn._bwd_dq(q, k, v, do, out, lse, causal, scale)
    dk, dv = tattn._bwd_dkv(q, k, v, do, lse, delta_k, causal, scale)
    delta = tattn.bwd_delta(out, do)
    args = (q, k, v, do, lse, delta, causal, scale)
    got = [out, lse, dq, dk, dv, delta_k]
    want = [*tattn.flash_forward_reference(q, k, v, causal, scale),
            tattn.flash_bwd_dq_reference(*args),
            *tattn.flash_bwd_dkv_reference(*args), delta]
    tols = [tol[0], tol[0], tol[1], tol[1], tol[1], 1e-4]
    torch.cuda.synchronize()
    after = tattn.kernel_launches()
    assert all(after[name] == before[name] + 1 for name in after)
    for i, (a, b, t) in enumerate(zip(got, want, tols)):
        assert _within(a, b, t), i


# The backward pair's Hopper bodies at d 192 and 256 (dQ with O read from
# device memory; dK/dV with both warpgroups on one block's 64 keys):
# non-causal; ragged, the last streamed tile ending inside the head in
# several heads (seq 300 and 77); and enough heads that the blocks of
# several heads share the card at once (bh 40 at seq 512: 160 dQ and 320
# dK/dV blocks on 132 SMs).
@pytest.mark.cuda
@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal,seq,bh", [(False, 256, 3), (True, 300, 6),
                                           (True, 77, 5), (True, 512, 40)])
def test_backward_pair_at_head_dims_192_and_256_on_card(card, d, dtype,
                                                        causal, seq, bh):
    tol = {torch.bfloat16: 2e-2, torch.float16: 5e-3}[dtype]
    gen = torch.Generator(device=card).manual_seed(d + seq)
    q, k, v, do = (torch.randn(bh, seq, d, generator=gen, device=card,
                               dtype=dtype) for _ in range(4))
    scale = d ** -0.5
    assert all(not tattn.TILES[name, dtype][d].wide
               for name in ("flash_bwd_dq", "flash_bwd_dkv"))
    out, lse = tattn.flash_forward_reference(q, k, v, causal, scale)
    before = tattn.kernel_launches()
    dq, delta_k = tattn._bwd_dq(q, k, v, do, out, lse, causal, scale)
    dk, dv = tattn._bwd_dkv(q, k, v, do, lse, delta_k, causal, scale)
    torch.cuda.synchronize()
    after = tattn.kernel_launches()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    delta = tattn.bwd_delta(out, do)
    args = (q, k, v, do, lse, delta, causal, scale)
    want_dk, want_dv = tattn.flash_bwd_dkv_reference(*args)
    assert _within(delta_k, delta, 1e-4)
    assert _within(dq, tattn.flash_bwd_dq_reference(*args), tol)
    assert _within(dk, want_dk, tol) and _within(dv, want_dv, tol)


# The forward's Hopper body at d 192 and 256 (64-key tiles, K and V
# released apart, O as D / 2 floats a thread): non-causal, and ragged, the
# last streamed tile ending inside the head in several heads (seq 300 and
# 77).
@pytest.mark.cuda
@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal,seq,bh", [(False, 256, 3), (True, 300, 6),
                                           (True, 77, 5)])
def test_forward_at_head_dims_192_and_256_on_card(card, d, dtype, causal,
                                                  seq, bh):
    tol = {torch.bfloat16: 2e-2, torch.float16: 5e-3}[dtype]
    gen = torch.Generator(device=card).manual_seed(d + seq + 1)
    q, k, v = (torch.randn(bh, seq, d, generator=gen, device=card,
                           dtype=dtype) for _ in range(3))
    scale = d ** -0.5
    assert not tattn.TILES["flash_fwd", dtype][d].wide
    before = tattn.kernel_launches()["flash_fwd"]
    out, lse = tattn._flash_forward(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert tattn.kernel_launches()["flash_fwd"] == before + 1
    want_out, want_lse = tattn.flash_forward_reference(q, k, v, causal, scale)
    assert _within(out, want_out, tol)
    assert _within(lse, want_lse, 1e-4)


# The forward's Hopper body above d 256 (d at run time, O's columns split
# over the grid in chunks of 192 or 256): one or several chunks, the last
# running past d at 320 and 704; ragged, the last tile ending inside the
# head in several heads (seq 300 and 77); non-causal, and seq_q != seq_k.
@pytest.mark.cuda
@pytest.mark.parametrize("d", [320, 512, 704, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal,sq,sk,bh", [
    (True, 300, 300, 3), (True, 77, 77, 5), (False, 256, 256, 2),
    (False, 200, 333, 2)])
def test_wide_forward_on_card(card, d, dtype, causal, sq, sk, bh):
    tol = {torch.bfloat16: 2e-2, torch.float16: 5e-3}[dtype]
    gen = torch.Generator(device=card).manual_seed(d + sq + sk)
    q = torch.randn(bh, sq, d, generator=gen, device=card, dtype=dtype)
    k, v = (torch.randn(bh, sk, d, generator=gen, device=card, dtype=dtype)
            for _ in range(2))
    scale = d ** -0.5
    t = tattn.TILES["flash_fwd", dtype][d]
    assert t.wide and t.cols in (192, 256)
    before = tattn.kernel_launches()["flash_fwd"]
    out, lse = tattn._flash_forward(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert tattn.kernel_launches()["flash_fwd"] == before + 1
    want_out, want_lse = tattn.flash_forward_reference(q, k, v, causal, scale)
    assert _within(out, want_out, tol)
    assert _within(lse, want_lse, 1e-4)


# The backward pair's Hopper bodies above d 256 (d at run time, dQ's and
# dK's and dV's columns split over the grid in chunks of 192 or 256): one
# to four chunks, the last running past d at 320 and 704; ragged, the last
# tile ending inside the head in several heads (seq 300 and 77);
# non-causal, and seq_q != seq_k both ways. delta comes from every chunk's
# block alike and is written by chunk 0's.
@pytest.mark.cuda
@pytest.mark.parametrize("d", [320, 512, 704, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal,sq,sk,bh", [
    (True, 300, 300, 3), (True, 77, 77, 5), (False, 256, 256, 2),
    (False, 200, 333, 2), (False, 333, 200, 2)])
def test_wide_backward_on_card(card, d, dtype, causal, sq, sk, bh):
    tol = {torch.bfloat16: 2e-2, torch.float16: 5e-3}[dtype]
    gen = torch.Generator(device=card).manual_seed(d + sq + 2 * sk)
    q, do = (torch.randn(bh, sq, d, generator=gen, device=card, dtype=dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, sk, d, generator=gen, device=card, dtype=dtype)
            for _ in range(2))
    scale = d ** -0.5
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        t = tattn.TILES[name, dtype][d]
        assert t.wide and t.cols in (192, 256)
    out, lse = tattn.flash_forward_reference(q, k, v, causal, scale)
    before = tattn.kernel_launches()
    dq, delta_k = tattn._bwd_dq(q, k, v, do, out, lse, causal, scale)
    dk, dv = tattn._bwd_dkv(q, k, v, do, lse, delta_k, causal, scale)
    torch.cuda.synchronize()
    after = tattn.kernel_launches()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    delta = tattn.bwd_delta(out, do)
    args = (q, k, v, do, lse, delta, causal, scale)
    want_dk, want_dv = tattn.flash_bwd_dkv_reference(*args)
    assert _within(delta_k, delta, 1e-4)
    assert _within(dq, tattn.flash_bwd_dq_reference(*args), tol)
    assert _within(dk, want_dk, tol) and _within(dv, want_dv, tol)


# The float32 forward's 3xTF32 body (d at run time at every float32 head
# dim, O's columns split over the grid): d 32, 64, 192, 256, 320 and 704;
# ragged, the last tile ending inside the head in several heads (seq 77,
# 130 and 300); causal and not; seq_q != seq_k; grids of 2 to 15 row
# blocks, whose columns split into chunks of 64 to fill the card, and one
# of 320, which keeps the fewest chunks. Held to the float32 limit, 1e-4,
# on out and lse.
@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 192, 256, 320, 704])
@pytest.mark.parametrize("causal,sq,sk,bh", [
    (True, 300, 300, 3), (True, 77, 77, 5), (False, 130, 130, 2),
    (False, 200, 333, 2), (True, 1024, 1024, 40)])
def test_float32_forward_on_card(card, d, causal, sq, sk, bh):
    gen = torch.Generator(device=card).manual_seed(d + sq + 3 * sk)
    q = torch.randn(bh, sq, d, generator=gen, device=card)
    k, v = (torch.randn(bh, sk, d, generator=gen, device=card)
            for _ in range(2))
    scale = d ** -0.5
    t = tattn.TILES["flash_fwd", torch.float32][d]
    assert t.wide and t.cols == tattn.f32_cols("flash_fwd", d)
    before = tattn.kernel_launches()["flash_fwd"]
    out, lse = tattn._flash_forward(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert tattn.kernel_launches()["flash_fwd"] == before + 1
    want_out, want_lse = tattn.flash_forward_reference(q, k, v, causal, scale)
    assert _within(out, want_out, 1e-4)
    assert _within(lse, want_lse, 1e-4)


# The float32 backward pair's 3xTF32 bodies (d at run time at every
# float32 head dim, the gradients' columns split over the grid): d 32, 64,
# 192, 256, 320 and 704 (one to six column chunks, the last running past d
# at 320 and 704 in dQ); ragged, the last tile ending inside the head in
# several heads (seq 77, 130 and 300); causal and not; seq_q != seq_k both
# ways; grids of 2 to 15 row blocks, whose columns split into chunks of 64
# to fill the card, and one of 320 that keeps the fewest chunks. Held to
# the float32 limits, 5e-4 on dQ, dK and dV and 1e-4 on delta, with the
# plain forward's out and lse as inputs, against the plain versions in
# float64: at a causal row's first key dQ is all rounding (chip_smoke.py's
# run_plain says why float32 ones cannot judge it).
@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 192, 256, 320, 704])
@pytest.mark.parametrize("causal,sq,sk,bh", [
    (True, 300, 300, 3), (True, 77, 77, 5), (False, 130, 130, 2),
    (False, 200, 333, 2), (False, 333, 200, 2), (True, 1024, 1024, 40)])
def test_float32_backward_on_card(card, d, causal, sq, sk, bh):
    gen = torch.Generator(device=card).manual_seed(d + 2 * sq + 5 * sk)
    q, do = (torch.randn(bh, sq, d, generator=gen, device=card)
             for _ in range(2))
    k, v = (torch.randn(bh, sk, d, generator=gen, device=card)
            for _ in range(2))
    scale = d ** -0.5
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        t = tattn.TILES[name, torch.float32][d]
        assert t.wide and t.cols == tattn.f32_cols(name, d)
    out, lse = tattn.flash_forward_reference(q, k, v, causal, scale)
    before = tattn.kernel_launches()
    dq, delta_k = tattn._bwd_dq(q, k, v, do, out, lse, causal, scale)
    dk, dv = tattn._bwd_dkv(q, k, v, do, lse, delta_k, causal, scale)
    torch.cuda.synchronize()
    after = tattn.kernel_launches()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    q, k, v, do, out, lse = (t.double() for t in (q, k, v, do, out, lse))
    delta = tattn.bwd_delta(out, do)
    args = (q, k, v, do, lse, delta, causal, scale)
    want_dk, want_dv = tattn.flash_bwd_dkv_reference(*args)
    assert _within(delta_k, delta, 1e-4)
    assert _within(dq, tattn.flash_bwd_dq_reference(*args), 5e-4)
    assert _within(dk, want_dk, 5e-4) and _within(dv, want_dv, 5e-4)


# Autograd in float32 through the forward's lse: K2 and K3 recompute P
# from it, so a wrong lse shows in every gradient. Against plain
# attention, 1e-4 on the output and 5e-4 on the gradients.
@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 256, 704])
@pytest.mark.parametrize("causal", [True, False])
def test_float32_autograd_through_the_new_lse_on_card(card, d, causal):
    gen = torch.Generator(device=card).manual_seed(d + 7)
    q, k, v, g = (torch.randn(1, 3, 300, d, generator=gen, device=card)
                  for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tattn.kernel_launches()
    out = tattn.flash_attention(*leaves, causal)
    grads = torch.autograd.grad(out, leaves, g)
    assert tattn.kernel_launches() == {n: c + 1 for n, c in before.items()}
    ref = tattn.mha_reference(*ref_leaves, causal=causal)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g)
    assert _within(out, ref, 1e-4)
    for a, b in zip(grads, ref_grads):
        assert _within(a, b, 5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_on_card_matches_mha_reference(card, causal):
    # float32 throughout: summation order only (1e-4 forward, 5e-4 grads).
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v, g = (torch.randn(2, 2, 192, 64, generator=gen, device=card)
                  for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tattn.kernel_launches()
    out = tattn.flash_attention(*leaves, causal)
    grads = torch.autograd.grad(out, leaves, g)
    assert tattn.kernel_launches() == {n: c + 1 for n, c in before.items()}
    ref = tattn.mha_reference(*ref_leaves, causal=causal)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g)
    for a, b, tol in [(out, ref, 1e-4)] + [(x, y, 5e-4) for x, y in
                                           zip(grads, ref_grads)]:
        assert _within(a, b, tol)


# --------------------------------------------------------------------------- #
# Llama and the serving engine on the card
# --------------------------------------------------------------------------- #


def _tiny_llama(device, mesh=None, **changes):
    import dataclasses

    from ray_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(seq=256), **changes)
    return llama.Llama(cfg, device=device, seed=0, mesh=mesh)


@pytest.mark.cuda
def test_llama_forward_runs_the_flash_kernel_at_head_dim_128(card):
    # bf16, GQA 4:2 at d 128. Whole-model logits from two bf16 roundings
    # differ by more than the kernels' element-wise limit (chip_smoke.py,
    # MODEL_ERR_RATIO), so both are held against the same weights computing
    # in float32: the kernel's model no further from it than the plain one,
    # within a quarter.
    import dataclasses

    from ray_tpu_torch.models import llama

    flash = _tiny_llama(card, n_embd=512, use_flash=True)
    plain, exact = (llama.Llama(dataclasses.replace(flash.config, **changes),
                                device=card, state=flash.state_dict())
                    for changes in (dict(use_flash=False),
                                    dict(use_flash=False,
                                         dtype=torch.float32)))
    ids = torch.randint(0, 512, (2, 200), generator=torch.Generator(
        ).manual_seed(0)).to(card)
    before = tattn.kernel_launches()["flash_fwd"]
    with torch.no_grad():
        got, want, truth = flash(ids), plain(ids), exact(ids)
    torch.cuda.synchronize()
    assert tattn.kernel_launches()["flash_fwd"] == before + 2   # n_layer

    def rel_err(a):
        return ((a.float() - truth).square().mean().sqrt()
                / truth.square().mean().sqrt()).item()

    assert rel_err(got) <= 1.25 * rel_err(want), (rel_err(got),
                                                  rel_err(want))


@pytest.mark.cuda
@pytest.mark.parametrize("n_head,remat", [(4, False), (6, True)])
def test_llama_gqa_training_on_card_matches_plain_attention(card, n_head,
                                                            remat):
    # float32 at d 64 with 2 KV heads: the backward runs K2 and K3 at the
    # query heads' width and autograd sums dK/dV over each KV head's 2 or 3
    # query heads. Against plain attention on the same weights: summation
    # order only (1e-4 logits, 5e-4 gradients). Under remat each layer's
    # K1 runs twice.
    import dataclasses

    from ray_tpu_torch.models import gpt2, llama

    flash = _tiny_llama(card, n_embd=64 * n_head, n_head=n_head,
                        n_kv_head=2, dtype=torch.float32, use_flash=True,
                        remat=remat)
    plain = llama.Llama(
        dataclasses.replace(flash.config, use_flash=False, remat=False),
        device=card, state={name: t.clone()
                            for name, t in flash.state_dict().items()})
    ids = torch.randint(0, 512, (2, 256), generator=torch.Generator(
        ).manual_seed(1)).to(card)
    results = []
    for model in (flash, plain):
        before = tattn.kernel_launches()
        logits = model(ids)
        gpt2.next_token_loss(logits, ids).backward()
        torch.cuda.synchronize()
        after = tattn.kernel_launches()
        results.append((logits.detach(), [p.grad for p in model.parameters()],
                        {n: after[n] - before[n] for n in after}))
    (lf, gf, launches), (lp, gp, none) = results
    n = flash.config.n_layer
    assert launches == {"flash_fwd": n * (2 if remat else 1),
                        "flash_bwd_dq": n, "flash_bwd_dkv": n}
    assert none == dict.fromkeys(launches, 0)
    assert _within(lf, lp, 1e-4)
    for a, b in zip(gf, gp):
        assert _within(a, b, 5e-4)


@pytest.mark.cuda
def test_llama_paged_path_on_card_matches_dense(card):
    # float32 on the card: summation order only, 1e-4.
    from ray_tpu_torch.models import llama

    model = _tiny_llama(card, dtype=torch.float32)
    ids = torch.randint(0, 512, (2, 12), generator=torch.Generator(
        ).manual_seed(1)).to(card)
    cache = llama.make_cache(model.config, 2, 64, device=card)
    arena = llama.make_paged_arena(model.config, 16, 4, device=card)
    bt = torch.tensor([[3, 1, 6, 2, 0, 0], [7, 13, 8, 12, 0, 0]],
                      device=card)
    wm = torch.ones(2, 8, dtype=torch.bool, device=card)
    wm[:, 6:] = False                   # a padded chunk: pads go to trash
    pos = torch.zeros(2, dtype=torch.long, device=card)
    got, _ = model.decode_paged(ids[:, :8], arena, bt, pos, wm)
    want, _ = model.decode(ids[:, :6], cache, pos)
    assert _within(got[:, :6], want, 1e-4)
    one = torch.ones(2, 1, dtype=torch.bool, device=card)
    for t in range(6, 12):
        p = torch.full((2,), t, device=card)
        got, _ = model.decode_paged(ids[:, t:t + 1], arena, bt, p, one)
        want, _ = model.decode(ids[:, t:t + 1], cache, p)
        assert _within(got, want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("draft_len", [0, 2])
def test_engine_on_card_emits_the_cpu_engines_tokens(card, draft_len):
    # float32 on both devices, so the greedy tokens agree exactly.
    from ray_tpu_torch.inference import EngineConfig, InferenceEngine

    cpu_model = _tiny_llama("cpu", dtype=torch.float32)
    card_model = _tiny_llama(card, dtype=torch.float32)
    card_model.load_state_dict(cpu_model.state_dict())
    config = EngineConfig(batch_slots=3, block_size=4, num_blocks=64,
                          max_blocks_per_seq=16, prefill_chunk=8,
                          spec_decode_draft_len=draft_len)
    outs = []
    for model in (cpu_model, card_model):
        engine = InferenceEngine(config, model=model)
        reqs = [engine.add_request([1 + i, 2 + i, 3 + i] * (i + 1),
                                   max_new_tokens=6 + i) for i in range(5)]
        engine.run_until_idle()
        engine.check_no_leaks()
        assert engine.stats()["prefill_compiles"] == 1
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_fail_all_never_holds_two_arenas_on_card(card):
    # fail_all rebuilds the arenas: the old ones go before the new ones are
    # made, so device memory never holds both.
    from ray_tpu_torch.inference import EngineConfig, InferenceEngine

    engine = InferenceEngine(EngineConfig(block_size=4, num_blocks=64,
                                          max_blocks_per_seq=16,
                                          prefill_chunk=8,
                                          spec_decode_draft_len=2),
                             model=_tiny_llama(card))
    engine.add_request([1, 2, 3], 8)
    engine.step()
    arena_bytes = sum(t.numel() * t.element_size()
                      for arenas in (engine._arenas, engine._draft_arenas)
                      for pair in arenas for t in pair)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    assert engine.fail_all("injected") == 1
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() < before + arena_bytes / 2
    assert torch.cuda.memory_allocated() <= before
    engine.check_no_leaks()


def tp2_engine_on_card(rank):
    """A rank of the tiny engine at tp 2 on card 0 (two processes over
    gloo, as chip_smoke's phase 7c runs): rank 0 serves, then the same
    requests at tp 1; rank 1 follows. float32, so the tokens agree."""
    from ray_tpu_torch.inference import EngineConfig, InferenceEngine
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    torch.cuda.set_device(0)
    mesh = build_mesh(MeshSpec({"tp": 2}))
    config = EngineConfig(batch_slots=3, block_size=4, num_blocks=64,
                          max_blocks_per_seq=16, prefill_chunk=8)
    engine = InferenceEngine(config, model=_tiny_llama(
        "cuda", mesh=mesh, dtype=torch.float32), mesh=mesh)
    if rank == 1:
        engine.follow()
        return tuple(engine._arenas[0][0].shape)
    outs = []
    for eng in (engine, InferenceEngine(config, model=_tiny_llama(
            "cuda", dtype=torch.float32))):
        reqs = [eng.add_request([1 + i, 2 + i, 3 + i] * (i + 1),
                                max_new_tokens=6 + i) for i in range(5)]
        eng.run_until_idle()
        eng.check_no_leaks()
        assert eng.stats()["decode_compiles"] == 1
        outs.append([r.generated for r in reqs])
    engine.stop_followers()
    return outs


@pytest.mark.cuda
def test_tp2_engine_on_card_emits_the_tp1_engines_tokens(card):
    from gloo_ranks import GlooRanks

    pool = GlooRanks(2, timeout_s=300)
    try:
        (tp2, tp1), arena = pool.run(tp2_engine_on_card)
    finally:
        pool.close()
    assert tp2 == tp1
    assert arena[2] == _tiny_llama("cpu").config.n_kv_head // 2


def _ppo_image_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.integers(0, 256, (n, 42, 42, 4), dtype=np.uint8),
        "actions": rng.integers(0, 4, n),
        "logp": np.log(rng.uniform(0.2, 0.3, n)).astype(np.float32),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "vf_preds": rng.standard_normal(n).astype(np.float32),
        "value_targets": rng.standard_normal(n).astype(np.float32),
    }


@pytest.mark.cuda
def test_ppo_learner_update_on_card_matches_cpu(card):
    # The Nature CNN (42 px frames: the >= 40 px stack) in full float32 on
    # both sides (resolve_device turns TF32 off): the card's sums differ in
    # order only, 1e-4 relative on the loss, metrics and gradient norm.
    # Each parameter moves by about lr (3e-4) a step; the card's must land
    # within lr / 10 of the CPU's after two steps (a lost or doubled step
    # is 10x that).
    from ray_tpu_torch.rllib import ppo, rl_module

    module = rl_module.ConvPolicyModule(rl_module.SpecDict(42 * 42 * 4, 4,
                                                           (42, 42, 4)))
    cpu = ppo.PPOLearner(module, ppo.PPOConfig(device="cpu"))
    gpu = ppo.PPOLearner(module, ppo.PPOConfig())
    gpu.set_weights(cpu.get_weights())
    assert {p.device.type for p in gpu.net.parameters()} == {"cuda"}
    for seed in (0, 1):
        batch = _ppo_image_batch(128, seed)
        want, got = cpu.update(batch), gpu.update(batch)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * (abs(want[k]) + 1e-3), k
    w_cpu, w_gpu = cpu.get_weights(), gpu.get_weights()
    worst = max((w_gpu[k] - w_cpu[k]).abs().max().item() for k in w_cpu)
    assert worst <= 3e-4 / 10, worst


@pytest.mark.cuda
def test_vtrace_on_card_matches_cpu(card):
    # The same loop over T in both, elementwise float32: exp and the
    # products differ by an ulp or two, 1e-5 relative.
    from ray_tpu_torch.rllib.impala import vtrace_returns

    rng = np.random.default_rng(2)
    T, B = 50, 16
    dones = (rng.random((T, B)) < 0.05).astype(np.float32)
    args = dict(
        behavior_logp=np.log(rng.uniform(0.1, 0.9, (T, B))),
        target_logp=np.log(rng.uniform(0.1, 0.9, (T, B))),
        rewards=rng.standard_normal((T, B)), dones=dones,
        terminateds=dones * (rng.random((T, B)) < 0.5),
        values=rng.standard_normal((T, B)),
        next_values=rng.standard_normal((T, B)))
    outs = [vtrace_returns(**{k: torch.tensor(v, dtype=torch.float32,
                                              device=dev)
                              for k, v in args.items()}, gamma=0.99)
            for dev in ("cpu", card)]
    for want, got in zip(*outs):
        assert got.device.type == "cuda"
        got = got.cpu()
        assert torch.all((got - want).abs() <= 1e-5 * (want.abs() + 1)), \
            (got - want).abs().max()


@pytest.mark.cuda
def test_torch_predictor_on_card_matches_cpu(card, tmp_path):
    # A tiny GPT-2 in float32 scored by TorchPredictor on the card (flash
    # forward, TF32 off) and with device="cpu" (plain attention): the sums
    # differ in order only, 1e-4 on the logits as the CPU parity tests
    # hold them. The card's scoring launches K1 once a layer and no
    # backward kernel.
    import dataclasses
    import functools

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import Checkpoint, TorchPredictor

    cfg = dataclasses.replace(gpt2.GPT2Config.tiny(seq=128),
                              dtype=torch.float32)
    ckpt = Checkpoint.from_state_dict(
        gpt2.GPT2(cfg, device="cpu", seed=3).state_dict(),
        path=str(tmp_path / "ckpt"))
    spec = functools.partial(gpt2.GPT2, cfg)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 128),
                                            dtype=np.int64)
    want = TorchPredictor.from_checkpoint(
        ckpt, model=spec, input_column="ids",
        device="cpu").predict({"ids": ids})["predictions"]
    pred = TorchPredictor.from_checkpoint(ckpt, model=spec,
                                          input_column="ids")
    assert pred.device.type == "cuda"
    tattn.reset_kernel_launches()
    got = pred.predict({"ids": ids})["predictions"]
    assert tattn.kernel_launches() == {"flash_fwd": cfg.n_layer,
                                       "flash_bwd_dq": 0,
                                       "flash_bwd_dkv": 0}
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_detect_local_generation_names_the_card(card):
    """`util.accelerators.detect_local_generation()` names the generation of
    the card nvidia-smi lists first, as torch names it too."""
    import subprocess

    from ray_tpu_torch.util.accelerators import (GPU_GENERATIONS,
                                                 detect_local_generation,
                                                 generation_of)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    name = smi.strip().splitlines()[0]
    gen = detect_local_generation()
    assert gen is not None and gen == generation_of(name), name
    assert gen == generation_of(torch.cuda.get_device_name(0))
    major, minor = torch.cuda.get_device_capability(0)
    assert GPU_GENERATIONS[gen].compute_capability == (major, minor)


@pytest.fixture
def nccl_of_one(card):
    """A one-rank NCCL group in this process, left when the test ends."""
    import socket

    from ray_tpu_torch.parallel import distributed as tdist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = tdist.initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                       device="cuda")
    yield ctx
    tdist.shutdown_distributed()


@pytest.mark.cuda
def test_sp1_mesh_on_card_is_flash_attention_bit_equal(nccl_of_one):
    """An sp 1 DeviceMesh on the card over a one-rank NCCL group: the
    sharded ring is flash_attention, and a ring of one rank (no exchange)
    computes what it does, forward and backward, bit for bit."""
    from ray_tpu_torch.ops.ring_attention import (ring_attention,
                                                  ring_attention_sharded)
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    assert nccl_of_one.backend == "nccl"
    mesh = build_mesh(MeshSpec({"sp": 1}))
    assert mesh.device_type == "cuda" and mesh.mesh_dim_names == ("sp",)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, w = (torch.randn(2, 12, 256, 64, generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(4))

    def run(fn):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*x)
        out.backward(w)
        return [out.detach()] + [t.grad for t in x]

    want = run(lambda *x: tattn.flash_attention(*x, True))
    before = tattn.kernel_launches()
    for fn in (lambda *x: ring_attention_sharded(*x, mesh),
               lambda *x: ring_attention(*x)):
        assert all(torch.equal(g, t) for g, t in zip(run(fn), want))
    after = tattn.kernel_launches()
    assert {n: after[n] - before[n] for n in after} == dict.fromkeys(
        tattn.KERNELS, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_sp4_ring_steps_on_card_match_plain_float64(card, causal):
    """The 4 ranks of an sp 4 ring stepped in lockstep in this process
    (bf16, bh 4, seq 512, d 64: chunks of 128) against the plain versions
    over the whole sequence in float64 (the backward ones from the ring's
    out and lse), element by element within the bf16 kernels' 2e-2; each chunk on the kernels, 10 (causal) or 16 launches
    of each."""
    from test_torch_ring_attention import lockstep_ring

    sp, bh, s, d = 4, 4, 512, 64
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=card,
                               dtype=torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    before = tattn.kernel_launches()
    out, lse, dq, dk, dv = lockstep_ring(q, k, v, do, sp, causal, scale)
    after = tattn.kernel_launches()
    n = sp * (sp + 1) // 2 if causal else sp * sp
    assert {k_: after[k_] - before[k_] for k_ in after} == dict.fromkeys(
        tattn.KERNELS, n)
    wide = [t.double() for t in (q, k, v, do)]
    want_out, want_lse = tattn.flash_forward_reference(*wide[:3], causal,
                                                       scale)
    # The backward from the ring's own out and lse, as chip_smoke.py holds
    # the kernels: delta from a bf16 O carries O's rounding.
    delta = tattn.bwd_delta(out.double(), wide[3])
    want_dq = tattn.flash_bwd_dq_reference(*wide, lse.double(), delta,
                                           causal, scale)
    want_dk, want_dv = tattn.flash_bwd_dkv_reference(*wide, lse.double(),
                                                     delta, causal, scale)
    assert (lse.double() - want_lse).abs().max().item() < 1e-3
    for name, got, want in (("out", out, want_out), ("dq", dq, want_dq),
                            ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert got.dtype == torch.bfloat16
        assert _within(got, want, 2e-2), name


@pytest.mark.cuda
def test_pipeline_pp2_on_card_is_pp1_bitwise_and_counts_launches(card):
    """LocalPipelineTrainer in bf16 with the flash kernels, each stage on a
    thread and a stream of its own: pp 2 gives pp 1's losses and merged
    weights bit for bit, and each step launches K2 and K3 once a layer a
    microbatch and K1 m * (2 * n_layer - L_last) times (the first stage
    recomputes its forward in its backward)."""
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train.pipeline import (LocalPipelineTrainer,
                                              seeded_batch)

    cfg = LlamaConfig(vocab_size=512, n_positions=256, n_embd=256,
                      n_layer=4, n_head=4, n_kv_head=2, intermediate=512)
    m, runs = 2, {}
    for pp in (1, 2):
        t = LocalPipelineTrainer(cfg, pp=pp, num_microbatches=m, seed=0,
                                 batch=4, seq=256, device=card)
        losses, launches = [], []
        for step in range(2):
            ids, tg = seeded_batch(0, step, 4, 256, cfg.vocab_size)
            tattn.reset_kernel_launches()
            losses.append(t.train_step(ids, tg)["loss"])
            torch.cuda.synchronize()
            launches.append(tattn.kernel_launches())
        runs[pp] = (losses, t.merged_params(), launches)
        l_last = cfg.n_layer // pp
        want = {"flash_fwd": m * (2 * cfg.n_layer - l_last),
                "flash_bwd_dq": m * cfg.n_layer,
                "flash_bwd_dkv": m * cfg.n_layer}
        assert launches == [want, want], (pp, launches)
    assert runs[1][0] == runs[2][0]
    assert all(np.isfinite(runs[1][0]))
    assert all(torch.equal(runs[1][1][k], runs[2][1][k]) for k in runs[1][1])


@pytest.mark.cuda
def test_gpipe_pp1_mesh_on_card_is_sequential_forward(nccl_of_one):
    """GPipe over a pp 1 DeviceMesh on a one-rank NCCL group: the trunk
    bit-equal to the layers applied microbatch by microbatch, the forward
    within the reference's 1e-4 of sequential_forward over the whole batch
    (cuBLAS may split a float32 product's sum over k for one row count and
    not for the other); Adam steps lower the loss."""
    import functools

    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel import pipeline as gp

    mesh = build_mesh(MeshSpec({"pp": 1}))
    params = gp.init_pp_lm(0, 256, 64, 4, 4, 128, 64, 1, device="cuda")
    ids = torch.randint(0, 256, (8, 64), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    step, forward = gp.make_pp_train_step(
        mesh, 4, 4, functools.partial(torch.optim.Adam, lr=1e-2))
    with torch.no_grad():
        x_mb = gp.to_microbatches(params["embed"][ids] + params["pos"], 4)
        got = gp.gpipe(functools.partial(gp.block_apply, n_head=4), mesh,
                       4)(params["stages"], x_mb)
        layers = gp.unstack_stage_params(params["stages"])
        for j, h in enumerate(x_mb):
            for i in range(4):
                h = gp.block_apply({k: v[i] for k, v in layers.items()}, h,
                                   4)
            assert torch.equal(got[j], h)
        assert (forward(params, ids) - gp.sequential_forward(
            params, ids, 4)).abs().max() < 1e-4
    state, losses = None, []
    for _ in range(3):
        params, state, loss = step(params, state,
                                   {"input_ids": ids, "labels": ids})
        losses.append(loss.item())
    assert losses[-1] < losses[0]


@pytest.mark.cuda
def test_gpt2_mesh_step_on_card_matches_one_device(nccl_of_one):
    """chip_smoke.py phase 4i (a) at tiny width: GPT-2 on a (dp 1, fsdp 1,
    tp 1) DeviceMesh over a one-rank NCCL group (DTensor parameters,
    FSDP2, the vocab-parallel head and loss, all at size 1), bf16 on
    float32 parameters, 2 + 3 AdamW steps with the flash kernels: losses
    within phase 4g's 1e-3 relative of the same steps without a mesh,
    falling, K1, K2 and K3 once a layer a step."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import shard_batch

    mesh = build_mesh(MeshSpec({"dp": 1, "fsdp": 1, "tp": 1}))
    cfg = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=256,
                          n_layer=2, n_head=4)
    ids = torch.randint(0, cfg.vocab_size, (4, 128), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    batch = {"input_ids": ids, "labels": ids}
    losses = {}
    for name in ("mesh", "no_mesh"):
        if name == "mesh":
            model = gpt2.GPT2(cfg, mesh=mesh,
                              state=gpt2.init_sharded(cfg, mesh, seed=0))
            step = gpt2.make_train_step(model, gpt2.adamw(model), mesh=mesh)
            b = shard_batch(batch, mesh)
            assert type(model.wte).__name__ == "DTensor"
        else:
            model = gpt2.GPT2(cfg, device="cuda", seed=0)
            step = gpt2.make_train_step(model, gpt2.adamw(model))
            b = batch
        before = tattn.kernel_launches()
        losses[name] = [step(b).item() for _ in range(5)]
        after = tattn.kernel_launches()
        assert {k: after[k] - before[k] for k in after} == dict.fromkeys(
            tattn.KERNELS, 5 * cfg.n_layer)
    got, want = losses["mesh"], losses["no_mesh"]
    assert all(np.isfinite(got)) and got[-1] < got[0]
    assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) <= 1e-3


@pytest.mark.cuda
def test_moe_mesh_step_on_card_matches_one_device(nccl_of_one):
    """chip_smoke.py phase 4j at tiny width: MoE on a (dp 1, tp 1, ep 1)
    DeviceMesh over a one-rank NCCL group (the global queue's count
    gather, the experts' copy-in and reduce over ep and tp, the
    vocab-parallel head and loss, all at size 1), bf16 on float32
    parameters, the flash kernels, 3 AdamW steps from the weights of the
    plain `make_moe_train_step`: losses within 1e-3 relative of its, K1, K2
    and K3 once a layer a step."""
    import dataclasses

    from ray_tpu_torch.models import gpt2, moe
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import shard_batch

    mesh = build_mesh(MeshSpec({"dp": 1, "tp": 1, "ep": 1}))
    cfg = dataclasses.replace(moe.MoEConfig.tiny(seq=128), use_flash=True)
    ids = torch.randint(0, cfg.vocab_size, (4, 128), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    batch = {"input_ids": ids, "labels": ids}
    plain = moe.MoE(cfg, device="cuda", seed=0)
    state = {k: v.detach().clone() for k, v in plain.state_dict().items()}
    losses = {}
    for name in ("mesh", "no_mesh"):
        if name == "mesh":
            model = moe.MoE(cfg, mesh=mesh, state=state)
            step = moe.make_moe_train_step(model, gpt2.adamw(model),
                                           mesh=mesh)
            b = shard_batch(batch, mesh)
            assert type(model.embed).__name__ == "DTensor"
        else:
            model = plain
            step = moe.make_moe_train_step(model, gpt2.adamw(model))
            b = batch
        before = tattn.kernel_launches()
        losses[name] = [step(b).item() for _ in range(3)]
        after = tattn.kernel_launches()
        assert {k: after[k] - before[k] for k in after} == dict.fromkeys(
            tattn.KERNELS, 3 * cfg.n_layer)
    got, want = losses["mesh"], losses["no_mesh"]
    assert all(np.isfinite(got))
    assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) <= 1e-3


@pytest.mark.cuda
def test_sigkilled_gpu_actor_gives_the_card_to_the_next(card):
    """A GPU-granted actor's worker is SIGKILLed by the chaos plane's
    worker_kill; once its pid is gone, a second actor is granted the card
    in a fresh worker and allocates 1 GiB there."""
    import os
    import time

    import ray_tpu_torch as rt
    from ray_tpu_torch.chaos import (ChaosRunner, WorkerKillInjector,
                                     single_event_schedule)
    from ray_tpu_torch.cluster_utils import Cluster

    @rt.remote(num_gpus=1)
    class Holder:
        def hold(self, gib):
            import torch

            x = torch.ones(gib << 28, device="cuda")   # 4-byte elements
            torch.cuda.synchronize()
            return (os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES"),
                    x.numel() * 4 >> 30)

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    cluster.add_node(num_cpus=1, num_gpus=torch.cuda.device_count())
    cluster.wait_for_nodes()
    cluster.connect()
    try:
        first = Holder.remote()
        pid, cards, gib = rt.get(first.hold.remote(1), timeout=120)
        assert cards == "0" and gib == 1
        runner = ChaosRunner(
            cluster, single_event_schedule(5, "worker_kill", at_s=0.01),
            {"worker_kill": WorkerKillInjector(cluster, actors_only=True)},
            recovery_deadline_s=60)
        with runner:
            assert runner.wait(timeout=90)
        runner.assert_recovered()
        assert runner.records[0].detail == {"pid": pid, "actor": True}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                os.kill(pid, 0)
                time.sleep(0.05)
            except ProcessLookupError:
                break
        else:
            pytest.fail(f"the killed worker {pid} outlived 60 s")
        second = Holder.remote()
        pid2, cards2, gib2 = rt.get(second.hold.remote(1), timeout=120)
        assert pid2 != pid and cards2 == "0" and gib2 == 1
    finally:
        cluster.shutdown()


class _PoolScorer:
    """A GPU actor holding a tiny bf16 GPT-2 from seed 0: each batch's mean
    next-token NLLs, and its (index, mean) on a Queue."""

    def __init__(self, queue):
        from ray_tpu_torch.models import gpt2

        tattn.reset_kernel_launches()
        self.cfg = gpt2.GPT2Config.tiny(seq=256)
        self.model = gpt2.GPT2(self.cfg, device="cuda", seed=0)
        self.queue = queue

    def score(self, index, ids):
        nll = _mean_nll(self.model, torch.from_numpy(ids).cuda().long())
        self.queue.put((index, float(nll.double().mean())))
        return index, nll.numpy()

    def launches(self):
        import os

        return tattn.kernel_launches(), os.environ["CUDA_VISIBLE_DEVICES"]


def _mean_nll(model, ids):
    with torch.no_grad():
        logits = model(ids)[:, :-1].float()
        tgt = torch.gather(logits, -1, ids[:, 1:, None]).squeeze(-1)
        return (torch.logsumexp(logits, -1) - tgt).mean(-1).cpu()


@pytest.mark.cuda
def test_actor_pool_scorer_on_card_is_the_driver_bitwise(card):
    """chip_smoke's phase 4l at a small size: an actor granted the card and
    a dynamic resource scores batches through an ActorPool, a Queue
    carries its records; its scores equal this process's on the card bit
    for bit, and K1 launches once a layer a batch in the actor."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import experimental
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.util.actor_pool import ActorPool
    from ray_tpu_torch.util.queue import Queue

    rt.init(num_cpus=2)
    try:
        experimental.set_resource("scorer", 1)
        queue = Queue()
        actor = rt.remote(num_gpus=1, resources={"scorer": 1})(
            _PoolScorer).remote(queue)
        ids = np.random.default_rng(0).integers(0, 512, (16, 256),
                                                dtype=np.int32)
        batches = [(i, ids[4 * i:4 * i + 4]) for i in range(4)]
        out = list(ActorPool([actor]).map(lambda a, b: a.score.remote(*b),
                                          batches))
        records = sorted(queue.get(timeout=30) for _ in batches)
        launches, cards = rt.get(actor.launches.remote())
        model = gpt2.GPT2(gpt2.GPT2Config.tiny(seq=256), device="cuda",
                          seed=0)
        want = [_mean_nll(model, torch.from_numpy(b).cuda().long()).numpy()
                for _, b in batches]
        assert [i for i, _ in out] == [0, 1, 2, 3] and cards == "0"
        for (_, got), w in zip(out, want):
            assert np.array_equal(got, w)
        assert records == [(i, float(torch.from_numpy(w).double().mean()))
                           for i, w in enumerate(want)]
        assert launches == {"flash_fwd": 4 * model.config.n_layer,
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    finally:
        rt.shutdown()


def test_engine_defaults_to_the_card():
    # Runs where CUDA is absent: the engine never drops to the CPU alone.
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour where CUDA is absent")
    from ray_tpu_torch.inference import EngineConfig, InferenceEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(EngineConfig())
