"""The port's CUDA kernels against their plain PyTorch versions, and Llama
(its GQA training backward too) and the serving engine, on a card.

Needs a CUDA card, `nvcc` and no JAX:

    python -m pytest tests/test_torch_cuda.py -q

Every test marked `cuda` skips where CUDA is absent: the kernels have no
CPU mode. The last test checks the behaviour there.
"""

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
    # float16 on the Hopper bodies, and d 192 and 256 on the CUDA-core
    # bodies in every type (two warps a key row in dK/dV, ragged tiles).
    (torch.float16, True, 1024, 64, 3), (torch.float16, False, 200, 128, 3),
    (torch.float16, True, 130, 32, 3), (torch.bfloat16, True, 300, 192, 3),
    (torch.float16, True, 300, 256, 3), (torch.bfloat16, False, 256, 256, 2),
    (torch.float32, True, 200, 256, 2), (torch.float32, False, 130, 192, 2),
    # Above 256 the wide bodies, d at run time, in every type, up to the
    # largest head dim whose tiles fit (1024 in 16 bits, 704 in float32).
    (torch.bfloat16, True, 300, 384, 3), (torch.float16, False, 200, 384, 2),
    (torch.float32, True, 130, 384, 2), (torch.bfloat16, True, 77, 1024, 1),
    (torch.float32, False, 64, 704, 1)])
def test_kernels_match_plain_versions_on_card(card, dtype, causal, seq, d,
                                              bh):
    # float32: summation order only (1e-4 forward, 5e-4 gradients); bf16
    # and float16: the kernels round P and dS to the input type for the
    # products (bf16 8 significant bits: 2e-2; float16 11: 5e-3). delta is
    # a float32 sum of the same products in both: 1e-4.
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


def _tiny_llama(device, **changes):
    import dataclasses

    from ray_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(seq=256), **changes)
    return llama.Llama(cfg, device=device, seed=0)


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


def test_engine_defaults_to_the_card():
    # Runs where CUDA is absent: the engine never drops to the CPU alone.
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour where CUDA is absent")
    from ray_tpu_torch.inference import EngineConfig, InferenceEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(EngineConfig())
