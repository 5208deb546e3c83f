"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs a CUDA card, `nvcc` and no JAX:

    python -m pytest tests/test_torch_cuda.py -q

Every test here skips where CUDA is absent: the kernels have no CPU mode.
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
    # heads would read the next head's rows there.
    (torch.bfloat16, True, 200, 64, 6)])
def test_kernels_match_plain_versions_on_card(card, dtype, causal, seq, d,
                                              bh):
    # float32: summation order only (1e-4 forward, 5e-4 gradients); bf16:
    # the kernels round P and dS to bf16 for the tensor cores (2e-2). delta
    # is a float32 sum of the same products in both: 1e-4.
    tol = {torch.float32: (1e-4, 5e-4), torch.bfloat16: (2e-2, 2e-2)}[dtype]
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
