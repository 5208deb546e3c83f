#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an H100.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and `nvidia-smi`; exits non-zero on the first
failed phase, with no phase caught.

1. Device and build: prints the card's name and power limit, builds the
   CUDA kernels of `ray_tpu_torch/csrc/`, prints the build time and each
   kernel's registers and spills, and checks that the shared memory each C
   entry point asks for is what `attention.kernel_smem_bytes` computes
   from the tile table.
2. Kernels: holds each kernel (flash forward, dQ with the delta it writes,
   dK/dV reading that delta) against its plain PyTorch version on the
   card, at GPT-2-small's attention shape (bf16, causal and not), at
   Llama's head dim 128 (bf16), on a ragged bf16 case whose last tile ends
   inside the head in several heads, on small float32 and ragged cases, at
   seq 8192 (bh 4) and at the attention shapes of phases 10 and 11 (bh 96
   and 64, seq 2048, d 64, bf16, causal), element by element, printing
   each error beside its limit; shows
   that the same check rejects planted faults (a skipped tile, P left
   unnormalised, delta left at 0, each sized from the kernel's own tiles)
   at the main shape; times each kernel, its plain version and
   `scaled_dot_product_attention` (a yardstick the port never calls),
   forward and backward alone.
3. Model check: a small GPT-2 with the flash kernels against the same model
   with plain attention, logits and gradients, on the card.
4. Main path: `TorchTrainer(...).fit()` trains GPT-2-small at full width
   (12 layers, 768 wide, 12 heads, vocab 50304, seq 1024, batch 24, bf16)
   for 2 warm-up and 10 timed steps; the loss must be finite and fall, and
   each step must launch each kernel once per layer.
6. Llama-7B forward: `LlamaConfig.llama7b()` at full width and depth
   (5,933,109,248 float32 parameters from seed 0, bf16 compute), batch 1,
   seq 2048, through the flash kernel, through plain attention and in
   float32 with the same weights; the kernel's logits must be no further
   from the float32 ones than plain attention's (`MODEL_ERR_RATIO`), and K1
   launched once per layer. Holds K1 alone at that shape (bh 32, seq 2048,
   d 128, causal) against its plain version element by element and times
   it beside its bound and `scaled_dot_product_attention`'s forward.
7. Llama-7B serving: `InferenceEngine` on the same model (8 slots, blocks of
   16, 2,048-token context, a 2 GiB arena, chunks of 512, prefix cache on)
   serves 16 requests from seed 0 (prompts of 256-1024 tokens, 8 sharing a
   512-token prefix, 128 new tokens each, all submitted at once). Checks
   that every request gets its tokens, no block leaks, each program saw one
   shape and the prefix cache hit; prints prefill and decode tokens/s, TTFT
   p50/p99, ms per decode step at 8 busy slots, peak memory, and how far 2
   requests follow a bf16 dense-cache loop. Then a speculative leg on the
   same model (draft length 4, the 16-layer truncated draft, 4 requests of
   64 tokens): no leaks, one shape per program, its accept rate. Last, on
   the same weights computing in float32, the engine's tokens (2 requests
   of 128 and 2 of 64) against a dense-cache greedy loop through
   `Llama.decode`, and the speculative engine's against the plain one's,
   each up to the reference's first near tie.
8. Long context (`bench.py` bench_gpt2_long's first rung): `TorchTrainer.
   fit` trains GPT-2-small at full width and depth at seq 8192 with
   per-block remat, batch 4, for 2 warm-up and 5 timed steps; the loss must
   be finite and fall, and each step launch K1 24 times (12 forwards, 12
   recomputes), K2 and K3 12 times. Then runs K1, K2 and K3 at the leg's
   attention shape (bh 48, seq 8192, d 64, bf16, causal), holds them
   element by element against their plain versions four heads at a time,
   and times them beside their bounds and `scaled_dot_product_attention`'s
   forward and forward + backward. Last, the leg's model at batch 1
   through 3 AdamW steps with the kernels and with plain attention: in
   float32 the losses and first-step gradients agree within the float32
   kernels' limits; in bf16 the losses within 2e-2 and the gradients no
   further from the float32 model's than plain attention's.
9. Remat on the card: the phase-3 GPT-2 in float32 with remat on and off,
   with dropout 0 and 0.1 (the checkpoint restores the generators, so the
   recompute draws the same masks): the loss and every gradient must agree
   within the float32 kernels' 5e-4, and remat launch K1 twice a layer.
   Prints whether the two are bit-equal.
10. Llama-small training (`LlamaConfig.small()`, GQA 12/4 heads):
   `TorchTrainer.fit`, batch 8, seq 2048, 2 + 10 steps; falling loss, K1,
   K2 and K3 12 times a step.
11. MoE-small training (`MoEConfig.small()`, 8 experts, top-2, capacity
   1.25): `TorchTrainer.fit` with `make_moe_train_step`, batch 4, seq
   2048, 2 + 5 steps; falling cross-entropy, a finite router loss, K1, K2
   and K3 8 times a step; prints layer 0's slots used per expert and the
   share of routing choices dropped at capacity in the last step.
12. Results (phase 5 before phases 6 and 7 came): prints the serving and
   training numbers, the `{"kernels": [...]}` line (launches summed over
   the paths of phases 4, 6, 7, 8, 10 and 11; each record also holds its
   time at the long-context shape under `gpt2_long`, and K1's at the
   Llama-7B shape under `llama7b_prefill`), then the device line last.

Each phase frees what it allocated before the next starts.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor cores
              torch.float32: 67e12}     # CUDA cores, no TF32

# Tolerances, element by element: |kernel - plain| <= tol * (typical +
# |plain|), where typical is the rms of the plain tensor's row (see
# `mismatch`). The rms term stands in for an absolute tolerance, so elements
# near zero are held to a share of their row's size, not of the largest
# value. It is taken per row because a row's size follows its position: row
# i of the causal output averages i + 1 values, so early rows of dQ are ~30x
# the late ones, and one rms for the tensor would be too tight for the early
# rows and too loose for the late ones. Its floor, a tenth of the tensor's
# rms, holds a row that is 0 in exact arithmetic (row 0 of dQ, where dP and
# delta cancel) to float32 noise rather than to 0.
# bf16: the kernels round P and dS to bf16 (8 significant bits, up to 2^-9
# relative) to feed the tensor cores where the plain version keeps float32;
# that error is random across a row's terms and a small share of the row's
# size. Both round the result once to bf16, so they may differ by one ulp,
# up to 2^-7 of |plain|. 2e-2 covers both with room.
# float32: both run in float32 and differ only in summation order over up
# to 1024 terms: 1e-4 for the forward; the gradients go through one more
# product with cancelling terms (dP - delta), so 5e-4.
TOL = {(torch.bfloat16, "fwd"): 2e-2, (torch.bfloat16, "bwd"): 2e-2,
       (torch.float32, "fwd"): 1e-4, (torch.float32, "bwd"): 5e-4}

MAIN = dict(bh=24 * 12, seq=1024, d=64, dtype=torch.bfloat16, causal=True)
CASES = [
    MAIN,
    dict(MAIN, causal=False),
    dict(bh=64, seq=1024, d=128, dtype=torch.bfloat16, causal=True),
    dict(bh=6, seq=200, d=64, dtype=torch.bfloat16, causal=True),
    dict(bh=4, seq=256, d=64, dtype=torch.float32, causal=True),
    dict(bh=3, seq=200, d=128, dtype=torch.float32, causal=False),
    dict(bh=5, seq=130, d=32, dtype=torch.bfloat16, causal=True),
    # The long-context length (phase 8), at bh 4: the plain version's
    # float32 scores take bh x 8192^2 x 4 bytes, 1 GiB here. Phase 8 holds
    # the kernels at the leg's bh 48 four heads at a time.
    dict(bh=4, seq=8192, d=64, dtype=torch.bfloat16, causal=True),
    # The attention shapes of phases 10 and 11: Llama-small at batch 8 x 12
    # heads and MoE-small at batch 4 x 16 heads (after the GQA repeat); the
    # plain scores take 1.5 and 1 GiB.
    dict(bh=96, seq=2048, d=64, dtype=torch.bfloat16, causal=True),
    dict(bh=64, seq=2048, d=64, dtype=torch.bfloat16, causal=True),
]
# (kernel, output, tolerance) of each output held against its plain
# version; delta is a float32 sum in both, held to the float32 forward's.
OUTPUTS = [("flash_fwd", "out", "fwd"), ("flash_fwd", "lse", "fwd"),
           ("flash_bwd_dq", "dq", "bwd"), ("flash_bwd_dq", "delta", "delta"),
           ("flash_bwd_dkv", "dk", "bwd"), ("flash_bwd_dkv", "dv", "bwd")]
# Phase 8's attention shape: batch 4 x GPT-2-small's 12 heads, held against
# the plain version LONG_CHUNK heads at a time.
LONG_BATCH, LONG_CHUNK = 4, 4
LONG_SHAPE = dict(bh=LONG_BATCH * 12, seq=8192, d=64, dtype=torch.bfloat16,
                  causal=True)
# Phase 8's model check: the leg's GPT-2 at batch 1 (plain float32
# attention keeps [12, 8192, 8192] float32 scores, 3 GiB, a layer), through
# this many AdamW steps.
LONG_CHECK_BATCH, LONG_CHECK_STEPS = 1, 3
REPLACES = {
    "flash_fwd": "ray_tpu/ops/attention.py:60",
    "flash_bwd_dq": "ray_tpu/ops/attention.py:173",
    "flash_bwd_dkv": "ray_tpu/ops/attention.py:220",
}
SOURCES = {
    "flash_fwd": "ray_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "ray_tpu_torch/csrc/flash_bwd.cu",
    "flash_bwd_dkv": "ray_tpu_torch/csrc/flash_bwd.cu",
}
BATCH = 24  # phase 4's batch; MAIN is its attention shape
LLAMA_SEQ = 2048                 # phase 6: Llama-7B prefill, batch 1
# Phase 7: the serving configuration. 8 x 128 blocks of 16 tokens, plus the
# trash block: every slot can hold a full 2,048-token context at once.
SERVE = dict(model_size="7b", batch_slots=8, block_size=16,
             max_blocks_per_seq=128, num_blocks=8 * 128 + 1,
             prefill_chunk=512)
N_REQUESTS, NEW_TOKENS, SHARED_PREFIX = 16, 128, 512
PROMPT_LEN = (256, 1024)
N_COMPARED = 2                   # requests held against the dense loop
SPEC_DRAFT_LEN, SPEC_REQUESTS, SPEC_TOKENS = 4, 4, 64
# Near-tie rule: greedy tokens are compared up to the first step where the
# reference's top-2 logit gap is below this share of the logit row's rms
# (sums in another order may pick either side of such a tie). It holds the
# engine in float32, where the two sides differ only in summation order.
NEAR_TIE = 2e-2
# Phase 6 holds whole-model logits, 32 bf16 layers deep, against the same
# weights computing in float32: a bf16 model sits ~1.4% (rms) from it after
# 8 layers, and element by element its logits differ from another bf16
# rounding of the same model by 3x the kernels' 2e-2 limit (both measured on
# the CPU, PERF.md). So the kernel's model must be no further from the
# float32 one than the plain-attention model is, within a quarter; the
# kernel itself is held element by element at that shape after.
MODEL_ERR_RATIO = 1.25


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over `rounds` of the mean time of `reps` back-to-back calls,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def mismatch(got, want, tol: float) -> float:
    """max |got - want| / (tol * (typical + |want|)), element by element:
    the check holds at <= 1. `typical` is the rms of the element's row (its
    last dimension), and at least a tenth of the whole tensor's rms."""
    g, w = got.float(), want.float()
    typical = torch.maximum(w.square().mean(dim=-1, keepdim=True).sqrt(),
                            w.square().mean().sqrt() / 10)
    limit = tol * (typical + w.abs())
    return ((g - w).abs() / limit.clamp_min(1e-30)).max().item()


def rel_err(got, want) -> float:
    """rms(got - want) / rms(want), in float32."""
    g, w = got.float(), want.float()
    return ((g - w).square().mean().sqrt()
            / w.square().mean().sqrt()).item()


def bound(case, n_products: int, tensors):
    """(ms, "bytes" or "operations"): the least time for the work, the
    larger of the bytes of every input read once and every output written
    once over the HBM rate, and the products' FLOPs over the peak rate of
    the type, counting only the (q, k) pairs the mask keeps."""
    s = case["seq"]
    pairs = s * (s + 1) // 2 if case["causal"] else s * s
    flops = 2.0 * case["bh"] * pairs * case["d"] * n_products
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    byte_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    op_ms = 1e3 * flops / PEAK_FLOPS[case["dtype"]]
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def ptxas_usage(log: str):
    """(kernel, registers, spill line) for each kernel in `nvcc -Xptxas -v`
    output; the kernel is named with its template arguments, read from the
    mangled name (e.g. `bwd_dq_kernel<bf16, 64>`)."""
    import re

    types = {"": "", "f": "float, ", "13__nv_bfloat16": "bf16, "}
    out, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"entry function '_Z\d+(\w+?)I(\w*?)Li(\d+)EEv", line)
        if m:
            fn = f"{m[1]}<{types[m[2]]}{m[3]}>"
        elif "spill" in line:
            spill = line.strip()
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out.append((fn, int(m[1]), spill))
            fn = None
    return out


def check_smem(attn, build) -> None:
    """The shared memory each C entry point asks for must be what the tile
    table gives (`attention.kernel_smem_bytes`)."""
    fwd, bwd = build.load("flash_fwd.cu"), build.load("flash_bwd.cu")
    for d in attn.HEAD_DIMS:
        for dtype, code in attn._DTYPE_CODES.items():
            got = {"flash_fwd": fwd.flash_fwd_smem(d, code),
                   "flash_bwd_dq": bwd.flash_bwd_smem(0, d, code),
                   "flash_bwd_dkv": bwd.flash_bwd_smem(1, d, code)}
            want = attn.kernel_smem_bytes(d, dtype)
            if got != want:
                raise AssertionError(f"shared memory at d={d} {dtype}: the "
                                     f"kernels ask for {got}, the tile table "
                                     f"gives {want}")
    largest = max(max(attn.kernel_smem_bytes(d, t).values())
                  for d in attn.HEAD_DIMS for t in attn._DTYPE_CODES)
    print(f"  shared memory of every kernel, dtype and head dim matches the "
          f"tile table (largest {largest} B)")


def run_kernels(attn, q, k, v, do, causal: bool, scale: float) -> dict:
    """K1, then K2 writing delta, then K3 reading it, as on the main path."""
    out, lse = attn._flash_forward(q, k, v, causal, scale)
    dq, delta = attn._bwd_dq(q, k, v, do, out, lse, causal, scale)
    dk, dv = attn._bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return {"out": out, "lse": lse, "dq": dq, "delta": delta, "dk": dk,
            "dv": dv}


def run_plain(attn, q, k, v, do, got, causal: bool, scale: float) -> dict:
    """The plain versions on the same inputs; the backward ones take the
    kernel's out and lse, as K2 and K3 do."""
    out, lse = attn.flash_forward_reference(q, k, v, causal, scale)
    delta = attn.bwd_delta(got["out"], do)
    dq = attn.flash_bwd_dq_reference(q, k, v, do, got["lse"], delta, causal,
                                     scale)
    dk, dv = attn.flash_bwd_dkv_reference(q, k, v, do, got["lse"], delta,
                                          causal, scale)
    return {"out": out, "lse": lse, "dq": dq, "delta": delta, "dk": dk,
            "dv": dv}


def compare(got, want, dtype) -> dict:
    """(kernel, output) -> (mismatch, max abs error, tol) for OUTPUTS."""
    res = {}
    for name, what, kind in OUTPUTS:
        tol = (TOL[torch.float32, "fwd"] if kind == "delta"
               else TOL[dtype, kind])
        res[name, what] = (mismatch(got[what], want[what], tol),
                           max_err(got[what], want[what]), tol)
    return res


def worst(values) -> float:
    """The largest value, NaN above all."""
    return max(values, key=lambda x: math.inf if math.isnan(x) else x)


def report(res, label: str) -> dict:
    """Prints each output's error beside its limit and raises on the first
    above it. Returns kernel -> (worst mismatch, worst abs error)."""
    errs = {}
    for (name, what), (ratio, abs_err, tol) in res.items():
        ok = math.isfinite(ratio) and ratio <= 1.0
        print(f"  {name:14s} {what:5s} {label}: max_abs_err={abs_err:.3e}"
              f" mismatch={ratio:.4f} of its limit (tol={tol:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} ({what}) disagrees with its "
                                 f"plain version at {label}")
        w = errs.get(name, (0.0, 0.0))
        errs[name] = (max(w[0], ratio), max(w[1], abs_err))
    return errs


def check_kernels(attn) -> dict:
    """Phase 2. Returns the main-shape record of each kernel."""
    records = {}
    for i, case in enumerate(CASES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        shape = (case["bh"], case["seq"], case["d"])

        def randn():
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=case["dtype"])

        q, k, v, do = randn(), randn(), randn(), randn()
        causal, scale = case["causal"], 1.0 / math.sqrt(case["d"])
        got = run_kernels(attn, q, k, v, do, causal, scale)
        want = run_plain(attn, q, k, v, do, got, causal, scale)
        torch.cuda.synchronize()
        label = (f"bh={case['bh']} seq={case['seq']} d={case['d']} "
                 f"{str(case['dtype']).split('.')[-1]} causal={causal}")
        errs = report(compare(got, want, case["dtype"]), label)
        if case is not MAIN:
            continue
        check_planted_faults(attn, q, k, v, do, got["lse"], want["delta"],
                             scale, got, want, errs)
        out, lse, dq, delta_k, dk, dv = (got[key] for key in (
            "out", "lse", "dq", "delta", "dk", "dv"))
        delta = want["delta"]
        lib_fwd = _sdpa(q, k, v, causal, scale, "forward")
        lib_bwd = _sdpa(q, k, v, causal, scale, "backward")
        lib_fwd_bwd = _sdpa(q, k, v, causal, scale, "both")
        timings = {
            "flash_fwd": (
                lambda: attn._flash_forward(q, k, v, causal, scale),
                lambda: attn.flash_forward_reference(q, k, v, causal, scale),
                2, [q, k, v, out, lse], lib_fwd),
            # K2's plain version includes delta, which the kernel computes.
            "flash_bwd_dq": (
                lambda: attn._bwd_dq(q, k, v, do, out, lse, causal, scale),
                lambda: attn.flash_bwd_dq_reference(
                    q, k, v, do, lse, attn.bwd_delta(out, do), causal, scale),
                3, [q, k, v, do, out, lse, dq, delta_k], None),
            "flash_bwd_dkv": (
                lambda: attn._bwd_dkv(q, k, v, do, lse, delta_k, causal,
                                      scale),
                lambda: attn.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                     causal, scale),
                4, [q, k, v, do, lse, delta_k, dk, dv], None),
        }
        for name, (kern, plain, n_prod, tensors, lib_ms) in timings.items():
            b_ms, b_by = bound(case, n_prod, tensors)
            records[name] = b = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": None,
                "max_abs_err": errs[name][1], "ms": time_ms(kern),
                "plain_ms": time_ms(plain, reps=3, rounds=3),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            }
            print(f"  {name:14s} main shape: {b['ms']:.4f} ms, plain "
                  f"{b['plain_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']}), library {lib_ms}")
        # The plain delta is on no card path now; timed for comparison with
        # the backward before K2 computed it.
        delta_ms = time_ms(lambda: attn.bwd_delta(out, do))
        bwd = records["flash_bwd_dq"]["ms"] + records["flash_bwd_dkv"]["ms"]
        print(f"  attention backward at the main shape: K2 (with delta) + K3 "
              f"{bwd:.4f} ms, scaled_dot_product_attention backward "
              f"{lib_bwd:.4f} ms (plain delta alone {delta_ms:.4f} ms)")
        print(f"  attention fwd+bwd at the main shape: kernels "
              f"{records['flash_fwd']['ms'] + bwd:.4f} ms, "
              f"scaled_dot_product_attention {lib_fwd_bwd:.4f} ms")
    return records


def check_planted_faults(attn, q, k, v, do, lse, delta, scale, got, want,
                         errs) -> None:
    """The checks above must reject a kernel that is wrong in a small part
    of its output. At the main shape (causal), this plants into the
    kernel's own result the rows that a tiled kernel with one of these
    faults would give, computed by the plain math with the fault, and
    requires a mismatch above 1 for each. Each fault is one of the kernel's
    own tiles (`attention.TILES`):
      - forward, the last q-block skips one K/V tile in the middle;
      - forward, the last q-block leaves P unnormalised (acc, not acc / l);
      - dQ, the last q-block skips one K/V tile in the middle;
      - delta, the last q-block leaves its rows at 0;
      - dK and dV, the first key block skips one Q/dO tile in the middle.
    The last q-block averages the most keys, and the first key block takes
    rows from every q-block, so one tile is the smallest share there."""
    s, d = q.shape[1], q.shape[2]
    fwd, dq_t, dkv = (attn.TILES[name, q.dtype][d] for name in attn.KERNELS)
    tol_f, tol_b = TOL[q.dtype, "fwd"], TOL[q.dtype, "bwd"]
    tol_d = TOL[torch.float32, "fwd"]

    def mid(n):  # the tile of n rows that ends at the middle
        return slice(s // 2 - n, s // 2)

    def planted(t, rows, value):
        t = t.clone()
        t[:, rows] = value
        return t

    def last_rows_forward(rows, drop, normalise):
        sc = torch.matmul(q[:, rows].float(), k.float().transpose(1, 2))
        keep = (torch.arange(s, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[rows][:, None])
        keep[:, drop] = False
        sc = (sc * scale).masked_fill(~keep, float("-inf"))
        p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        o = torch.matmul(p, v.float())
        return (o / p.sum(dim=-1, keepdim=True) if normalise else o
                ).to(q.dtype)

    # Keys whose k and v are 0 add nothing to dQ (dS * k = 0); queries whose
    # dO and delta are 0 add nothing to dK and dV (dS = 0, P^T dO = 0).
    last_f, last_q = slice(s - fwd.rows, s), slice(s - dq_t.rows, s)
    first_k = slice(0, dkv.rows)
    drop_f, drop_q = mid(fwd.stream), mid(dq_t.stream)
    drop_k = slice(s // 2, s // 2 + dkv.stream)
    dq_drop = attn.flash_bwd_dq_reference(
        q, planted(k, drop_q, 0), planted(v, drop_q, 0), do, lse, delta, True,
        scale)
    dk_drop, dv_drop = attn.flash_bwd_dkv_reference(
        q, k, v, planted(do, drop_k, 0), lse, planted(delta, drop_k, 0), True,
        scale)

    def rows(r):
        return f"{r.start}..{r.stop - 1}"

    faults = [
        ("flash_fwd", f"out: last q-block skips keys {rows(drop_f)}", "out",
         tol_f, planted(got["out"], last_f,
                        last_rows_forward(last_f, drop_f, True))),
        ("flash_fwd", "out: last q-block leaves P unnormalised", "out", tol_f,
         planted(got["out"], last_f,
                 last_rows_forward(last_f, slice(0, 0), False))),
        ("flash_bwd_dq", f"dQ: last q-block skips keys {rows(drop_q)}", "dq",
         tol_b, planted(got["dq"], last_q, dq_drop[:, last_q])),
        ("flash_bwd_dq", f"delta: last q-block's rows {rows(last_q)} left "
         "at 0", "delta", tol_d, planted(got["delta"], last_q, 0)),
        ("flash_bwd_dkv", f"dK: first key block skips queries "
         f"{rows(drop_k)}", "dk", tol_b,
         planted(got["dk"], first_k, dk_drop[:, first_k])),
        ("flash_bwd_dkv", f"dV: first key block skips queries "
         f"{rows(drop_k)}", "dv", tol_b,
         planted(got["dv"], first_k, dv_drop[:, first_k])),
    ]
    for name, what, key, tol, bad in faults:
        ratio = mismatch(bad, want[key], tol)
        print(f"  planted fault, {what}: mismatch={ratio:.4f} of its limit "
              f"(sound {name}: {errs[name][0]:.4f}) "
              f"{'rejected' if ratio > 1.0 else 'NOT REJECTED'}")
        if not ratio > 1.0:
            raise AssertionError(f"the check of {name} passes a planted "
                                 f"fault ({what})")


def _sdpa(q, k, v, causal, scale, part: str, batch: int = BATCH) -> float:
    """Time torch's fused attention on the same inputs, as [b, h, s, d]:
    `part` is "forward", "backward" (one backward of a recorded forward) or
    "both"."""
    import torch.nn.functional as F

    shape = (batch, -1, q.shape[1], q.shape[2])
    grad = part != "forward"
    q4, k4, v4 = (t.view(shape).detach().requires_grad_(grad)
                  for t in (q, k, v))

    def forward():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              scale=scale)

    if part == "forward":
        return time_ms(forward)
    if part == "both":
        def run():
            q4.grad = k4.grad = v4.grad = None
            forward().backward(torch.ones_like(q4))
        return time_ms(run)
    o = forward()
    g = torch.ones_like(o)

    def run():
        q4.grad = k4.grad = v4.grad = None
        o.backward(g, retain_graph=True)
    return time_ms(run)


def check_model(gpt2) -> None:
    """Phase 3: flash kernels against plain attention in a small GPT-2 on
    the card, float32 (tolerances as for the float32 kernels)."""
    import dataclasses

    cfg = gpt2.GPT2Config(vocab_size=512, n_positions=256, n_embd=128,
                          n_layer=2, n_head=2, dtype=torch.float32)
    ids = torch.randint(0, cfg.vocab_size, (2, 256),
                        generator=torch.Generator().manual_seed(3)).cuda()
    results = []
    for use_flash in (True, False):
        model = gpt2.GPT2(dataclasses.replace(cfg, use_flash=use_flash),
                          device="cuda", seed=0)
        logits = model(ids)
        gpt2.next_token_loss(logits, ids).backward()
        results.append((logits.detach(), [p.grad for p in model.parameters()]))
    (lf, gf), (lr, gr) = results
    err_logits = mismatch(lf, lr, 1e-4)
    err_grads = max(mismatch(a, b, 5e-4) for a, b in zip(gf, gr))
    print(f"  small GPT-2 flash vs plain attention, mismatch of its limit: "
          f"logits {err_logits:.4f} (tol 1e-4), grads {err_grads:.4f} "
          f"(tol 5e-4)")
    if not (err_logits <= 1.0 and err_grads <= 1.0):
        raise AssertionError("GPT-2 with the kernels disagrees with plain "
                             "attention")


def train_loop(config):
    """The user's loop: a named training configuration built from seed 0
    (`profile_train_step.build`: the model, AdamW(3e-4, wd 0.1), a fixed
    random batch), its warm-up steps, then its timed ones
    (`profile_train_step.MODELS`). For MoE, forward hooks keep each step's
    router loss per layer, and in the last step layer 0's slots used per
    expert (a reduction over its dispatch tensor); the last step's are
    reported."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.moe import MoE, expert_capacity
    from ray_tpu_torch.profile_train_step import MODELS, build
    from ray_tpu_torch.train import session

    device = session.get_device()
    leg = MODELS[config["model"]]
    model, step, flops_per_token, batch = build(config["model"], device)
    routing = {"last_step": False}
    if isinstance(model, MoE):
        def keep(i):
            def hook(module, inputs, out):
                routing[i] = out[1].detach()
                if i == 0 and routing["last_step"]:
                    routing["slots_used"] = out[2].sum(dim=(0, 2))
            return hook
        for i, blk in enumerate(model.layers):
            blk.moe.register_forward_hook(keep(i))
    b, s = batch["input_ids"].shape
    losses = [step(batch) for _ in range(leg.warmup)]
    losses[-1].item()  # waits for the device
    t0 = time.perf_counter()
    losses += [step(batch) for _ in range(leg.steps - 1)]
    routing["last_step"] = True
    losses.append(step(batch))
    losses[-1].item()
    dt = time.perf_counter() - t0
    tokens = b * s * leg.steps
    for i, loss in enumerate(losses):
        session.report({"step": i, "loss": loss.item()})
    final = {
        "step": len(losses), "loss": losses[-1].item(),
        "batch": b, "seq": s,
        "tokens_per_sec": tokens / dt, "ms_per_step": 1e3 * dt / leg.steps,
        "mfu": flops_per_token * tokens / dt / PEAK_FLOPS[torch.bfloat16],
        "n_params": gpt2.count_params(model)}
    if "slots_used" in routing:
        cfg = model.config
        used = routing["slots_used"]
        final.update(
            router_loss=sum(routing[i] for i in range(cfg.n_layer)).item(),
            capacity=expert_capacity(cfg, b * s),
            layer0_slots_used=used.tolist(),
            layer0_dropped_share=1 - used.sum().item() / (b * s * cfg.top_k))
    session.report(final)


def train_phase(attn, name: str, per_step: dict, card: str,
                mfu_note: str = "") -> dict:
    """`TorchTrainer(train_loop).fit()` on the named configuration, on the
    card: the loss must be finite and fall, and each kernel launch
    `per_step[kernel]` times a step. Returns the final metrics, with the
    launches and the peak memory."""
    from ray_tpu_torch.profile_train_step import MODELS
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.reset_kernel_launches()
    result = TorchTrainer(
        train_loop, train_loop_config={"model": name},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True)).fit()
    torch.cuda.synchronize()
    launches = attn.kernel_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    m = dict(result.metrics, launches=launches, peak_gib=peak_gib,
             card=card)
    losses = [r["loss"] for r in result.metrics_history[:-1]]
    print("losses: " + ", ".join(f"{x:.4f}" for x in losses))
    print(f"batch {m['batch']}, seq {m['seq']}: tokens/s "
          f"{m['tokens_per_sec']:.1f}, ms/step {m['ms_per_step']:.3f}, MFU "
          f"{m['mfu']:.4f} (989 TFLOP/s bf16 dense{mfu_note}), peak memory "
          f"{peak_gib:.2f} GiB, params {m['n_params']}, card {card}")
    n_steps = MODELS[name].warmup + MODELS[name].steps
    print(f"launches in {n_steps} steps: {launches}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss not finite and falling: {losses}")
    want = {k: per_step[k] * n_steps for k in launches}
    if launches != want:
        raise AssertionError(f"{name}: expected {per_step} launches a step, "
                             f"got {launches} in {n_steps} steps")
    gc.collect()
    torch.cuda.empty_cache()
    return m


def time_long_shape(attn) -> dict:
    """Phase 8: K1, K2 and K3 at the long-context shape, run once at the
    whole bh 48 and held element by element against their plain versions
    LONG_CHUNK heads at a time (heads are independent; the plain float32
    scores of all 48 would take 12 GiB), then timed alone, each beside its
    bound and scaled_dot_product_attention's times on the same inputs.
    Returns each kernel's record."""
    case = LONG_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(300)
    q, k, v, do = (torch.randn(case["bh"], case["seq"], case["d"],
                               generator=gen, device="cuda",
                               dtype=case["dtype"]) for _ in range(4))
    scale = 1.0 / math.sqrt(case["d"])
    got = run_kernels(attn, q, k, v, do, True, scale)
    res = collections.defaultdict(list)
    for c in range(0, case["bh"], LONG_CHUNK):
        h = slice(c, c + LONG_CHUNK)
        part = {key: t[h] for key, t in got.items()}
        want = run_plain(attn, q[h], k[h], v[h], do[h], part, True, scale)
        for key, r in compare(part, want, case["dtype"]).items():
            res[key].append(r)
        del want
    errs = report({key: (worst([r[0] for r in rs]), max(r[1] for r in rs),
                         rs[0][2]) for key, rs in res.items()},
                  f"bh={case['bh']} seq={case['seq']} d={case['d']} "
                  f"{str(case['dtype']).split('.')[-1]} causal=True (plain "
                  f"{LONG_CHUNK} heads at a time)")
    out, lse, dq, delta, dk, dv = (got[key] for key in (
        "out", "lse", "dq", "delta", "dk", "dv"))
    torch.cuda.synchronize()
    sdpa = {part: _sdpa(q, k, v, True, scale, part, batch=LONG_BATCH)
            for part in ("forward", "backward", "both")}
    shape = (f"bh {case['bh']}, seq {case['seq']}, d {case['d']}, bf16, "
             "causal")
    runs = {
        "flash_fwd": (lambda: attn._flash_forward(q, k, v, True, scale), 2,
                      [q, k, v, out, lse], sdpa["forward"]),
        "flash_bwd_dq": (lambda: attn._bwd_dq(q, k, v, do, out, lse, True,
                                              scale), 3,
                         [q, k, v, do, out, lse, dq, delta], None),
        "flash_bwd_dkv": (lambda: attn._bwd_dkv(q, k, v, do, lse, delta,
                                                True, scale), 4,
                          [q, k, v, do, lse, delta, dk, dv], None),
    }
    recs = {}
    for name, (fn, n_prod, tensors, lib_ms) in runs.items():
        b_ms, b_by = bound(case, n_prod, tensors)
        recs[name] = {"shape": shape, "max_abs_err": errs[name][1],
                      "ms": time_ms(fn), "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib_ms,
                      "sdpa_fwd_bwd_ms": sdpa["both"]}
        print(f"  {name:14s} at {shape}: {recs[name]['ms']:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / recs[name]['ms']:.2%} of it")
    fwd, bwd = recs["flash_fwd"]["ms"], (recs["flash_bwd_dq"]["ms"]
                                         + recs["flash_bwd_dkv"]["ms"])
    print(f"  scaled_dot_product_attention at that shape: forward "
          f"{sdpa['forward']:.4f} ms (K1 {fwd / sdpa['forward']:.3f}x), "
          f"backward {sdpa['backward']:.4f} ms (K2 + K3 {bwd:.4f} ms), "
          f"forward + backward {sdpa['both']:.4f} ms (kernels "
          f"{fwd + bwd:.4f} ms)")
    del q, k, v, do, got, out, lse, dq, delta, dk, dv
    torch.cuda.empty_cache()
    return recs


def check_long_model(attn, gpt2) -> dict:
    """Phase 8: the leg's GPT-2 (full width and depth, seq 8192, remat) at
    batch LONG_CHECK_BATCH, from seed 0, through LONG_CHECK_STEPS AdamW
    steps with the kernels and with plain attention, on the same weights
    and tokens; each flash run must launch K1 twice a layer a step, K2 and
    K3 once.
    - float32, where the two differ only in summation order: each step's
      loss within 1e-4 of plain attention's (relative), and every
      first-step gradient within 5e-4 element by element (`mismatch`): the
      float32 kernels' limits.
    - bf16, the leg's kernels: each step's loss within the bf16 kernels'
      2e-2 of plain attention's (relative), and the first-step gradients
      no further from the float32 plain model's than plain attention's in
      bf16 are, within MODEL_ERR_RATIO (over all parameters as one vector).
    Returns the losses and distances."""
    seq = LONG_SHAPE["seq"]
    cfg = gpt2.GPT2Config(n_positions=seq, remat=True)
    ids = torch.randint(0, cfg.vocab_size, (LONG_CHECK_BATCH, seq),
                        generator=torch.Generator().manual_seed(1)).cuda()
    batch = {"input_ids": ids, "labels": ids}
    n = cfg.n_layer
    want_launches = {"flash_fwd": 2 * n * LONG_CHECK_STEPS,
                     "flash_bwd_dq": n * LONG_CHECK_STEPS,
                     "flash_bwd_dkv": n * LONG_CHECK_STEPS}

    def train(dtype, use_flash: bool):
        model = gpt2.GPT2(dataclasses.replace(cfg, dtype=dtype,
                                              use_flash=use_flash),
                          device="cuda", seed=0)
        step = gpt2.make_train_step(model, gpt2.adamw(model))
        attn.reset_kernel_launches()
        losses = [step(batch)]
        grads = [p.grad.clone() for p in model.parameters()]
        losses += [step(batch) for _ in range(LONG_CHECK_STEPS - 1)]
        losses = [x.item() for x in losses]
        launches = attn.kernel_launches()
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
        if use_flash and launches != want_launches:
            raise AssertionError(f"long model check: expected "
                                 f"{want_launches} launches, got {launches}")
        return losses, grads

    out = {}
    runs = {}
    for dtype, tol in ((torch.float32, 1e-4),
                       (torch.bfloat16, TOL[torch.bfloat16, "fwd"])):
        kind = str(dtype).split(".")[-1]
        runs[kind] = (train(dtype, True), train(dtype, False))
        (lf, _), (lp, _) = runs[kind]
        loss_err = worst([abs(a - b) / abs(b) for a, b in zip(lf, lp)])
        out[kind] = {"losses_flash": lf, "losses_plain": lp,
                     "loss_rel_err": loss_err}
        print(f"  {kind}, batch {LONG_CHECK_BATCH}, seq {seq}, remat: losses "
              f"with the kernels {[round(x, 6) for x in lf]}, with plain "
              f"attention {[round(x, 6) for x in lp]}; largest relative "
              f"difference {loss_err:.3e} (tol {tol:.0e})")
        if not loss_err <= tol:
            raise AssertionError(f"long model check, {kind}: the losses "
                                 "with the kernels and with plain attention "
                                 "part")
    (_, g_f32), (_, truth) = runs["float32"]
    grad_err = worst([mismatch(a, b, 5e-4) for a, b in zip(g_f32, truth)])
    (_, g_flash), (_, g_plain) = runs["bfloat16"]
    flat = [torch.cat([g.flatten() for g in grads])
            for grads in (g_flash, g_plain, truth)]
    d_flash, d_plain = (rel_err(g, flat[2]) for g in flat[:2])
    out.update(grad_mismatch_float32=grad_err, bf16_grad_dist_flash=d_flash,
               bf16_grad_dist_plain=d_plain)
    print(f"  float32 first-step gradients, kernels against plain attention: "
          f"mismatch={grad_err:.4f} of its limit (tol 5e-4); bf16 "
          f"first-step gradients' distance to the float32 plain model's "
          f"(rms of the difference over rms): with the kernels "
          f"{d_flash:.5f}, with plain attention {d_plain:.5f} (limit "
          f"{MODEL_ERR_RATIO} x the plain one)")
    del runs, g_f32, truth, g_flash, g_plain, flat
    gc.collect()
    torch.cuda.empty_cache()
    if not grad_err <= 1.0:
        raise AssertionError("long model check: float32 gradients with the "
                             "kernels disagree with plain attention's")
    if not d_flash <= MODEL_ERR_RATIO * d_plain:
        raise AssertionError("long model check: bf16 gradients with the "
                             "kernels are further from the float32 model's "
                             "than plain attention's")
    return out


def check_remat(attn, gpt2) -> dict:
    """Phase 9: the phase-3 GPT-2 (float32) with remat on and off, with
    dropout 0 and 0.1: loss and every gradient within the float32 kernels'
    5e-4, K1 twice a layer under remat. Returns, per dropout, whether the
    two runs are bit-equal."""
    cfg = gpt2.GPT2Config(vocab_size=512, n_positions=256, n_embd=128,
                          n_layer=2, n_head=2, dtype=torch.float32)
    ids = torch.randint(0, cfg.vocab_size, (2, 256),
                        generator=torch.Generator().manual_seed(3)).cuda()
    n = cfg.n_layer
    bit_equal = {}
    for dropout in (0.0, 0.1):
        runs = []
        for remat in (False, True):
            model = gpt2.GPT2(dataclasses.replace(cfg, dropout=dropout,
                                                  remat=remat),
                              device="cuda", seed=0)
            torch.manual_seed(0)  # the CPU's and every card's generator
            attn.reset_kernel_launches()
            loss = gpt2.next_token_loss(model(ids, deterministic=False), ids)
            loss.backward()
            torch.cuda.synchronize()
            runs.append((loss.detach(), [p.grad for p in model.parameters()],
                         attn.kernel_launches()))
        (loss_p, grads_p, launches_p), (loss_r, grads_r, launches_r) = runs
        err_loss = mismatch(loss_r.view(1), loss_p.view(1), 5e-4)
        err_grads = max(mismatch(a, b, 5e-4)
                        for a, b in zip(grads_r, grads_p))
        bit_equal[dropout] = bool(torch.equal(loss_r, loss_p) and all(
            torch.equal(a, b) for a, b in zip(grads_r, grads_p)))
        want_p = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
        want_r = dict(want_p, flash_fwd=2 * n)
        print(f"  dropout {dropout}: remat against no remat, mismatch of "
              f"its limit: loss {err_loss:.4f}, grads {err_grads:.4f} (tol "
              f"5e-4); bit-equal {bit_equal[dropout]}; launches "
              f"{launches_r} with remat, {launches_p} without")
        if not (err_loss <= 1.0 and err_grads <= 1.0):
            raise AssertionError(f"remat changes the loss or gradients at "
                                 f"dropout {dropout}")
        if launches_p != want_p or launches_r != want_r:
            raise AssertionError(f"expected {want_p} launches without remat "
                                 f"and {want_r} with it")
    return bit_equal


def llama_forward(attn, llama):
    """Phase 6. Returns (model, K1 launches of the forward, K1's record at
    the Llama-7B prefill shape)."""
    cfg = llama.LlamaConfig.llama7b()
    t0 = time.perf_counter()
    model = llama.Llama(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  Llama-7B built: {n_params} float32 parameters from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    if n_params != 5_933_109_248:
        raise AssertionError(f"Llama-7B has {n_params} parameters")
    # The same weights with plain attention, and computing in float32.
    plain, exact = (llama.Llama(dataclasses.replace(cfg, **changes),
                                device="cuda", state=model.state_dict())
                    for changes in (dict(use_flash=False),
                                    dict(use_flash=False,
                                         dtype=torch.float32)))
    ids = torch.randint(0, cfg.vocab_size, (1, LLAMA_SEQ),
                        generator=torch.Generator().manual_seed(0)).cuda()
    with torch.no_grad():
        torch.cuda.synchronize()
        attn.reset_kernel_launches()
        got = model(ids)
        torch.cuda.synchronize()
        launches = attn.kernel_launches()
        want, truth = plain(ids), exact(ids)
        fwd_ms = time_ms(lambda: model(ids), reps=3, rounds=3)
        plain_ms = time_ms(lambda: plain(ids), reps=3, rounds=3)
    del plain, exact
    err_flash, err_plain = rel_err(got, truth), rel_err(want, truth)
    ok = (bool(torch.isfinite(got).all())
          and err_flash <= MODEL_ERR_RATIO * err_plain)
    print(f"  Llama-7B forward, batch 1, seq {LLAMA_SEQ}, bf16: logits "
          f"{tuple(got.shape)}; distance to the float32 model (rms of the "
          f"difference over rms): with the kernel {err_flash:.5f}, with "
          f"plain attention {err_plain:.5f} (limit {MODEL_ERR_RATIO} x the "
          f"plain one) {'ok' if ok else 'FAIL'}; kernel against plain "
          f"element by element: max_abs_err={max_err(got, want):.3e}, "
          f"mismatch={mismatch(got, want, TOL[torch.bfloat16, 'fwd']):.4f} "
          f"of the kernels' limit (not a check at model depth, PERF.md); "
          f"forward {fwd_ms:.3f} ms with the kernel, {plain_ms:.3f} ms "
          f"plain; launches {launches}")
    if not ok:
        raise AssertionError("Llama-7B with the flash kernel is further from "
                             "the float32 model than with plain attention")
    want_launches = {name: 0 for name in launches}
    want_launches["flash_fwd"] = cfg.n_layer
    if launches != want_launches:
        raise AssertionError(f"expected {cfg.n_layer} launches of K1 in the "
                             f"forward, got {launches}")

    case = dict(bh=cfg.n_head, seq=LLAMA_SEQ, d=cfg.head_dim,
                dtype=torch.bfloat16, causal=True)
    gen = torch.Generator(device="cuda").manual_seed(200)
    q, k, v = (torch.randn(case["bh"], LLAMA_SEQ, case["d"], generator=gen,
                           device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / math.sqrt(case["d"])
    out, lse = attn._flash_forward(q, k, v, True, scale)
    out_p, _ = attn.flash_forward_reference(q, k, v, True, scale)
    tol = TOL[torch.bfloat16, "fwd"]
    ratio = mismatch(out, out_p, tol)
    if not ratio <= 1.0:
        raise AssertionError("K1 disagrees with its plain version at the "
                             "Llama-7B shape")
    b_ms, b_by = bound(case, 2, [q, k, v, out, lse])
    rec = {"shape": f"bh {case['bh']}, seq {LLAMA_SEQ}, d {case['d']}, "
                    "bf16, causal",
           "max_abs_err": max_err(out, out_p),
           "ms": time_ms(lambda: attn._flash_forward(q, k, v, True, scale)),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": _sdpa(q, k, v, True, scale, "forward", batch=1)}
    print(f"  flash_fwd at the Llama-7B prefill shape ({rec['shape']}): "
          f"{rec['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"scaled_dot_product_attention forward {rec['library_ms']:.4f} ms,"
          f" mismatch={ratio:.4f} of its limit")
    return model, launches, rec


def serve_prompts(vocab: int):
    """Phase 7's traffic from seed 0: N_REQUESTS prompts of PROMPT_LEN
    tokens; the even ones start with one shared SHARED_PREFIX-token prefix
    (and are longer than it), so the radix cache hits once the first of
    them finishes."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, SHARED_PREFIX).tolist()
    prompts = []
    for i in range(N_REQUESTS):
        if i % 2 == 0:
            n = int(rng.integers(SHARED_PREFIX + 64, PROMPT_LEN[1] + 1))
            prompts.append(shared + rng.integers(
                0, vocab, n - SHARED_PREFIX).tolist())
        else:
            n = int(rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
            prompts.append(rng.integers(0, vocab, n).tolist())
    return prompts


def dense_greedy(llama, model, prompt, n: int):
    """Greedy tokens of a dense-cache loop through `Llama.decode`, each with
    whether the reference's logits were a near tie there (top-2 gap below
    NEAR_TIE of the row's rms)."""
    cache = llama.make_cache(model.config, 1, len(prompt) + n,
                             device=model.device)
    ids = torch.tensor([prompt], device=model.device)
    pos = torch.zeros(1, dtype=torch.long, device=model.device)
    toks, ties = [], []
    for _ in range(n):
        logits, cache = model.decode(ids, cache, pos)
        row = logits[0, -1].float()
        top = row.topk(2).values
        ties.append(bool(top[0] - top[1] < NEAR_TIE * row.square().mean()
                         .sqrt()))
        toks.append(int(row.argmax()))
        pos = pos + ids.shape[1]
        ids = torch.tensor([[toks[-1]]], device=model.device)
    return toks, ties


def agree_until_tie(got, want, ties) -> int:
    """How many leading tokens were compared: all steps before the first
    near tie, and always the first. Raises on a disagreement among them."""
    n = max(1, ties.index(True)) if True in ties else len(want)
    n = min(n, len(got), len(want))
    if got[:n] != want[:n]:
        raise AssertionError(f"tokens disagree before the first near tie: "
                             f"{got[:n]} != {want[:n]}")
    return n


def _timed_calls(engine):
    """Wrap the engine's program calls: each is bracketed by CUDA events
    (no synchronisation added) and logged as (program, rows or tokens it
    wrote, start, end)."""
    calls = []
    run = engine._call

    def timed(name, fn, arenas, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(name, fn, arenas, *args)
        end.record()
        calls.append((name, int(np.count_nonzero(args[3])), start, end))
        return out

    engine._call = timed
    return calls


def _drive(engine, calls):
    """The user's loop: step until idle. Returns (wall s, [(step wall s,
    its program calls)])."""
    steps = []
    t0 = time.perf_counter()
    while engine.has_work():
        first, ts = len(calls), time.perf_counter()
        engine.step()
        steps.append((time.perf_counter() - ts, calls[first:]))
    return time.perf_counter() - t0, steps


def serve_llama(inference, llama, model, card: str) -> dict:
    """Phase 7. Returns the serving numbers."""
    cfg = inference.EngineConfig(**SERVE)
    prompts = serve_prompts(model.config.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = inference.InferenceEngine(cfg, model=model)
    arena_gib = sum(k.numel() * k.element_size() * 2
                    for k, _ in engine._arenas) / 2 ** 30
    calls = _timed_calls(engine)
    reqs = [engine.add_request(p, max_new_tokens=NEW_TOKENS)
            for p in prompts]
    wall, steps = _drive(engine, calls)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = engine.stats()
    engine.check_no_leaks()
    if any(r.state != "FINISHED" or len(r.generated) != NEW_TOKENS
           for r in reqs):
        raise AssertionError("a request did not get its tokens")
    shapes = {k: stats[f"{k}_compiles"] for k in ("prefill", "decode")}
    hit_rate = stats["prefix_cache"]["hit_rate"]
    if shapes != {"prefill": 1, "decode": 1} or not hit_rate > 0:
        raise AssertionError(f"programs saw {shapes} shapes, prefix hit rate "
                             f"{hit_rate}")
    ms = {name: [] for name in ("prefill", "decode")}
    tokens = dict.fromkeys(ms, 0)
    for name, n, start, end in calls:
        ms[name].append((start.elapsed_time(end), n))
        tokens[name] += n
    decode8 = [t for t, n in ms["decode"] if n == cfg.batch_slots]
    step8 = [1e3 * dt for dt, cs in steps
             if [c[0] for c in cs] == ["decode"]
             and cs[0][1] == cfg.batch_slots]
    ttft = np.asarray([1e3 * (r.first_token_at - r.submitted_at)
                       for r in reqs])
    out = {
        "requests": len(reqs), "new_tokens": NEW_TOKENS,
        "prompt_tokens": sum(map(len, prompts)),
        "prefilled_tokens": tokens["prefill"],
        "cached_tokens": sum(r.cached_tokens for r in reqs),
        "prefix_hit_rate": hit_rate,
        "prefill_tokens_per_s": 1e3 * tokens["prefill"]
        / sum(t for t, _ in ms["prefill"]),
        "decode_tokens_per_s": 1e3 * tokens["decode"]
        / sum(t for t, _ in ms["decode"]),
        "output_tokens_per_s": len(reqs) * NEW_TOKENS / wall,
        "wall_s": wall, "steps": len(steps),
        "ttft_p50_ms": float(np.percentile(ttft, 50)),
        "ttft_p99_ms": float(np.percentile(ttft, 99)),
        "decode_ms_at_8_slots": statistics.mean(decode8),
        "decode_step_wall_ms_at_8_slots": statistics.mean(step8),
        "decode_calls_at_8_slots": len(decode8),
        "prefill_chunk_ms": statistics.mean(
            t for t, n in ms["prefill"] if n == cfg.prefill_chunk),
        "peak_gib": peak_gib, "arena_gib": arena_gib, "card": card,
    }
    print(f"  {len(reqs)} requests served in {wall:.2f} s over {len(steps)} "
          f"steps: "
          f"{out['prompt_tokens']} prompt tokens ({out['cached_tokens']} from "
          f"the prefix cache, hit rate {hit_rate:.3f}), {len(reqs)} x "
          f"{NEW_TOKENS} new; no leaks; one shape per program")
    print(f"  prefill {out['prefill_tokens_per_s']:.1f} tokens/s "
          f"({out['prefill_chunk_ms']:.3f} ms a {cfg.prefill_chunk}-token "
          f"chunk), decode "
          f"{out['decode_tokens_per_s']:.1f} tokens/s, output "
          f"{out['output_tokens_per_s']:.1f} tokens/s; TTFT p50 "
          f"{out['ttft_p50_ms']:.1f} ms, p99 {out['ttft_p99_ms']:.1f} ms; "
          f"decode step at 8 busy slots {out['decode_ms_at_8_slots']:.3f} ms"
          f" (device span, {len(decode8)} steps; "
          f"{out['decode_step_wall_ms_at_8_slots']:.3f} ms wall a step); "
          f"peak {peak_gib:.2f} GiB (arena {arena_gib:.2f} GiB); card {card}")

    # How far the served bf16 tokens follow a bf16 dense-cache loop: shown,
    # not held. 32 random bf16 layers put the logits ~8% (rms) from the
    # float32 model's (phase 6), far above the near-tie margin, so two bf16
    # orders of the same sums part at ordinary steps; the tokens are held
    # in float32 below.
    follow = []
    for i in range(N_COMPARED):
        toks, ties = dense_greedy(llama, engine._model, prompts[i],
                                  NEW_TOKENS)
        follow.append(leading_agreement(reqs[i].generated, toks))
    plain = [r.generated for r in reqs]
    print(f"  bf16: requests 0..{N_COMPARED - 1} follow the bf16 dense-cache "
          f"loop for their first {follow} of {NEW_TOKENS} tokens")
    out["bf16_dense_agreement"] = follow
    del engine, reqs, calls
    gc.collect()
    torch.cuda.empty_cache()

    spec = inference.InferenceEngine(dataclasses.replace(
        cfg, spec_decode_draft_len=SPEC_DRAFT_LEN), model=model)
    sreqs = [spec.add_request(prompts[i], max_new_tokens=SPEC_TOKENS)
             for i in range(SPEC_REQUESTS)]
    swall, _ = _drive(spec, [])
    sd = check_spec(spec, sreqs)
    follow = [leading_agreement(r.generated, plain[i])
              for i, r in enumerate(sreqs)]
    out["spec"] = {"draft_len": SPEC_DRAFT_LEN,
                   "draft_layers": spec._draft_model.config.n_layer,
                   "accept_rate": sd["accept_rate"],
                   "mean_accepted": sd["mean_accepted"],
                   "rounds": sd["rounds"], "wall_s": swall,
                   "output_tokens_per_s": SPEC_REQUESTS * SPEC_TOKENS / swall,
                   "bf16_plain_agreement": follow}
    print(f"  speculative leg (draft {SPEC_DRAFT_LEN}, "
          f"{out['spec']['draft_layers']}-layer draft): {SPEC_REQUESTS} x "
          f"{SPEC_TOKENS} tokens in {swall:.2f} s, accept rate "
          f"{sd['accept_rate']:.4f} ({sd['rounds']} rounds); no leaks; one "
          f"shape per program; follows the plain bf16 engine for the first "
          f"{follow} tokens")
    del spec, sreqs
    gc.collect()
    torch.cuda.empty_cache()
    out["float32"] = check_float32(inference, llama, model, prompts)
    return out


def leading_agreement(got, want) -> int:
    n = 0
    while n < min(len(got), len(want)) and got[n] == want[n]:
        n += 1
    return n


def check_spec(spec, sreqs) -> dict:
    """No leaks, one shape per program, every token: the spec stats."""
    st = spec.stats()
    spec.check_no_leaks()
    sd = st["spec_decode"]
    shapes = [st["prefill_compiles"], sd["draft_prefill_compiles"],
              sd["propose_compiles"], sd["verify_compiles"]]
    if shapes != [1, 1, 1, 1] or any(len(r.generated) != SPEC_TOKENS
                                     for r in sreqs):
        raise AssertionError(f"speculative leg: programs saw {shapes} "
                             "shapes, or a request missed tokens")
    return sd


def check_float32(inference, llama, model, prompts) -> dict:
    """The engine's tokens against the dense-cache greedy loop, on the same
    weights computing in float32 (where the two differ only in summation
    order): requests 0..N_COMPARED-1 with NEW_TOKENS each and the rest of
    the first SPEC_REQUESTS with SPEC_TOKENS, served together; then the
    speculative engine's against the plain engine's. Each agrees up to the
    reference's first near tie, the first token always."""
    exact = llama.Llama(dataclasses.replace(model.config,
                                            dtype=torch.float32),
                        device=model.device, state=model.state_dict())
    budgets = [NEW_TOKENS] * N_COMPARED + [SPEC_TOKENS] * (SPEC_REQUESTS
                                                           - N_COMPARED)
    cfg = inference.EngineConfig(**dict(
        SERVE, num_blocks=SPEC_REQUESTS * SERVE["max_blocks_per_seq"] + 1))
    engine = inference.InferenceEngine(cfg, model=exact)
    reqs = [engine.add_request(prompts[i], max_new_tokens=n)
            for i, n in enumerate(budgets)]
    engine.run_until_idle()
    engine.check_no_leaks()
    plain = [r.generated for r in reqs]
    del engine, reqs
    refs = [dense_greedy(llama, exact, prompts[i], n)
            for i, n in enumerate(budgets)]
    compared = [agree_until_tie(got, *ref) for got, ref in zip(plain, refs)]
    print(f"  float32: the engine agrees with the dense-cache greedy loop on "
          f"{compared} tokens of {budgets} (each up to the reference's first "
          f"near tie)")
    spec = inference.InferenceEngine(dataclasses.replace(
        cfg, spec_decode_draft_len=SPEC_DRAFT_LEN), model=exact)
    sreqs = [spec.add_request(prompts[i], max_new_tokens=SPEC_TOKENS)
             for i in range(SPEC_REQUESTS)]
    spec.run_until_idle()
    sd = check_spec(spec, sreqs)
    spec_compared = [agree_until_tie(r.generated, plain[i][:SPEC_TOKENS],
                                     refs[i][1][:SPEC_TOKENS])
                     for i, r in enumerate(sreqs)]
    print(f"  float32: the speculative engine (accept rate "
          f"{sd['accept_rate']:.4f}) agrees with the plain one on "
          f"{spec_compared} tokens of {SPEC_TOKENS}")
    del spec, sreqs, exact
    gc.collect()
    torch.cuda.empty_cache()
    return {"compared": compared, "budgets": budgets,
            "spec_compared": spec_compared,
            "spec_accept_rate": sd["accept_rate"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn

    print("== 1. device and build")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'cached'})")
    for src, log in logs.items():
        for fn, regs, spill in ptxas_usage(log):
            print(f"  {src}: {fn}: {regs} registers, {spill}")
        for line in log.splitlines():  # e.g. wgmma serialised by ptxas
            if "warning" in line.lower() or "Performance Loss" in line:
                print(f"  {src}: {line.strip()}")
    check_smem(attn, _build)

    print("== 2. kernels against their plain versions")
    records = check_kernels(attn)

    print("== 3. small GPT-2, kernels against plain attention")
    check_model(gpt2)

    print("== 4. main path: TorchTrainer.fit, GPT-2-small")
    n_layer = gpt2.GPT2Config.small().n_layer
    launches = train_phase(attn, "gpt2",
                           dict.fromkeys(attn.KERNELS, n_layer),
                           card)["launches"]

    print("== 6. Llama-7B forward, flash kernel against plain attention")
    from ray_tpu_torch import inference
    from ray_tpu_torch.models import llama

    model, llama_launches, records["flash_fwd"]["llama7b_prefill"] = \
        llama_forward(attn, llama)

    print("== 7. main path: Llama-7B serving through InferenceEngine")
    attn.reset_kernel_launches()
    serving = serve_llama(inference, llama, model, card)
    serve_launches = attn.kernel_launches()
    print(f"  launches while serving: {serve_launches} (the paged path "
          "runs no kernel of the port)")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    print("== 8. long context: TorchTrainer.fit, GPT-2-small at seq 8192, "
          "remat")
    legs = {"gpt2-long": train_phase(
        attn, "gpt2-long",
        {"flash_fwd": 2 * n_layer, "flash_bwd_dq": n_layer,
         "flash_bwd_dkv": n_layer}, card,
        ", not counting the recompute, as bench.py")}
    for name, rec in time_long_shape(attn).items():
        records[name]["gpt2_long"] = rec
    long_check = check_long_model(attn, gpt2)

    print("== 9. remat on the card: small GPT-2, float32, remat on and off")
    remat_bit_equal = check_remat(attn, gpt2)

    print("== 10. Llama-small training: TorchTrainer.fit")
    from ray_tpu_torch.models import moe

    n = llama.LlamaConfig.small().n_layer
    legs["llama-small"] = train_phase(
        attn, "llama-small",
        dict.fromkeys(attn.KERNELS, n), card)

    print("== 11. MoE-small training: TorchTrainer.fit, make_moe_train_step")
    cfg = moe.MoEConfig.small()
    m = legs["moe-small"] = train_phase(
        attn, "moe-small",
        dict.fromkeys(attn.KERNELS, cfg.n_layer), card)
    print(f"  last step: router loss {m['router_loss']:.6f} (summed over "
          f"layers); layer 0 slots used per expert {m['layer0_slots_used']}"
          f" of {m['capacity']}; routing choices dropped at capacity "
          f"{m['layer0_dropped_share']:.4f}")
    if not math.isfinite(m["router_loss"]):
        raise AssertionError(f"router loss not finite: {m['router_loss']}")

    print("== 12. results")
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": legs, "long_model_check": long_check,
                      "remat_bit_equal": {
                          str(k): v for k, v in remat_bit_equal.items()}}))
    paths = [launches, llama_launches, serve_launches] + [
        leg["launches"] for leg in legs.values()]
    for name, rec in records.items():
        rec["launches"] = sum(p[name] for p in paths)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
