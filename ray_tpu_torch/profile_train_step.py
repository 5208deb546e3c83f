"""Where a training step's device time goes, on one CUDA card.

    python3 -m ray_tpu_torch.profile_train_step [--model gpt2]

`--model` names one of the training configurations that `chip_smoke.py`
drives (`MODELS`): GPT-2-small at batch 24, seq 1024 (`gpt2`, the default);
GPT-2-small at seq 8192 with per-block remat, batch 4 (`gpt2-long`);
Llama-small at batch 8, seq 2048 (`llama-small`); MoE-small at batch 4,
seq 2048 (`moe-small`). Each is built from seed 0 (bf16 compute on float32
parameters, AdamW(3e-4, wd 0.1), a fixed random batch), takes two warm-up
steps, then three steps are traced with `torch.profiler`. Prints the device
time per step by kernel group (the port's flash kernels; float32 matrix
products, which in MoE are the dense dispatch/combine products and the
router; the other matrix products; the optimizer; the rest), the top
kernels, the step's wall time and the share of it the device sat idle.

The cross-entropy, which kernel names do not separate from the other
elementwise work, is also timed alone with CUDA events on a tensor of the
step's logits (forward and backward over bf16 [batch, seq, vocab]). Prints
one JSON line last. Exits non-zero when the trace holds no device time.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from typing import NamedTuple

import torch

STEPS = 3


class Leg(NamedTuple):
    batch: int
    seq: int
    warmup: int   # steps chip_smoke.py's leg takes before its timed ones
    steps: int    # its timed steps


# The configurations `build` makes, by name.
MODELS = {
    "gpt2": Leg(24, 1024, 2, 10),       # chip_smoke.py phase 4
    "gpt2-long": Leg(4, 8192, 2, 5),    # phase 8: bench_gpt2_long's rung
    "llama-small": Leg(8, 2048, 2, 10),  # phase 10
    "moe-small": Leg(4, 2048, 2, 5),    # phase 11
}
# Kernel-name fragments of each group, matched in order. cuBLAS names its
# float32 kernels (TF32 off) `..._f32f32_f32f32_...` or `sgemm`.
GROUPS = [
    ("flash attention (this port)", ("fwd_kernel", "bwd_dq_kernel",
                                     "bwd_dkv_kernel")),
    ("float32 matrix products (MoE dispatch/combine, router)",
     ("f32f32_f32f32", "sgemm")),
    ("matrix products (cuBLAS)", ("gemm", "sm90_xmma", "cutlass", "nvjet")),
    ("optimizer (AdamW)", ("multi_tensor_apply", "adam")),
    ("softmax / cross-entropy", ("softmax", "log_softmax", "logsumexp",
                                 "nll")),
    ("layer norm", ("layer_norm", "LayerNorm")),
]


def build(name: str, device, seed: int = 0):
    """(model, step, flops_per_token, batch) of a named configuration:
    the model from `seed`, its train step under AdamW(3e-4, wd 0.1), the
    model's own training FLOPs per token at the configuration's seq, and
    a fixed random batch drawn from torch.Generator().manual_seed(seed)."""
    from ray_tpu_torch.models import gpt2, llama, moe

    batch, seq = MODELS[name][:2]
    if name in ("gpt2", "gpt2-long"):
        cfg = gpt2.GPT2Config(n_positions=max(seq, 1024),
                              remat=name == "gpt2-long")
        model = gpt2.GPT2(cfg, device=device, seed=seed)
        step = gpt2.make_train_step(model, gpt2.adamw(model))
        flops = gpt2.flops_per_token(cfg, seq)
    elif name == "llama-small":
        cfg = llama.LlamaConfig.small()
        model = llama.Llama(cfg, device=device, seed=seed)
        step = gpt2.make_train_step(model, gpt2.adamw(model))
        flops = llama.flops_per_token(cfg, seq)
    elif name == "moe-small":
        cfg = moe.MoEConfig.small()
        model = moe.MoE(cfg, device=device, seed=seed)
        step = moe.make_moe_train_step(model, gpt2.adamw(model))
        flops = moe.flops_per_token(cfg, seq)
    else:
        raise ValueError(f"unknown model {name!r}: one of {list(MODELS)}")
    ids = torch.randint(0, cfg.vocab_size, (batch, seq),
                        generator=torch.Generator().manual_seed(seed)
                        ).to(device)
    return model, step, flops, {"input_ids": ids, "labels": ids}


def time_ms(fn, reps: int = 5) -> float:
    """Mean time of `reps` back-to-back calls after one warm-up, from CUDA
    events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cross_entropy_ms(batch: int, seq: int, vocab: int, device) -> float:
    """The step's next-token cross-entropy, forward and backward, over bf16
    logits [batch, seq, vocab]."""
    from ray_tpu_torch.models.gpt2 import next_token_loss

    logits = torch.randn(batch, seq, vocab, device=device,
                         dtype=torch.bfloat16, requires_grad=True)
    ids = torch.randint(0, vocab, (batch, seq), device=device)

    def run():
        logits.grad = None
        next_token_loss(logits, ids).backward()
    ms = time_ms(run)
    del logits
    return ms


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other (elementwise, copies, reductions)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=list(MODELS), default="gpt2")
    args = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch._torch_env import resolve_device

    device = resolve_device()
    model, step, _, batch = build(args.model, device)
    for _ in range(2):
        step(batch).item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        loss = step(batch)
    loss.item()
    untraced_ms = 1e3 * (time.perf_counter() - t0) / STEPS

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            loss = step(batch)
        loss.item()
        wall_ms = 1e3 * (time.perf_counter() - t0) / STEPS

    per_kernel = collections.Counter()
    calls = collections.Counter()
    for evt in prof.events():
        # Kernels only: a user annotation (e.g. "Optimizer.step#AdamW.step")
        # also appears on the device timeline and spans kernels counted
        # already.
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.is_user_annotation):
            per_kernel[evt.name] += evt.device_time_total / 1e3
            calls[evt.name] += 1
    device_ms = sum(per_kernel.values()) / STEPS
    if device_ms <= 0:
        print("profile_train_step: the trace holds no device time",
              file=sys.stderr)
        return 1
    groups = collections.Counter()
    for name, ms in per_kernel.items():
        groups[_group(name)] += ms / STEPS

    cfg = model.config
    b, s = batch["input_ids"].shape
    del model, step, loss
    torch.cuda.empty_cache()
    alone = {"cross-entropy, forward and backward":
             cross_entropy_ms(b, s, cfg.vocab_size, device)}

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"{args.model}, batch {b}, seq {s}, bf16: {untraced_ms:.3f} "
          f"ms/step untraced; traced {wall_ms:.3f} ms/step wall, "
          f"{device_ms:.3f} ms/step of kernels, device idle "
          f"{1 - device_ms / wall_ms:.4f} of the traced step")
    for group, ms in groups.most_common():
        print(f"  {ms:9.3f} ms/step {ms / device_ms:7.2%}  {group}")
    print("timed alone on the step's shapes (CUDA events):")
    for what, ms in alone.items():
        print(f"  {ms:9.3f} ms/step {ms / device_ms:7.2%}  {what}")
    print("top kernels (ms/step, launches/step):")
    for name, ms in per_kernel.most_common(15):
        print(f"  {ms / STEPS:9.3f} {calls[name] / STEPS:6.1f}  "
              f"{name[:110]}")
    print(json.dumps({"model": args.model, "batch": b, "seq": s,
                      "untraced_ms_per_step": untraced_ms,
                      "wall_ms_per_step": wall_ms,
                      "device_ms_per_step": device_ms,
                      "groups_ms_per_step": dict(groups),
                      "alone_ms_per_step": alone, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
