"""Where a GPT-2 training step's device time goes, on one CUDA card.

    python3 -m ray_tpu_torch.profile_train_step

Builds GPT-2-small (bf16 compute, random weights from seed 0) at the main
path's batch 24 and seq 1024, takes two warm-up steps, then traces three
steps with `torch.profiler` and prints
the device time per step by kernel group (the port's flash kernels, matrix
products, the optimizer, the rest), the top kernels by device time, the
step's wall time and the share of it the device sat idle. Exits non-zero
when the trace holds no device time.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time

import torch

BATCH, SEQ, STEPS = 24, 1024, 3
# Kernel-name fragments of each group, matched in order.
GROUPS = [
    ("flash attention (this port)", ("fwd_kernel", "bwd_dq_kernel",
                                     "bwd_dkv_kernel")),
    ("matrix products (cuBLAS)", ("gemm", "sm90_xmma", "cutlass", "nvjet")),
    ("optimizer (AdamW)", ("multi_tensor_apply", "adam")),
    ("softmax / cross-entropy", ("softmax", "log_softmax", "logsumexp",
                                 "nll")),
    ("layer norm", ("layer_norm", "LayerNorm")),
]


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other (elementwise, copies, reductions)"


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch._torch_env import resolve_device
    from ray_tpu_torch.models import gpt2

    device = resolve_device()
    cfg = gpt2.GPT2Config.small()
    model = gpt2.GPT2(cfg, device=device, seed=0)
    step = gpt2.make_train_step(model, gpt2.adamw(model))
    ids = torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                        generator=torch.Generator().manual_seed(0)).to(device)
    batch = {"input_ids": ids, "labels": ids}
    for _ in range(2):
        step(batch).item()

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

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"GPT-2-small, batch {BATCH}, seq {SEQ}, bf16: "
          f"{wall_ms:.3f} ms/step wall, {device_ms:.3f} ms/step of kernels, "
          f"device idle {1 - device_ms / wall_ms:.4f} of the step")
    for group, ms in groups.most_common():
        print(f"  {ms:9.3f} ms/step {ms / device_ms:7.2%}  {group}")
    print("top kernels (ms/step, launches/step):")
    for name, ms in per_kernel.most_common(15):
        print(f"  {ms / STEPS:9.3f} {calls[name] / STEPS:6.1f}  "
              f"{name[:110]}")
    print(json.dumps({"wall_ms_per_step": wall_ms,
                      "device_ms_per_step": device_ms,
                      "groups_ms_per_step": dict(groups), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
