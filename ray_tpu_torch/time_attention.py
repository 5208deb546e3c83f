"""Time the three flash kernels, by default at the main path's attention
shape, on one CUDA card.

    python3 -m ray_tpu_torch.time_attention [--causal 1] [--d 64[,128...]]
        [--bh 288] [--seq 1024] [--dtype bfloat16] [--only flash_fwd,...]

Builds the kernels of the checkout it is run from, launches each on random
inputs from a fixed seed (by default bf16, seq 1024 and bh 288,
GPT-2-small's batch 24 times 12 heads), as well as the plain PyTorch delta
= rowsum(dO * O) that the dQ kernel computes (`bwd_delta`), and prints one
JSON line for each head dim given: each time in ms (the median over five rounds of the mean of ten
back-to-back launches, from CUDA events), the shape, and the card's name
and power limit; and each call's device time alone (`<name>_device_ms`,
the kernels of one call in a torch.profiler trace), which at small shapes
sits under the call's time, the rest being the host's. To compare two versions of a kernel, run this from each
checkout in one call to the card, in turns. Exits non-zero where there is
no card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over `rounds` of the mean time of `reps` back-to-back calls,
    from CUDA events, after one warm-up call."""
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


def device_ms(fn) -> float:
    """The device time of one call (after a warm-up call): the CUDA
    kernels' time in a torch.profiler trace of it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--causal", type=int, default=1)
    parser.add_argument("--d", default="64",
                        help="a head dim, or several separated by commas")
    parser.add_argument("--bh", type=int, default=288)
    parser.add_argument("--seq", type=int, default=1024)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float16", "float32"))
    parser.add_argument("--only", default="flash_fwd,flash_bwd_dq,"
                        "flash_bwd_dkv,bwd_delta")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_attention: CUDA is not available", file=sys.stderr)
        return 2

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    for d in map(int, args.d.split(",")):
        print(json.dumps(time_head_dim(args, d, card)))
    return 0


def time_head_dim(args, d: int, card: str) -> dict:
    """The kernels of `--only` timed at head dim d, as one JSON record."""
    from ray_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(args.bh, args.seq, d, generator=gen,
                               device="cuda", dtype=getattr(torch, args.dtype))
                   for _ in range(4))
    causal, scale = bool(args.causal), d ** -0.5
    out, lse = attn._flash_forward(q, k, v, causal, scale)
    _, delta = attn._bwd_dq(q, k, v, do, out, lse, causal, scale)
    calls = {
        "flash_fwd": lambda: attn._flash_forward(q, k, v, causal, scale),
        "flash_bwd_dq": lambda: attn._bwd_dq(q, k, v, do, out, lse, causal,
                                             scale),
        "flash_bwd_dkv": lambda: attn._bwd_dkv(q, k, v, do, lse, delta,
                                               causal, scale),
        # The plain delta, which the backward ran before K2 computed it.
        "bwd_delta": lambda: attn.bwd_delta(out, do),
    }
    result = {"bh": args.bh, "seq": args.seq, "d": d,
              "dtype": args.dtype, "causal": causal, "card": card}
    for name in args.only.split(","):
        result[name] = time_ms(calls[name])
        result[name + "_device_ms"] = device_ms(calls[name])
    return result


if __name__ == "__main__":
    sys.exit(main())
