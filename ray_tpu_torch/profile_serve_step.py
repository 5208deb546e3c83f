"""Where a Llama-7B serving step's device time goes, on one CUDA card.

    python3 -m ray_tpu_torch.profile_serve_step [--context 1024]

Builds the serving engine of `chip_smoke.py` phase 7 (Llama-7B at full
width and depth, random weights from seed 0, bf16 compute; 8 slots, blocks
of 16, a 2,048-token context, chunks of 512), then measures two steps:

- decode: 8 busy slots at about `--context` tokens each, no prefill;
- prefill: one 512-token chunk (positions 512-1023 of a longer prompt,
  nothing decoding).

Each is first timed without the profiler (host clock, ending in a
synchronisation), then traced with `torch.profiler` with the model's
functions wrapped in `record_function` ranges, so that the device time of
each kernel is booked to the range it was launched in: matrix products (the
dense layers), paged attention (the arena write, the gather of the context,
scores and softmax), RMSNorm and RoPE; kernels outside every range are the
rest (embedding, residual adds, SwiGLU's product, argmax, the step's
upload). Prints ms per step by group, the top kernels, the host ops that
took the most CPU time, the traced wall time and the share of it the device
sat idle, and one JSON line. The ranges add
host time under the profiler, so the untraced wall time is the one to
trust. Exits non-zero where there is no card or the trace holds no device
time.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

SERVE = dict(model_size="7b", batch_slots=8, block_size=16,
             max_blocks_per_seq=128, num_blocks=8 * 128 + 1,
             prefill_chunk=512)
DECODE_STEPS, TIMED_STEPS = 5, 10
RANGES = {
    "llama.dense": "matrix products (dense layers)",
    "llama.paged_attention": "paged attention (write, gather, softmax)",
    "llama.norm": "RMSNorm",
    "llama.rope": "RoPE",
}
OTHER = "elementwise and the rest"


def _annotate(llama):
    """Wrap the model's functions in record_function ranges; returns a
    function that undoes it."""
    from torch.profiler import record_function

    targets = [(llama.Dense, "forward", "llama.dense"),
               (llama, "_paged_attention", "llama.paged_attention"),
               (llama.RMSNorm, "forward", "llama.norm"),
               (llama, "apply_rope", "llama.rope")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in targets]

    def wrap(fn, name):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return inner

    for (obj, attr, name), (_, _, fn) in zip(targets, saved):
        setattr(obj, attr, wrap(fn, name))

    def undo():
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    return undo


def _wall_ms(engine, n: int) -> float:
    """Mean host time of n engine steps, each ending in a synchronisation."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sum(times) / n


def _trace(engine, n: int):
    """Trace n steps: (wall ms per step, {group: device ms per step},
    device ms per step, Counter of kernel ms per step)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    kernels = collections.Counter()
    groups = collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if not evt.is_user_annotation:
                kernels[evt.name] += evt.device_time_total / 1e3 / n
        elif evt.name in RANGES:
            # A CPU range's device time: the kernels its ops launched.
            groups[RANGES[evt.name]] += evt.device_time_total / 1e3 / n
    device_ms = sum(kernels.values())
    groups[OTHER] = device_ms - sum(groups.values())
    # Host side: self CPU time and calls of each op and runtime call (a
    # synchronisation shows here as time in cudaStreamSynchronize and the
    # like).
    host = sorted(((e.self_cpu_time_total / 1e3 / n, e.count / n, e.key)
                   for e in prof.key_averages()
                   if e.key not in RANGES), reverse=True)
    return wall_ms, groups, device_ms, kernels, host


def _report(label: str, wall_ms: float, traced):
    traced_wall, groups, device_ms, kernels, host = traced
    print(f"{label}: {wall_ms:.3f} ms a step untraced; traced "
          f"{traced_wall:.3f} ms wall, {device_ms:.3f} ms of kernels, device "
          f"idle {1 - device_ms / traced_wall:.4f} of the traced step")
    for group, ms in groups.most_common():
        print(f"  {ms:9.3f} ms {ms / device_ms:7.2%}  {group}")
    print("  top kernels (ms a step):")
    for name, ms in kernels.most_common(8):
        print(f"  {ms:9.3f}  {name[:100]}")
    print("  top host ops, traced (self CPU ms a step, calls a step):")
    for ms, calls, name in host[:10]:
        print(f"  {ms:9.3f} {calls:7.1f}  {name[:90]}")
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_wall,
            "device_ms": device_ms,
            "idle_share_traced": 1 - device_ms / traced_wall,
            "groups_ms": dict(groups)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--context", type=int, default=1024,
                    help="prompt tokens of each decoding slot")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve_step: CUDA is not available", file=sys.stderr)
        return 2
    from ray_tpu_torch.inference import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import llama

    cfg = EngineConfig(**SERVE)
    engine = InferenceEngine(cfg, device="cuda")
    vocab = engine._model.config.vocab_size
    rng = np.random.default_rng(0)

    # Decode: 8 slots at about `context` tokens, each far from its budget
    # (the first admitted decode while the others prefill, 2 chunks each).
    budget = 2 * cfg.batch_slots + 3 + TIMED_STEPS + DECODE_STEPS + 16
    reqs = [engine.add_request(rng.integers(0, vocab, args.context).tolist(),
                               max_new_tokens=budget)
            for _ in range(cfg.batch_slots)]
    while any(r.state != "DECODE" for r in reqs):
        engine.step()
    _wall_ms(engine, 3)                       # warm-up
    decode_wall = _wall_ms(engine, TIMED_STEPS)
    undo = _annotate(llama)
    try:
        decode = _trace(engine, DECODE_STEPS)
    finally:
        undo()
    for r in reqs:
        engine.cancel(r.request_id)

    # Prefill: the second 512-token chunk of a 1,536-token prompt (the
    # request stays in prefill after it, so nothing decodes in that step).
    def chunk_step(annotated: bool):
        req = engine.add_request(rng.integers(0, vocab, 1536).tolist(), 1)
        engine.step()
        if annotated:
            undo = _annotate(llama)
            try:
                out = _trace(engine, 1)
            finally:
                undo()
        else:
            out = _wall_ms(engine, 1)
        if req.state != "PREFILL" or req.processed != 1024:
            raise RuntimeError("the measured step was not the second chunk")
        engine.cancel(req.request_id)
        return out

    chunk_step(False)                         # warm-up
    prefill_wall = sum(chunk_step(False) for _ in range(3)) / 3
    prefill = chunk_step(True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    if decode[2] <= 0 or prefill[2] <= 0:
        print("profile_serve_step: the trace holds no device time",
              file=sys.stderr)
        return 1
    print(card)
    out = {"card": card, "context": args.context,
           "decode_8_slots": _report(
               f"decode step, 8 slots at ~{args.context} tokens",
               decode_wall, decode),
           "prefill_chunk": _report("prefill chunk of 512 (positions "
                                    "512-1023)", prefill_wall, prefill)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
