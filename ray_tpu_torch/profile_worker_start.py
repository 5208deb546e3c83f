"""Where a GPU trainer worker's start-up goes, on one CUDA card.

    python3 -m ray_tpu_torch.profile_worker_start

Starts the runtime with one GPU and runs, three times in a worker granted
the card, what a trainer worker does before its first GPT-2-small step
(the model of `profile_train_step`'s `gpt2`): import torch, import the
model's modules, create the CUDA context, draw the weights on the CPU from
seed 0 and move them to the card, build the model and its AdamW step
(`profile_train_step.build`, whose optimizer imports `torch._dynamo` on
its first construction in a process), then take two steps. The first run
is the worker's first (a cold process); the others reuse it, so they show
what stays once the imports are done. Also times `import torch` in a bare
subprocess. Prints one line of seconds per stage for each run, and one
JSON line last. Exits non-zero without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

STAGES = ("spawn", "import_torch", "import_model", "cuda_init",
          "weights_cpu", "to_card", "build", "step1", "step2")


def _stages() -> dict:
    """Wall-clock marks (time.time()) after each stage, in this process."""
    import os

    marks = {"spawn": time.time()}
    import torch
    marks["import_torch"] = time.time()
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.profile_train_step import build
    marks["import_model"] = time.time()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    marks["cuda_init"] = time.time()
    model = gpt2.GPT2(gpt2.GPT2Config(n_positions=1024), device="cpu")
    marks["weights_cpu"] = time.time()
    model.to("cuda")
    torch.cuda.synchronize()
    marks["to_card"] = time.time()
    del model
    model, step, _, batch = build("gpt2", torch.device("cuda"))
    torch.cuda.synchronize()
    marks["build"] = time.time()
    step(batch).item()
    marks["step1"] = time.time()
    step(batch).item()
    marks["step2"] = time.time()
    marks["pid"] = os.getpid()
    marks["dynamo_imported"] = "torch._dynamo" in sys.modules
    return marks


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    t = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import torch"], check=True)
    bare = time.perf_counter() - t
    print(f"import torch in a bare subprocess: {bare:.3f} s")
    import ray_tpu_torch
    from ray_tpu_torch.ops import _build

    _build.build_all()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    runs = []
    try:
        probe = ray_tpu_torch.remote(num_gpus=1)(_stages)
        for i in range(3):
            t0 = time.time()
            marks = ray_tpu_torch.get(probe.remote(), timeout=600)
            prev, secs = t0, {}
            for k in STAGES:
                secs[k] = marks[k] - prev
                prev = marks[k]
            secs["total"] = time.time() - t0
            runs.append({"pid": marks["pid"], "seconds": secs,
                         "dynamo_imported": marks["dynamo_imported"]})
            print(f"run {i} (worker pid {marks['pid']}): " + ", ".join(
                f"{k} {v:.3f}" for k, v in secs.items()))
    finally:
        ray_tpu_torch.shutdown()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    print(json.dumps({"bare_import_torch_s": bare, "runs": runs,
                      "card": card[0] if card else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
