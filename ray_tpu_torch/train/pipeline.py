"""Pipeline-parallel training: stage programs, 1F1B schedule, transports.

The port's copy of `ray_tpu/train/pipeline.py`. A Llama is partitioned
into `pp` stage modules (`ray_tpu_torch.models.llama.LlamaStage`) and each
stage runs THREE small programs instead of one monolithic step:

- `fwd(params, x) -> y`: forward to the stage boundary, without autograd;
- `bwd(params, x, gy) -> (gparams[, gx])`: recompute-in-backward, the
  stage's forward run again under `torch.enable_grad()` and differentiated
  with `torch.autograd.grad`, so no saved tensor crosses the stage
  boundary: only activations forward and activation-grads backward;
- the LAST stage fuses loss forward and backward into one
  `fwdbwd(params, x, targets) -> (loss, gparams[, gx])`.

Composition is bitwise-exact: eager PyTorch runs the same operations on
the same tensors whether the model is split or not, and the kernels are
deterministic, so chaining per-stage gradients reproduces the monolithic
backward bit for bit (tests/test_torch_train_pipeline.py), in bf16 too.

Two schedules drive the stages over `m` microbatches:

- `"1f1b"`: one-forward-one-backward: stage `s` runs `min(pp - 1 - s, m)`
  warm-up forwards, then alternates forward and backward, then drains.
  Analytic bubble `(pp-1)/(m+pp-1)`.
- `"sequential"`: each microbatch round-trips the whole pipe before the
  next starts (the A/B baseline: same arithmetic, maximal bubble).

Both accumulate gradients in MICROBATCH order on every stage, so their
results are bitwise-identical: the schedule changes only the overlap.

Stage boundaries move over a transport: `LocalPipeTransport` (queues,
one process, a thread per stage, each stage's work on a CUDA stream of its
own) or `CollectivePipeTransport` (the host collective plane's p2p
send/recv: one worker process per stage, boundaries as host numpy, posts
overlapped by `isend`). Per-stage busy/wall accounting reports the
measured `bubble_frac` next to the analytic one.

`make_pipeline_train_fn` packages the whole thing as a
`train_loop_per_worker` for a WorkerGroup run: world size == pp x tp, the
tp ranks of each stage driving it tensor-parallel over their tp group,
every step checkpoints the stage's disjoint subtree
(`save_sharded_pytree(own_replicated=True)`), and a gang restart at a
DIFFERENT world size restores bit-exact from the merged manifest at the
new pp (`BackendExecutor(elastic_world_fn=)`).
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from ray_tpu_torch._torch_env import resolve_device
from ray_tpu_torch.models.llama import (LLAMA_PARTITION_RULES, LlamaConfig,
                                        LlamaStage, _param_shapes, _stage_of,
                                        merge_stage_params,
                                        shard_stage_params,
                                        stage_layer_ranges)
from ray_tpu_torch.parallel.mesh import MeshSpec
from ray_tpu_torch.parallel.tensor_parallel import (place_like,
                                                    vocab_parallel_nll)

__all__ = [
    "StagePrograms",
    "StageStats",
    "StageRunResult",
    "LocalPipeTransport",
    "CollectivePipeTransport",
    "token_xent",
    "tiny_pipeline_config",
    "build_stage_programs",
    "split_microbatches",
    "seeded_batch",
    "run_stage",
    "run_pipeline_step",
    "LocalPipelineTrainer",
    "analytic_bubble",
    "adam_state",
    "load_adam_state",
    "stage_state_template",
    "save_pipeline_stage",
    "restore_pipeline_stage",
    "make_pipeline_train_fn",
    "pipeline_mesh_spec",
]

SCHEDULES = ("1f1b", "sequential")
# optax.adam's defaults, which torch.optim.Adam takes as arguments.
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def token_xent(logits, targets, ctx=None):
    """Mean next-token cross entropy (log-softmax in float32). With a mesh
    context `ctx`, `logits` are this rank's vocab shard and the
    vocab-parallel form runs over its tp group."""
    if ctx is not None:
        return vocab_parallel_nll(logits, targets.long(), ctx).mean()
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


def tiny_pipeline_config(**overrides) -> LlamaConfig:
    """float32 toy Llama for parity tests: float32 end to end, as the JAX
    package's (whose bitwise stage composition holds only there), big
    enough for 2 stages."""
    kw = dict(vocab_size=64, n_embd=32, n_layer=2, n_head=4, n_kv_head=2,
              intermediate=64, n_positions=64, dtype=torch.float32,
              param_dtype=torch.float32, use_flash=False)
    kw.update(overrides)
    return LlamaConfig(**kw)


def analytic_bubble(pp: int, m: int) -> float:
    """Ideal 1F1B pipeline bubble fraction: (p-1)/(m+p-1)."""
    return (pp - 1) / (m + pp - 1) if pp > 1 else 0.0


# --------------------------------------------------------------------------- #
# Stage programs
# --------------------------------------------------------------------------- #


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A program's input (a tensor, or numpy from the data or a transport)
    on the stage's device."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


@dataclass
class StagePrograms:
    """The programs one pipeline stage runs.

    Non-last stages get `fwd` and `bwd`, the last stage the fused loss
    forward and backward `fwdbwd` (pp == 1 is first AND last: one fused
    program over the whole model). `accum` and `scale` are the microbatch
    gradient accumulation, leafwise, so the SAME arithmetic lands on every
    regrouping of the parameters. On the card every program runs on
    `stream`, a CUDA stream of the stage's own."""

    cfg: Any
    stage: int
    pp: int
    module: Any
    device: torch.device
    fwd: Optional[Callable] = None
    bwd: Optional[Callable] = None
    fwdbwd: Optional[Callable] = None
    accum: Callable = None
    scale: Callable = None
    stream: Any = None

    @property
    def is_first(self) -> bool:
        return self.stage == 0

    @property
    def is_last(self) -> bool:
        return self.stage == self.pp - 1


def build_stage_programs(cfg: LlamaConfig, stage: int, pp: int,
                         device=None, mesh=None) -> StagePrograms:
    """The programs for `stage` of a `pp`-deep Llama pipeline on `device`
    (the card unless "cpu" is asked for). Each takes the stage's parameters
    (a dict of the stage's global names) at every call. Recompute-in-
    backward: `bwd` and `fwdbwd` run the forward again under autograd, so
    the only tensors crossing stage boundaries are activations (forward)
    and their gradients (backward). With the stage's tp `mesh`, the
    parameters are DTensors on it (`shard_stage_params`) and the stage
    runs tensor-parallel; its boundaries are replicated over tp."""
    dev = resolve_device(device)
    module = LlamaStage(cfg, stage, pp, device="meta", mesh=mesh)
    first, last = stage == 0, stage == pp - 1
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    progs = StagePrograms(cfg=cfg, stage=stage, pp=pp, module=module,
                          device=dev, stream=stream)

    def leaves(params):
        return {k: v.detach().requires_grad_() for k, v in params.items()}

    def stage_input(x):
        """The input on the device: past stage 0 (which takes ids) a leaf
        whose gradient goes to the previous stage."""
        x = _to_device(x, dev)
        return x if first else x.detach().requires_grad_()

    def differentiate(out, p, x, grad_out):
        """Gradients of `out` by the params and, past stage 0, the input."""
        wrt = list(p.values()) + ([] if first else [x])
        grads = torch.autograd.grad(out, wrt, grad_out)
        gp = dict(zip(p, grads))
        return gp if first else (gp, grads[-1])

    if last:
        def fwdbwd(params, x, targets):
            with torch.enable_grad():
                p, x = leaves(params), stage_input(x)
                loss = token_xent(functional_call(module, p, (x,)),
                                  _to_device(targets, dev), module.mesh_ctx)
                out = differentiate(loss, p, x, None)
            loss = loss.detach()
            return (loss, out) if first else (loss, *out)
        progs.fwdbwd = fwdbwd
    else:
        def fwd(params, x):
            with torch.no_grad():
                return functional_call(module, params, (_to_device(x, dev),))

        def bwd(params, x, gy):
            with torch.enable_grad():
                p, x = leaves(params), stage_input(x)
                y = functional_call(module, p, (x,))
                return differentiate(y, p, x, _to_device(gy, dev))
        progs.fwd, progs.bwd = fwd, bwd

    def accum(a, b):
        return {k: a[k] + b[k] for k in a}

    def scale(t, c):
        return {k: v * c for k, v in t.items()}

    progs.accum, progs.scale = accum, scale
    return progs


def split_microbatches(batch, m: int) -> List[Any]:
    """Split the leading (batch) dim into `m` equal microbatches."""
    n = batch.shape[0]
    if m < 1 or n % m:
        raise ValueError(f"batch dim {n} not divisible into {m} microbatches")
    k = n // m
    return [batch[i * k:(i + 1) * k] for i in range(m)]


def seeded_batch(seed: int, step: int, batch: int, seq: int, vocab: int):
    """Deterministic (ids, targets) for a step, the JAX package's draws:
    both sides of an elastic-restart A/B and every rank of a gang derive
    the SAME data from (seed, step), so resumes stay bit-comparable without
    shipping batches around."""
    rng = np.random.default_rng(np.uint64((seed + 1) * 1_000_003 + step))
    ids = rng.integers(0, vocab, (batch, seq), dtype=np.int64).astype("int32")
    tg = rng.integers(0, vocab, (batch, seq), dtype=np.int64).astype("int32")
    return ids, tg


# --------------------------------------------------------------------------- #
# Transports
# --------------------------------------------------------------------------- #


class LocalPipeTransport:
    """In-process stage links: one FIFO per directed edge and kind ("act"
    forward, "grad" backward). The thread-driver harness. A CUDA tensor
    crosses streams with an event (the consumer's stream waits for the
    producer's work) and `record_stream` (its memory is not reused while
    the consumer's stream may still read it)."""

    def __init__(self, pp: int, timeout_s: float = 300.0):
        self._timeout = timeout_s
        self._q: Dict[tuple, "queue.Queue"] = {}
        for s in range(pp - 1):
            self._q[(s, s + 1, "act")] = queue.Queue()
            self._q[(s + 1, s, "grad")] = queue.Queue()

    def send(self, src: int, dst: int, kind: str, value) -> None:
        event = None
        if isinstance(value, torch.Tensor) and value.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(value.device))
        self._q[(src, dst, kind)].put((value, event))

    def recv(self, src: int, dst: int, kind: str):
        try:
            value, event = self._q[(src, dst, kind)].get(
                timeout=self._timeout)
        except queue.Empty:
            raise TimeoutError(
                f"pipeline edge {src}->{dst} [{kind}] starved for "
                f"{self._timeout}s: peer stage died or deadlocked")
        if event is not None:
            stream = torch.cuda.current_stream(value.device)
            stream.wait_event(event)
            value.record_stream(stream)
        return value

    def flush(self) -> None:
        pass


def _to_host(t: torch.Tensor):
    """A boundary tensor as host numpy: its values, or for bfloat16 (which
    numpy lacks) ("bfloat16", its bits as int16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return ("bfloat16", t.view(torch.int16).numpy())
    return t.numpy()


def _from_host(payload) -> torch.Tensor:
    if isinstance(payload, tuple):
        return torch.from_numpy(payload[1]).view(getattr(torch, payload[0]))
    return torch.from_numpy(payload)


class CollectivePipeTransport:
    """Stage links over the collective plane's p2p channels, kinds mapped
    to tags. Stage s is group rank `stage_rank(s)` (s itself by default;
    s * tp + t for tp rank t of a tensor-parallel stage, which talks to
    tp rank t of its neighbours). Boundaries cross as host numpy (the far
    side's program copies them onto its device). Sends go out as `isend`
    so the store write and GCS post overlap the next microbatch's compute;
    the p2p ack window (collective_p2p_ack_window) is the flow control.
    `flush()` joins every outstanding post and re-raises the first error:
    call it at step boundaries."""

    def __init__(self, group, stage_rank=None):
        self.group = group
        self._rank = stage_rank or (lambda s: s)
        self._handles: List[Any] = []

    def send(self, src: int, dst: int, kind: str, value) -> None:
        assert self._rank(src) == self.group.rank, (src, self.group.rank)
        self._handles.append(self.group.isend(_to_host(value),
                                              self._rank(dst), tag=kind))
        if len(self._handles) >= 32:  # bound handle growth mid-step
            self._handles.pop(0).wait()

    def recv(self, src: int, dst: int, kind: str):
        assert self._rank(dst) == self.group.rank, (dst, self.group.rank)
        return _from_host(self.group.recv(self._rank(src), tag=kind))

    def flush(self) -> None:
        handles, self._handles = self._handles, []
        for h in handles:
            h.wait()


# --------------------------------------------------------------------------- #
# Schedules
# --------------------------------------------------------------------------- #


@dataclass
class StageStats:
    """Busy-vs-wall accounting for one stage over one step. `busy_s` is
    time inside the stage's programs (device work included: each program
    ends with its stage stream's synchronize); everything else in `wall_s`
    is bubble and transport."""

    stage: int
    pp: int
    m: int
    schedule: str
    fwd_calls: int = 0
    bwd_calls: int = 0
    busy_s: float = 0.0
    wall_s: float = 0.0

    @property
    def bubble_frac(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.wall_s) if self.wall_s \
            else 0.0

    @property
    def analytic_bubble_frac(self) -> float:
        return analytic_bubble(self.pp, self.m)

    def as_dict(self) -> Dict[str, Any]:
        return {"stage": self.stage, "pp": self.pp, "m": self.m,
                "schedule": self.schedule, "fwd_calls": self.fwd_calls,
                "bwd_calls": self.bwd_calls,
                "busy_s": round(self.busy_s, 6),
                "wall_s": round(self.wall_s, 6),
                "bubble_frac": round(self.bubble_frac, 4),
                "analytic_bubble_frac": round(self.analytic_bubble_frac, 4)}


@dataclass
class StageRunResult:
    gsum: Any                      # microbatch-summed grads (NOT yet /m)
    loss_sum: Any                  # last stage only (a scalar tensor)
    stats: StageStats = None


def run_stage(programs: StagePrograms, params, transport, m: int,
              inputs: Optional[Sequence] = None,
              targets: Optional[Sequence] = None,
              schedule: str = "1f1b") -> StageRunResult:
    """Drive ONE stage through one step of `m` microbatches.

    The same loop implements both schedules: only the warm-up depth
    differs. With `warmup = min(pp-1-stage, m)` forwards in flight before
    the first backward, the steady state is one-forward-one-backward
    (1F1B); with `warmup = 0` every iteration forwards one microbatch and
    then BLOCKS on its gradient, which serializes the whole pipe per
    microbatch (the sequential A/B). Backward order is microbatch order
    either way, so gradients are bitwise-identical across schedules.

    `inputs` (stage 0) and `targets` (last stage) are per-microbatch
    lists; interior boundaries arrive over `transport`. On the card the
    stage's work runs on its own stream, which first waits for the work
    the caller's stream has queued (the optimizer's last update), and the
    caller's stream waits for the stage's at the end (the last loss add and
    gradient sum are not inside a timed program)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r} (use {SCHEDULES})")
    s, pp = programs.stage, programs.pp
    first, last = programs.is_first, programs.is_last
    if first and (inputs is None or len(inputs) != m):
        raise ValueError(f"stage 0 needs {m} input microbatches")
    if last and (targets is None or len(targets) != m):
        raise ValueError(f"last stage needs {m} target microbatches")
    stream = programs.stream
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(programs.device))
    stats = StageStats(stage=s, pp=pp, m=m, schedule=schedule)
    state = {"gsum": None, "loss": None, "fwd": 0, "bwd": 0}
    stash: deque = deque()          # stage INPUTS awaiting their backward

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if stream is not None:
            stream.synchronize()    # this stage's work only
        stats.busy_s += time.perf_counter() - t0
        return out

    def accumulate(g, loss=None):
        state["gsum"] = g if state["gsum"] is None \
            else timed(programs.accum, state["gsum"], g)
        if loss is not None:
            state["loss"] = loss if state["loss"] is None \
                else state["loss"] + loss

    t_wall = time.perf_counter()
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        if last:
            # The last stage is 1F1B by construction: each microbatch fuses
            # its forward and backward, grads stream out immediately.
            for k in range(m):
                if first:               # pp == 1
                    loss, gp = timed(programs.fwdbwd, params, inputs[k],
                                     targets[k])
                else:
                    x = transport.recv(s - 1, s, "act")
                    loss, gp, gx = timed(programs.fwdbwd, params, x,
                                         targets[k])
                    transport.send(s, s - 1, "grad", gx)
                accumulate(gp, loss)
                state["fwd"] += 1
                state["bwd"] += 1
        else:
            warmup = 0 if schedule == "sequential" else min(pp - 1 - s, m)

            def forward_one():
                k = state["fwd"]
                x = inputs[k] if first else transport.recv(s - 1, s, "act")
                y = timed(programs.fwd, params, x)
                transport.send(s, s + 1, "act", y)
                stash.append(x)
                state["fwd"] += 1

            def backward_one():
                gy = transport.recv(s + 1, s, "grad")
                x = stash.popleft()
                if first:
                    gp = timed(programs.bwd, params, x, gy)
                else:
                    gp, gx = timed(programs.bwd, params, x, gy)
                    transport.send(s, s - 1, "grad", gx)
                accumulate(gp)
                state["bwd"] += 1

            for _ in range(warmup):
                forward_one()
            while state["bwd"] < m:
                if state["fwd"] < m:
                    forward_one()
                backward_one()
    if stream is not None:      # the caller's work follows this stage's
        torch.cuda.current_stream(programs.device).wait_stream(stream)
    stats.wall_s = time.perf_counter() - t_wall
    stats.fwd_calls, stats.bwd_calls = state["fwd"], state["bwd"]
    return StageRunResult(gsum=state["gsum"], loss_sum=state["loss"],
                          stats=stats)


@dataclass
class PipelineStepResult:
    loss: float
    grads: List[Any]               # per-stage mean grads
    stage_stats: List[StageStats]
    makespan_s: float = 0.0

    @property
    def bubble_frac(self) -> float:
        """Pipeline-level bubble over the step makespan: idle area / total
        stage-time area. Per-stage `wall_s` ends when the stage drains, so
        the makespan (slowest stage) is the denominator: a stage that
        finishes early is idle for the remainder."""
        if not self.makespan_s:
            return 0.0
        pp = len(self.stage_stats)
        busy = sum(st.busy_s for st in self.stage_stats)
        return max(0.0, 1.0 - busy / (pp * self.makespan_s))


def run_pipeline_step(programs_list: Sequence[StagePrograms],
                      params_list: Sequence, ids, targets, m: int,
                      schedule: str = "1f1b",
                      transport: Optional[LocalPipeTransport] = None
                      ) -> PipelineStepResult:
    """One training step through an in-process pipeline: `pp` stage
    threads over queue links, each on its own CUDA stream on the card
    (PyTorch releases the GIL inside its ops, so stage threads overlap on
    the host; how far their kernels overlap is the card's to say). The
    measurement and test harness for the schedules; cross-process runs use
    `make_pipeline_train_fn`."""
    pp = len(programs_list)
    inputs = split_microbatches(ids, m)
    tgts = split_microbatches(targets, m)

    if pp == 1:
        t0 = time.perf_counter()
        res = run_stage(programs_list[0], params_list[0], None, m,
                        inputs=inputs, targets=tgts, schedule=schedule)
        makespan = time.perf_counter() - t0
        return PipelineStepResult(
            loss=res.loss_sum.item() / m,
            grads=[programs_list[0].scale(res.gsum, 1.0 / m)],
            stage_stats=[res.stats], makespan_s=makespan)

    transport = transport or LocalPipeTransport(pp)
    results: List[Optional[StageRunResult]] = [None] * pp
    errors: List[BaseException] = []
    start = threading.Barrier(pp + 1)
    caller = [torch.cuda.current_stream(p.device) if p.stream is not None
              else None for p in programs_list]

    def drive(si: int):
        progs = programs_list[si]
        try:
            # The caller's stream, not this thread's default: the stage
            # waits for the work the caller queued (the last update).
            ctx = torch.cuda.stream(caller[si]) if caller[si] is not None \
                else contextlib.nullcontext()
            with ctx:
                start.wait()
                results[si] = run_stage(
                    progs, params_list[si], transport, m,
                    inputs=inputs if si == 0 else None,
                    targets=tgts if si == pp - 1 else None,
                    schedule=schedule)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            start.abort()

    threads = [threading.Thread(target=drive, args=(si,), daemon=True,
                                name=f"pipe-stage-{si}")
               for si in range(pp)]
    for t in threads:
        t.start()
    try:
        start.wait()
    except threading.BrokenBarrierError:
        pass
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    makespan = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(r is None for r in results):
        raise TimeoutError("pipeline stage thread never finished")
    grads = [programs_list[si].scale(results[si].gsum, 1.0 / m)
             for si in range(pp)]
    return PipelineStepResult(
        loss=results[pp - 1].loss_sum.item() / m, grads=grads,
        stage_stats=[r.stats for r in results], makespan_s=makespan)


# --------------------------------------------------------------------------- #
# Adam, leafwise by name
# --------------------------------------------------------------------------- #


def _adam(params: Dict[str, torch.Tensor], lr: float):
    return torch.optim.Adam(list(params.values()), lr=lr, betas=ADAM_BETAS,
                            eps=ADAM_EPS)


def adam_state(params: Dict[str, Any], optimizer=None) -> Dict[str, Any]:
    """The Adam state of a stage by parameter name, {name: {"step",
    "exp_avg", "exp_avg_sq"}}: names, not the optimizer's indices, so a
    checkpoint regroups at any pp. Zeros (step 0) where the optimizer has
    no state yet, which Adam's first step treats as a fresh state."""
    out = {}
    for name, p in params.items():
        st = optimizer.state.get(p, {}) if optimizer is not None else {}
        if st:
            out[name] = {"step": st["step"], "exp_avg": st["exp_avg"],
                         "exp_avg_sq": st["exp_avg_sq"]}
        else:
            out[name] = {"step": torch.tensor(0.0),
                         "exp_avg": torch.zeros_like(p),
                         "exp_avg_sq": torch.zeros_like(p)}
    return out


def load_adam_state(optimizer, params: Dict[str, torch.Tensor],
                    by_name: Dict[str, Any]) -> None:
    """Give `optimizer` (built over `params`' values, in order) the state
    `adam_state` returned (each moment copied onto its parameter's
    device)."""
    sd = optimizer.state_dict()
    sd["state"] = {i: {k: by_name[name][k].clone() for k in
                       ("step", "exp_avg", "exp_avg_sq")}
                   for i, name in enumerate(params)}
    optimizer.load_state_dict(sd)


# --------------------------------------------------------------------------- #
# In-process trainer (tests / chip_smoke)
# --------------------------------------------------------------------------- #


class LocalPipelineTrainer:
    """pp-stage Llama training in one process: the whole model's seeded
    init (identical initial weights at EVERY pp), a torch.optim.Adam per
    stage with optax.adam's defaults (leafwise, so updates are bitwise
    width-invariant), threads and queues for the schedule. The A/B harness
    behind the parity tests and chip_smoke's pipeline phase."""

    def __init__(self, cfg: LlamaConfig, pp: int = 1,
                 num_microbatches: int = 2, lr: float = 1e-2, seed: int = 0,
                 schedule: str = "1f1b", batch: int = 4, seq: int = 16,
                 device=None):
        self.cfg, self.pp, self.m = cfg, pp, num_microbatches
        self.schedule = schedule
        self.batch, self.seq = batch, seq
        self.device = resolve_device(device)
        stages = [LlamaStage(cfg, s, pp, device=self.device, seed=seed)
                  for s in range(pp)]
        self.params = [dict(st.named_parameters()) for st in stages]
        self.programs = [build_stage_programs(cfg, s, pp, self.device)
                         for s in range(pp)]
        self.optimizers = [_adam(p, lr) for p in self.params]
        self.step_count = 0
        self.last_result: Optional[PipelineStepResult] = None

    def train_step(self, ids, targets) -> Dict[str, Any]:
        res = run_pipeline_step(self.programs, self.params, ids, targets,
                                self.m, schedule=self.schedule)
        for params, opt, grads in zip(self.params, self.optimizers,
                                      res.grads):
            for name, p in params.items():
                p.grad = grads[name]
            opt.step()
            opt.zero_grad(set_to_none=True)
        self.step_count += 1
        self.last_result = res
        return {"loss": res.loss, "step": self.step_count,
                "bubble_frac": res.bubble_frac,
                "makespan_s": res.makespan_s}

    def merged_params(self) -> Dict[str, torch.Tensor]:
        return merge_stage_params(
            [{k: v.detach() for k, v in p.items()} for p in self.params])

    def merged_adam_state(self) -> Dict[str, Any]:
        return merge_stage_params(
            [adam_state(p, o) for p, o in zip(self.params,
                                               self.optimizers)])


# --------------------------------------------------------------------------- #
# Stage checkpoints (elastic resharding)
# --------------------------------------------------------------------------- #


def stage_state_template(cfg: LlamaConfig, stage: int, pp: int
                         ) -> Dict[str, Any]:
    """Keys and shapes (meta tensors: no memory) of one stage's {"params",
    "opt"} subtree at ANY pp, which is what lets a restore re-split a
    checkpoint saved at another width: names are GLOBAL (layer index, not
    stage-local), so the manifest's keys match whatever pp."""
    ranges = stage_layer_ranges(cfg, pp)
    params = {name: torch.empty(shape, device="meta",
                                dtype=cfg.param_dtype)
              for name, shape in _param_shapes(cfg)
              if _stage_of(name, ranges) == stage}
    opt = {name: {"step": torch.empty((), device="meta"),
                  "exp_avg": p, "exp_avg_sq": p}
           for name, p in params.items()}
    return {"params": params, "opt": opt}


def save_pipeline_stage(path: str, stage_state: Dict[str, Any], stage: int,
                        pp: int, step: Optional[int] = None,
                        tp_rank: int = 0, tp: int = 1) -> str:
    """Save one stage's disjoint subtree ({"params", "opt"}), from each of
    the stage's `tp` ranks (`tp_rank` this one; its DTensor leaves write
    their shards). `own_replicated=True` because NO other stage holds this
    stage's keys: rank 0 owning replicated leaves (the SPMD default) would
    leave the other stages' norm scales and Adam steps with no coverage
    and fail the merge, which runs over `pp * tp` ranks."""
    from ray_tpu_torch.train.checkpoint import save_sharded_pytree

    return save_sharded_pytree(path, stage_state,
                               process_index=stage * tp + tp_rank,
                               process_count=pp * tp,
                               meta={"step": step, "pp": pp, "tp": tp},
                               own_replicated=True)


def restore_pipeline_stage(path: str, cfg: LlamaConfig, stage: int, pp: int,
                           mesh=None, device=None) -> Dict[str, Any]:
    """Restore ONE stage's subtree at the CURRENT (possibly different)
    width from a merged stage checkpoint, on `device` (the card unless
    "cpu" is asked for): raw-byte assembly, so the round trip is bitwise at
    any (tp, pp) -> (tp', pp'). With a stage `mesh`, params and Adam's
    moments land as DTensors on it, placed by the Llama partition rules."""
    from ray_tpu_torch.parallel.sharding import placements_by_rules
    from ray_tpu_torch.train.checkpoint import restore_sharded_pytree

    dev = resolve_device(device)
    tpl = stage_state_template(cfg, stage, pp)
    shardings = None if mesh is None else {"params": placements_by_rules(
        tpl["params"], mesh, LLAMA_PARTITION_RULES)}
    state = restore_sharded_pytree(path, target=tpl, shardings=shardings)
    if mesh is None:
        state["params"] = {k: v.to(dev) for k, v in state["params"].items()}

    def moment(name, t):
        like = state["params"][name]
        return place_like(t, like) if mesh is not None else t.to(dev)

    state["opt"] = {k: {"step": v["step"],
                        "exp_avg": moment(k, v["exp_avg"]),
                        "exp_avg_sq": moment(k, v["exp_avg_sq"])}
                    for k, v in state["opt"].items()}
    return state


# --------------------------------------------------------------------------- #
# WorkerGroup train fn (one rank per stage, elastic across restarts)
# --------------------------------------------------------------------------- #


def pipeline_mesh_spec(tp: int = 1) -> MeshSpec:
    """The mesh a `make_pipeline_train_fn(tp=tp)` run is given
    (`TorchConfig(mesh=...)`): stages along "pp", as many as the world
    holds, each of `tp` consecutive ranks along "tp"."""
    return MeshSpec({"pp": -1, "tp": tp})


def make_pipeline_train_fn(steps: int = 6, microbatches: int = 2,
                           batch: int = 4, seq: int = 16, lr: float = 1e-2,
                           seed: int = 0, ckpt_dir: Optional[str] = None,
                           tp: int = 1, schedule: str = "1f1b",
                           cfg_overrides: Optional[Dict[str, Any]] = None):
    """A train_loop_per_worker where pp x tp == session.get_world_size():
    rank r drives stage r // tp (as its tp rank r % tp) over the collective
    p2p plane, on the session's device, data comes deterministically from
    (seed, step), and EVERY step checkpoints the stage subtree and merges
    on rank 0, so when the gang restarts at a different world size (a
    killed stage, an elastic shrink), the loop resumes from the merged
    manifest re-split at the NEW pp, bit-exact.

    tp > 1 is the JAX package's (tp, pp) layout with tp as processes: the
    run needs the mesh `pipeline_mesh_spec(tp)` (`TorchConfig(mesh=...)`,
    which forms the torch.distributed group), each stage's parameters and
    Adam moments are DTensors on its tp line, the stage runs
    tensor-parallel, and rank (s, t) exchanges the replicated boundaries
    with (s +- 1, t)."""
    if ckpt_dir is None:
        raise ValueError("make_pipeline_train_fn needs a ckpt_dir")
    overrides = dict(cfg_overrides or {})

    def train_fn(config):
        from ray_tpu_torch.train import session
        from ray_tpu_torch.train.checkpoint import (Checkpoint,
                                                    merge_sharded_manifest)

        world = session.get_world_size()
        rank = session.get_world_rank()
        device = session.get_device()
        if world % tp:
            raise ValueError(f"world {world} is not a multiple of tp={tp}")
        pp, stage, tp_rank = world // tp, rank // tp, rank % tp
        cfg = tiny_pipeline_config(**overrides)
        mesh = None
        if tp > 1:
            full = session.get_mesh()
            if full is None or dict(zip(full.mesh_dim_names,
                                        full.mesh.shape)) != {"pp": pp,
                                                              "tp": tp}:
                raise ValueError(
                    f"tp={tp} needs the run's mesh pipeline_mesh_spec({tp}) "
                    f"(TorchConfig(mesh=...)); the session has {full}")
            mesh = full["tp"]

        ckpt = session.get_checkpoint()
        if ckpt is not None:
            d = ckpt.to_dict()
            start = int(d["step"]) + 1
            state = restore_pipeline_stage(d["path"], cfg, stage, pp,
                                           mesh=mesh, device=device)
            params = state["params"]
        else:
            start, state = 0, None
            params = dict(LlamaStage(cfg, stage, pp, device=device,
                                     seed=seed).named_parameters())
            if mesh is not None:
                params = shard_stage_params(
                    {k: v.detach() for k, v in params.items()}, mesh)
        params = {k: torch.nn.Parameter(v) for k, v in params.items()}
        opt = _adam(params, lr)
        if state is not None:
            load_adam_state(opt, params, state["opt"])
        programs = build_stage_programs(cfg, stage, pp, device, mesh=mesh)
        group = session.get_collective() if world > 1 else None
        transport = None
        if group is not None and pp > 1:
            transport = CollectivePipeTransport(
                group, stage_rank=lambda s: s * tp + tp_rank)

        for step in range(start, steps):
            ids, tg = seeded_batch(seed, step, batch, seq, cfg.vocab_size)
            inputs = split_microbatches(ids, microbatches) if stage == 0 \
                else None
            tgts = split_microbatches(tg, microbatches) \
                if stage == pp - 1 else None
            res = run_stage(programs, params, transport, microbatches,
                            inputs=inputs, targets=tgts, schedule=schedule)
            grads = programs.scale(res.gsum, 1.0 / microbatches)
            for name, p in params.items():
                p.grad = grads[name]
            opt.step()
            opt.zero_grad(set_to_none=True)
            if transport is not None:
                transport.flush()

            path = os.path.join(ckpt_dir, f"step_{step:05d}_w{world}")
            save_pipeline_stage(
                path, {"params": {k: v.detach() for k, v in params.items()},
                       "opt": adam_state(params, opt)},
                stage, pp, step=step, tp_rank=tp_rank, tp=tp)
            if group is not None:
                group.barrier()     # every stage saved before the merge
            metrics = {"step": step, "world": world, "tp": tp,
                       **res.stats.as_dict()}
            if res.loss_sum is not None:
                metrics["loss"] = res.loss_sum.item() / microbatches
            if rank == 0:
                if world > 1:
                    merge_sharded_manifest(path, world)
                session.report(metrics, checkpoint=Checkpoint.from_dict(
                    {"path": path, "step": step, "pp": pp, "tp": tp}))
            else:
                session.report(metrics)
        return {"final_step": steps - 1, "stage": stage, "world": world}

    return train_fn
