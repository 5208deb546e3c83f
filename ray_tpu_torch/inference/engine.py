"""Continuous-batching inference engine (Orca-style iteration scheduling).

Counterpart of `ray_tpu/inference/engine.py`, on PyTorch. The serving batch
is re-formed every decode step instead of every request: finished sequences
leave their batch slot immediately, queued requests are admitted into freed
slots, and long prompts prefill in fixed-size chunks interleaved with decode
steps so token emission never stalls behind a new arrival. K/V lives in a
paged arena (`kv_cache.BlockManager` + `models/llama.py:decode_paged`);
when the arena runs out of blocks the engine preempts the lowest-priority
sequence — frees its blocks and re-queues it for recompute — so the answer
to memory pressure is degraded latency, never an OOM.

Two step programs serve every request mix, each over one fixed shape:

- prefill: [1, prefill_chunk] tokens of one sequence (padded chunk),
- decode:  [batch_slots, 1] — one token for every running slot.

Speculative decoding (spec_decode_draft_len > 0) swaps the decode step
for three more fixed-shape programs — draft prefill [1, chunk], propose
(k+1 draft steps), verify [batch_slots, k+1]; greedy verification makes
the emitted tokens identical to plain decoding, whatever the draft
proposes.

The programs are plain functions over those shapes: PyTorch runs eagerly,
so where the reference counts jit compiles, `stats()` counts the distinct
argument shapes each program has seen (the reference's own fallback), and
one shape per program is the discipline. The arenas are updated in place
(the counterpart of the reference's donated buffers): no step copies them.
Block tables, positions and masks are built in numpy on the host and cross
to the device in one copy per program call; reading the step's tokens back
is its one synchronisation.

A radix prefix cache (prefix_cache_enabled, continuous scheduling)
keeps finished sequences' full-block KV prefixes refcounted in the
arena; a new request adopts its longest cached match and prefills only
the tail. Cached blocks are reclaimed LRU-by-leaf under pressure before
any live sequence is preempted.

The engine core is synchronous and single-threaded (`step()`); tests drive
it directly. `EngineLoop` runs it on a background thread; token/finish
callbacks are fired outside the engine lock so they may bounce into an
asyncio loop safely. The Serve deployment (`LLMServer`) waits for the port
of the actor runtime.

`scheduling="static"` emulates the request-level `@serve.batch` baseline
(gang admission, batch drains at the speed of its longest member, results
delivered only when the whole gang finishes) through the same compute
path.

Tensor-parallel serving (`mesh` with a "tp" axis) is a lockstep engine:
every tp rank builds one on its shards (the model's heads, MLP and vocab,
the arenas' KV heads, the LoRA bank's `ao`), the rank at tp coordinate 0
schedules and takes requests, and before each program call it sends the
step's record to the others, whose `follow()` runs the same program on
theirs (`lockstep.py`). The greedy pick gathers the vocab shards' best
(`vocab_parallel_argmax`), so every rank gets the same tokens and none
crosses back.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ray_tpu_torch._torch_env import same_device
from ray_tpu_torch.inference import lockstep
from ray_tpu_torch.inference.kv_cache import BlockManager, RadixPrefixCache
from ray_tpu_torch.observability import tracing as _tracing
from ray_tpu_torch.parallel.tensor_parallel import vocab_parallel_argmax

logger = logging.getLogger(__name__)

# Request states.
WAITING = "WAITING"      # queued (fresh, or preempted awaiting recompute)
PREFILL = "PREFILL"      # in a slot, prompt (+ recomputed tokens) mid-chunk
DECODE = "DECODE"        # in a slot, emitting one token per step
FINISHED = "FINISHED"
FAILED = "FAILED"
_DONE_HOLD = "DONE_HOLD"  # static mode: finished but holding its gang slot


@dataclass(frozen=True)
class EngineConfig:
    model_size: str = "tiny"        # LlamaConfig preset (tiny/small/7b)
    max_model_len: int = 256        # positions preset for tiny
    batch_slots: int = 4            # fixed decode batch width
    block_size: int = 16            # KV tokens per block
    num_blocks: int = 64            # arena size (incl. trash block 0)
    max_blocks_per_seq: int = 8     # block-table width => max context
    prefill_chunk: int = 16         # prompt tokens per prefill step
    eos_id: Optional[int] = None    # stop token (None = budget only)
    # (The reference's `use_jit` has no counterpart: PyTorch runs eagerly.)
    scheduling: str = "continuous"  # or "static" (@serve.batch emulation)
    # Model multiplexing (docs/MULTITENANCY.md): >0 hosts that many
    # LoRA-style adapters on this engine — one shared paged arena, the
    # SAME two step programs (adapter routing is a per-row index
    # argument), per-replica LRU residency. 0 = classic single model.
    max_adapters: int = 0
    lora_rank: int = 8
    # None = resolve from the global flag table (`core/config.py`) at
    # engine construction, so deployments pick them up via RAY_TPU_* env
    # vars without a config plumb-through.
    prefix_cache_enabled: Optional[bool] = None
    spec_decode_draft_len: Optional[int] = None
    slo_default_class: Optional[str] = None
    slo_interactive_reserved_slots: Optional[int] = None

    @property
    def max_context(self) -> int:
        return self.max_blocks_per_seq * self.block_size


@dataclass
class Request:
    request_id: str
    prompt: List[int]
    max_new_tokens: int
    arrival: int                      # admission priority (lower = older)
    on_token: Optional[Callable] = None    # (req, token) per emitted token
    on_finish: Optional[Callable] = None   # (req) once, FINISHED or FAILED
    state: str = WAITING
    generated: List[int] = field(default_factory=list)
    error: Optional[str] = None
    preemptions: int = 0
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None    # first batch-slot admission
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # Trace context captured at submission: the engine's queue/prefill/
    # decode phase spans (a TTFT decomposition) re-parent to it.
    trace_ctx: Optional[Dict] = None
    # Model multiplexing: which adapter this request routes through
    # (None = base model, bank row 0 identity).
    model_id: Optional[str] = None
    adapter_row: int = 0
    # SLO class ("interactive" | "batch"): admission/prefill priority and
    # preemption victim order.
    slo_class: str = "interactive"
    # Prefix-cache accounting: prompt tokens whose KV was adopted from
    # the radix cache instead of prefilled (across all admissions).
    cached_tokens: int = 0
    # Scheduler-internal:
    slot: Optional[int] = None
    processed: int = 0                # tokens written into the KV cache
    cur_token: Optional[int] = None   # next decode input
    _held_emits: List[tuple] = field(default_factory=list)
    _pinned_node: Any = None          # radix node pinned while scheduled

    @property
    def total_to_prefill(self) -> int:
        # Recompute after preemption replays prompt + already-generated.
        return len(self.prompt) + len(self.generated)

    @property
    def done(self) -> bool:
        return self.state in (FINISHED, FAILED)


class InferenceEngine:
    """Synchronous engine core; every public method takes the engine lock.

    `model` may be injected (tests share one tiny model with their
    reference loop); by default the config's Llama preset is built with
    random weights from seed 0 on `device` (the card unless the caller
    passes `device="cpu"`). An injected model fixes the device: asking for
    another one raises. The engine serves from `model.compute_copy()`, its
    dense weights cast to the compute dtype once, here (the same values the
    reference's per-call cast gives). `draft_model` is the speculative
    draft (default: the target's first n_layer // 2 layers, sharing its
    weights).

    `mesh` (a DeviceMesh whose axes other than "tp" have size 1) serves
    tensor-parallel: `model` and `draft_model` are None or placed on that
    mesh (`Llama(mesh=)`), a model on a mesh is served only with it, the
    truncated draft shares the target's shards, the arenas hold this
    rank's KV heads and the adapter banks its slice of `ao`. Every rank of the
    process group builds its engine on the same mesh at the same time. The
    rank at tp coordinate 0 (`is_leader`) schedules, takes the requests and
    sends each step's record; every other rank runs `follow()`, on a
    thread of its own, until the leader's `stop_followers()`.
    """

    def __init__(self, config: EngineConfig, model=None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None, draft_model=None):
        from ray_tpu_torch.core.config import GLOBAL_CONFIG
        from ray_tpu_torch.models.llama import Llama

        cfg = config
        if cfg.scheduling not in ("continuous", "static"):
            raise ValueError(f"unknown scheduling {cfg.scheduling!r}")
        if cfg.max_blocks_per_seq * cfg.block_size < cfg.prefill_chunk:
            raise ValueError("prefill_chunk exceeds the per-seq context")
        self._mesh = mesh
        self._tp = 1
        self._lockstep = None
        if mesh is not None:
            from ray_tpu_torch.models.llama import validate_tp
            from ray_tpu_torch.parallel.mesh import axis_size, mesh_shape_summary

            other = {name: n for name, n in mesh_shape_summary(mesh).items()
                     if name != "tp" and n > 1}
            if other:
                raise ValueError(f"serving shards over tp alone; the mesh "
                                 f"also has {other}")
            self._tp = axis_size(mesh, "tp")
            validate_tp(model.config if model is not None else
                        self._preset(cfg), self._tp)
        for m in (model, draft_model):
            if m is not None and (m.mesh_ctx.mesh if m.mesh_ctx is not None
                                  else None) is not mesh:
                raise ValueError("a model served on a mesh is placed on "
                                 "that mesh first (Llama(mesh=)), and one "
                                 "placed on a mesh is served with it "
                                 "(mesh=)")
        if mesh is not None:
            self._lockstep = lockstep.Lockstep(mesh)
        self.config = cfg
        # Explicit config wins, else the global flag table.
        self._draft_len = int(
            cfg.spec_decode_draft_len
            if cfg.spec_decode_draft_len is not None
            else GLOBAL_CONFIG.spec_decode_draft_len)
        self._slo_default = str(
            cfg.slo_default_class if cfg.slo_default_class is not None
            else GLOBAL_CONFIG.slo_default_class)
        if self._slo_default not in ("interactive", "batch"):
            raise ValueError(
                f"unknown slo_default_class {self._slo_default!r}")
        self._slo_reserved = min(
            cfg.batch_slots - 1,
            max(0, int(cfg.slo_interactive_reserved_slots
                       if cfg.slo_interactive_reserved_slots is not None
                       else GLOBAL_CONFIG.slo_interactive_reserved_slots)))
        prefix_enabled = (
            cfg.prefix_cache_enabled if cfg.prefix_cache_enabled is not None
            else bool(GLOBAL_CONFIG.prefix_cache_enabled))
        if model is None:
            model = Llama(self._preset(cfg), device=device, seed=0,
                          mesh=mesh)
        elif device is not None and not same_device(torch.device(device),
                                                    model.device):
            raise ValueError(f"the model lies on {model.device}; the "
                             f"engine was asked for {device}")
        self._device = model.device
        self._model = model.compute_copy()
        self._bm = BlockManager(cfg.num_blocks, cfg.block_size)
        self._arenas = self._new_arenas(self._model)
        # Radix prefix cache (continuous scheduling only: static gangs
        # hold finished members' blocks for the drain, which fights the
        # donate-to-cache lifecycle and the baseline it emulates never
        # had prefix reuse anyway).
        self._prefix: Optional[RadixPrefixCache] = None
        if prefix_enabled and cfg.scheduling == "continuous":
            self._prefix = RadixPrefixCache(self._bm)
        # Speculative decoding: the draft shares the target's BLOCK
        # TABLES (host bookkeeping) but writes its own arenas — same
        # geometry, so one table addresses both. Default draft: the
        # TRUNCATED target (its first n_layer//2 blocks plus its embed/
        # final-norm/lm-head, weights shared by reference) — an early-exit
        # draft that agrees with the target on easy tokens for free.
        # Greedy verify makes the output independent of draft quality
        # either way; a better draft just accepts more.
        self._draft_model = None
        self._draft_arenas = None
        if self._draft_len > 0:
            if draft_model is None:
                import dataclasses as _dc

                dcfg = _dc.replace(model.config,
                                   n_layer=max(1, model.config.n_layer // 2))
                keep = tuple(f"layers.{i}." for i in range(dcfg.n_layer))
                state = {name: t
                         for name, t in self._model.state_dict().items()
                         if not name.startswith("layers.")
                         or name.startswith(keep)}
                self._draft_model = Llama(dcfg, device=self._device,
                                          state=state, mesh=mesh)
            else:
                if not same_device(self._device, draft_model.device):
                    raise ValueError("the draft model lies on another "
                                     "device than the target")
                self._draft_model = draft_model.compute_copy()
            self._draft_arenas = self._new_arenas(self._draft_model)
        # Model multiplexing: the adapter bank + residency bookkeeping.
        # `adapter_source(model_id) -> per-layer rows` is registered by
        # the deployment so a miss loads on demand.
        self._adapters = None
        self._adapter_source = None
        if cfg.max_adapters > 0:
            from ray_tpu_torch.inference.adapters import AdapterManager

            self._adapters = AdapterManager(model.config, cfg.max_adapters,
                                            cfg.lora_rank, mesh=mesh,
                                            device=self._device)
        self._slots: List[Optional[Request]] = [None] * cfg.batch_slots
        self._waiting: List[Request] = []     # kept sorted by arrival
        self._live: Dict[str, Request] = {}   # request_id -> live request
        self._lock = threading.RLock()
        self._arrival_seq = itertools.count()
        self._req_seq = itertools.count()
        # Stats.
        self._tokens_emitted = 0
        self._finished = 0
        self._failed = 0
        self._preemptions = 0
        self._recomputed_tokens = 0
        self._started_at: Optional[float] = None
        self._rate_window: List[tuple] = []   # (t, n) recent emissions
        self._shapes = {"prefill": set(), "decode": set(),
                        "draft_prefill": set(), "propose": set(),
                        "verify": set()}
        # Spec-decode accounting: accepted-length histogram [0..k] per
        # verify round (index a = rounds that accepted exactly a drafts).
        self._spec_rounds = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_hist = [0] * (self._draft_len + 1)
        self._programs = {"prefill": self._prefill_fn,
                          "decode": self._decode_fn}
        if self._draft_len > 0:
            self._programs.update(draft_prefill=self._draft_prefill_fn,
                                  propose=self._propose_fn,
                                  verify=self._verify_fn)
        self._last_stats = self._stats_locked()

    @staticmethod
    def _preset(cfg: EngineConfig):
        from ray_tpu_torch.models.llama import LlamaConfig

        return {"tiny": LlamaConfig.tiny(seq=cfg.max_model_len),
                "small": LlamaConfig.small(),
                "7b": LlamaConfig.llama7b()}[cfg.model_size]

    def _new_arenas(self, model):
        from ray_tpu_torch.models.llama import make_paged_arena

        return make_paged_arena(model.config, self.config.num_blocks,
                                self.config.block_size, device=self._device,
                                mesh=self._mesh)

    @property
    def is_leader(self) -> bool:
        """Whether this engine schedules: always without a mesh, the rank
        at tp coordinate 0 on one."""
        return self._lockstep is None or self._lockstep.is_leader

    # ----------------------------------------------------------- programs
    #
    # Each program takes the arenas it writes in place and the step's
    # arguments as device tensors, in the order `_call` uploads them; the
    # multiplexed engine appends the per-row adapter index, and the banks
    # ride along from the adapter manager.

    def _lora(self, aidx):
        if self._adapters is None:
            return None, None
        return self._adapters.device_banks(), aidx

    def _pick(self, logits):
        """Greedy tokens of `logits` [..., vocab] (this rank's vocab shard
        on a mesh: the same tokens on every rank)."""
        return vocab_parallel_argmax(logits, self._model.mesh_ctx)

    def _prefill_fn(self, arenas, ids, bt, pos, wmask, last_idx, aidx=None):
        logits, _ = self._model.decode_paged(ids, arenas, bt, pos, wmask,
                                             *self._lora(aidx))
        rows = torch.arange(ids.shape[0], device=ids.device)
        return self._pick(logits[rows, last_idx])

    def _decode_fn(self, arenas, toks, bt, pos, wmask, aidx=None):
        logits, _ = self._model.decode_paged(toks, arenas, bt, pos, wmask,
                                             *self._lora(aidx))
        return self._pick(logits[:, -1])

    def _verify_fn(self, arenas, toks, bt, pos, wmask, aidx=None):
        logits, _ = self._model.decode_paged(toks, arenas, bt, pos, wmask,
                                             *self._lora(aidx))
        return self._pick(logits)                     # [B, k+1]

    def _draft_prefill_fn(self, darenas, ids, bt, pos, wmask):
        # Keeps the draft's KV in lockstep with the target's.
        self._draft_model.decode_paged(ids, darenas, bt, pos, wmask)

    def _propose_fn(self, darenas, toks, bt, pos, wmask_seq):
        """k+1 draft decode steps ([B, 1] each; the reference's lax.scan).
        wmask_seq [k+1, B, 1]: per-step write masks (rows near their
        context limit mask the tail — masked writes land in the trash
        block, their logits are never used). Step j writes its INPUT
        token's KV at pos+j and emits the argmax proposal for position
        pos+j+1, so the k+1 steps leave the draft KV complete through
        pos+k. Returns the proposals [B, k+1]."""
        props = []
        tok, p = toks, pos
        for wm in wmask_seq:
            logits, _ = self._draft_model.decode_paged(tok, darenas, bt, p,
                                                       wm)
            nxt = self._pick(logits[:, -1])
            props.append(nxt)
            tok, p = nxt[:, None], p + 1
        return torch.stack(props, dim=1)

    def _program_compiles(self, name: str) -> int:
        """Distinct argument shapes the program has seen (0 when the
        engine has no such program)."""
        if name not in self._programs:
            return 0
        return len(self._shapes[name])

    # ---------------------------------------------------------- submission

    def register_adapter_source(self, fn: Callable[[str], list]) -> None:
        """Install the on-demand adapter loader: fn(model_id) returns
        the per-layer (aq, bq, ao, bo) rows (e.g. `make_adapter_weights`
        from the adapter's registered seed)."""
        self._adapter_source = fn

    def adapter_stats(self) -> Optional[Dict[str, Any]]:
        if self._adapters is None:
            return None
        with self._lock:
            return self._adapters.stats()

    def _resolve_adapter_locked(self, model_id: Optional[str]) -> int:
        if model_id is None:
            return 0
        if self._adapters is None:
            raise ValueError(
                f"request names model {model_id!r} but the engine is not "
                "multiplexed (max_adapters=0)")
        if self._adapter_source is None:
            raise ValueError("no adapter source registered")
        # Rows of live requests are pinned: LRU must never evict weights
        # a mid-flight (or queued) generation still routes through.
        pinned = {r.adapter_row for r in self._live.values()
                  if r.adapter_row}
        return self._adapters.ensure(model_id, self._adapter_source,
                                     pinned_rows=pinned)

    def add_request(self, prompt: List[int],
                    max_new_tokens: int = 16,
                    on_token: Optional[Callable] = None,
                    on_finish: Optional[Callable] = None,
                    request_id: Optional[str] = None,
                    model_id: Optional[str] = None,
                    slo_class: Optional[str] = None) -> Request:
        cfg = self.config
        if not self.is_leader:
            raise RuntimeError("a tp follower takes no requests: the rank "
                               "at tp coordinate 0 schedules them")
        prompt = [int(t) for t in prompt] or [0]
        max_new_tokens = max(1, int(max_new_tokens))
        slo = slo_class if slo_class is not None else self._slo_default
        if slo not in ("interactive", "batch"):
            raise ValueError(f"unknown slo_class {slo!r} "
                             "(expected 'interactive' or 'batch')")
        total = len(prompt) + max_new_tokens
        if total > cfg.max_context or not self._bm.fits(total):
            raise ValueError(
                f"request needs {total} token slots; engine caps at "
                f"{min(cfg.max_context, self._bm.capacity * cfg.block_size)}"
                f" (max_blocks_per_seq={cfg.max_blocks_per_seq}, "
                f"num_blocks={cfg.num_blocks})")
        with self._lock:
            rid = request_id or f"req-{next(self._req_seq)}"
            if rid in self._live:
                # Reject NOW: a duplicate reaching _admit would raise out
                # of step() and trip the circuit breaker for everyone.
                raise ValueError(f"request id {rid!r} is already live")
            # Adapter residency resolves at submit (load-on-miss, LRU
            # evict): a failure rejects THIS request instead of raising
            # out of step() for everyone.
            adapter_row = self._resolve_adapter_locked(model_id)
            req = Request(
                request_id=rid,
                prompt=prompt, max_new_tokens=max_new_tokens,
                arrival=next(self._arrival_seq),
                on_token=on_token, on_finish=on_finish,
                submitted_at=time.monotonic(),
                trace_ctx=_tracing.capture(),
                model_id=model_id, adapter_row=adapter_row,
                slo_class=slo)
            self._live[rid] = req
            # Queue order is (class, arrival): interactive ahead of
            # batch, FIFO within a class.
            self._waiting.append(req)
            self._waiting.sort(key=self._prio)
            if self._started_at is None:
                self._started_at = time.monotonic()
        return req

    def cancel(self, request_id: str) -> bool:
        """Abort one request (client disconnected mid-stream): free its
        slot and blocks immediately so live traffic isn't stuck behind a
        generation nobody is reading. True if it was still live."""
        emissions: List[tuple] = []
        with self._lock:
            req = self._live.get(request_id)
            if req is None or req.done or req.state == _DONE_HOLD:
                return False   # gone, or already complete (static hold)
            if req.state == WAITING:
                self._waiting.remove(req)
            self._finish(req, emissions, error="cancelled")
        for fn, args in emissions:
            try:
                fn(*args)
            except Exception:  # noqa: BLE001
                pass
        return True

    def has_work(self) -> bool:
        with self._lock:
            # Any occupied slot is work: static DONE_HOLD members still
            # need their gang-release step.
            return bool(self._waiting) or any(
                r is not None for r in self._slots)

    # ---------------------------------------------------------------- step

    def step(self) -> bool:
        """One scheduler iteration: admit, one prefill chunk, one decode
        step. Returns whether any work ran. Callbacks fire after the lock
        is released (they may hop into an asyncio loop)."""
        emissions: List[tuple] = []
        with self._lock:
            self._release_static_gang(emissions)
            self._admit()
            ran = self._prefill_step(emissions)
            if self._draft_len > 0:
                ran = self._spec_decode_step(emissions) or ran
            else:
                ran = self._decode_step(emissions) or ran
        for fn, args in emissions:
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 — user callback must not
                pass           # take down the scheduler
        return ran

    def run_until_idle(self, max_steps: int = 10000) -> int:
        """Drive the loop synchronously (tests / offline batch); returns
        steps taken."""
        steps = 0
        while self.has_work():
            if steps >= max_steps:
                raise RuntimeError(f"engine not idle after {max_steps} steps")
            self.step()
            steps += 1
        return steps

    # ----------------------------------------------------------- admission

    def _scheduled(self) -> List[Request]:
        return [r for r in self._slots if r is not None]

    @staticmethod
    def _prio(req: Request):
        return (0 if req.slo_class == "interactive" else 1, req.arrival)

    def _unpin_req(self, req: Request) -> None:
        if req._pinned_node is not None and self._prefix is not None:
            self._prefix.unpin(req._pinned_node)
        req._pinned_node = None

    def _admit(self):
        cfg = self.config
        if cfg.scheduling == "static":
            # Gang admission: only into an EMPTY batch, all at once.
            if any(r is not None for r in self._slots):
                return
        while self._waiting:
            free_slots = [i for i, r in enumerate(self._slots) if r is None]
            if not free_slots:
                return
            req = None
            for cand in self._waiting:   # sorted by (class, arrival)
                if (cfg.scheduling == "continuous"
                        and cand.slo_class != "interactive"
                        and len(free_slots) <= self._slo_reserved):
                    # Reserved headroom: batch-class admissions must
                    # leave this many slots open for interactive
                    # arrivals (a bulk flood otherwise owns the batch).
                    continue
                req = cand
                break
            if req is None:
                return
            rid = req.request_id
            # Longest cached prefix: adopt matched blocks (refcount++)
            # and skip their prefill entirely. Capped one token short of
            # the stream so at least one token still prefills — the
            # first emitted token needs fresh logits.
            matched_tokens = 0
            pin_node = None
            if self._prefix is not None:
                stream = req.prompt + req.generated
                cap = (len(stream) - 1) // cfg.block_size * cfg.block_size
                blocks, pin_node = self._prefix.match(stream[:cap])
                if blocks:
                    matched_tokens = len(blocks) * cfg.block_size
                    self._bm.register_with_blocks(rid, blocks)
                    self._prefix.pin(pin_node)
                    req._pinned_node = pin_node
            if not self._bm.registered(rid):
                self._bm.register(rid)
            first = min(req.total_to_prefill,
                        matched_tokens + cfg.prefill_chunk)
            while not self._bm.ensure(rid, first):
                deficit = (self._bm.blocks_for_tokens(first)
                           - len(self._bm.block_table(rid))
                           - self._bm.num_free())
                if (self._prefix is None
                        or self._prefix.evict_for(deficit) == 0):
                    # Pool exhausted: stay queued; running sequences
                    # finishing (or preempting) will free blocks.
                    self._unpin_req(req)
                    self._bm.free(rid)
                    return
            self._waiting.remove(req)
            req.slot = free_slots[0]
            req.state = PREFILL
            req.processed = matched_tokens
            req.cached_tokens += matched_tokens
            if req.admitted_at is None:
                req.admitted_at = time.monotonic()
            if req.generated:
                self._recomputed_tokens += max(
                    0, req.total_to_prefill - matched_tokens)
            self._slots[req.slot] = req

    # ---------------------------------------------------------- preemption

    def _preempt_one(self) -> bool:
        """Free the lowest-priority scheduled sequence to relieve block
        pressure: batch-class victims before interactive ones, latest
        arrival within a class. The victim may be the requester itself
        (callers detect that via its WAITING state). Returns False when
        there is nothing left to preempt."""
        victims = [r for r in self._scheduled()
                   if r.state in (PREFILL, DECODE)]
        if not victims:
            return False
        victim = max(victims, key=self._prio)
        self._unpin_req(victim)
        self._bm.free(victim.request_id)
        self._slots[victim.slot] = None
        victim.slot = None
        victim.state = WAITING
        victim.processed = 0
        victim.cur_token = None
        victim.preemptions += 1
        self._preemptions += 1
        if _tracing._ENABLED:
            now = _tracing.epoch_of(time.monotonic())
            _tracing.get_tracer().record_span(
                "engine.preempt", now, now, parent_ctx=victim.trace_ctx,
                attrs={"request": victim.request_id,
                       "tokens_generated": len(victim.generated)})
        self._waiting.append(victim)
        self._waiting.sort(key=self._prio)
        return True

    def _ensure_blocks(self, req: Request, num_tokens: int) -> bool:
        """Grow req's block table — reclaiming cold cached prefixes
        first, then preempting victims — until it fits. False when req
        itself was preempted (caller must drop it)."""
        while not self._bm.ensure(req.request_id, num_tokens):
            deficit = (self._bm.blocks_for_tokens(num_tokens)
                       - len(self._bm.block_table(req.request_id))
                       - self._bm.num_free())
            if (self._prefix is not None
                    and self._prefix.evict_for(deficit) > 0):
                continue
            if self.config.scheduling == "static":
                # A drained gang member's KV is never read again — reclaim
                # its blocks before preempting anything still running.
                holders = [r for r in self._scheduled()
                           if r.state == _DONE_HOLD
                           and self._bm.registered(r.request_id)]
                if holders:
                    self._bm.free(holders[0].request_id)
                    continue
            if not self._preempt_one():
                return False
            if req.state == WAITING:   # preempted itself
                return False
        return True

    # ------------------------------------------------------------- prefill

    def _prefill_step(self, emissions) -> bool:
        cfg = self.config
        cands = [r for r in self._scheduled() if r.state == PREFILL]
        if not cands:
            return False
        req = min(cands, key=self._prio)   # interactive first, then oldest
        total = req.total_to_prefill
        chunk = min(cfg.prefill_chunk, total - req.processed)
        if not self._ensure_blocks(req, req.processed + chunk):
            return False
        stream = req.prompt + req.generated
        ids = np.zeros((1, cfg.prefill_chunk), np.int32)
        ids[0, :chunk] = stream[req.processed:req.processed + chunk]
        wmask = np.zeros((1, cfg.prefill_chunk), bool)
        wmask[0, :chunk] = True
        bt = self._block_table_rows([req])
        args = (ids, bt, np.asarray([req.processed], np.int32), wmask)
        last_idx = np.asarray([chunk - 1], np.int32)
        nxt = self._call("prefill", self._prefill_fn, self._arenas, *args,
                         last_idx, *self._aidx([req]))
        if self._draft_len > 0:
            # Keep the draft's KV in lockstep: same chunk, same blocks.
            # Cached-prefix blocks carry draft KV from their original
            # prefill (deterministic writes), so hits skip BOTH models.
            self._call("draft_prefill", self._draft_prefill_fn,
                       self._draft_arenas, *args)
        req.processed += chunk
        if req.processed >= total:
            self._emit_token(req, int(nxt[0]), emissions)
        return True

    # -------------------------------------------------------------- decode

    def _decode_step(self, emissions) -> bool:
        cfg = self.config
        active: List[Request] = []
        for req in list(self._scheduled()):
            if req.state != DECODE:
                continue
            # Writing cur_token at position `processed` needs capacity for
            # processed + 1 tokens.
            if self._ensure_blocks(req, req.processed + 1):
                active.append(req)
        # A later sequence's block claim may have preempted one already
        # admitted to this step — keep only the still-scheduled.
        active = [r for r in active if r.state == DECODE
                  and r.slot is not None]
        if not active:
            return False
        B = cfg.batch_slots
        toks = np.zeros((B, 1), np.int32)
        pos = np.zeros(B, np.int32)
        wmask = np.zeros((B, 1), bool)
        rows: List[Optional[Request]] = [None] * B
        for req in active:
            i = req.slot
            rows[i] = req
            toks[i, 0] = req.cur_token
            pos[i] = req.processed
            wmask[i, 0] = True
        bt = self._block_table_rows(rows)
        nxt = self._call("decode", self._decode_fn, self._arenas, toks, bt,
                         pos, wmask, *self._aidx(rows))
        nxt = nxt.cpu().numpy()     # the step's one synchronisation
        for req in active:
            req.processed += 1
            self._emit_token(req, int(nxt[req.slot]), emissions)
        return True

    def _spec_decode_step(self, emissions) -> bool:
        """Speculative round for every DECODE row: draft proposes k
        tokens (k+1 draft steps so the draft KV stays complete), target
        verifies [current, d1..dk] in one [B, k+1] forward. Row i with
        a accepted drafts emits d1..da plus the target's bonus token —
        provably the same tokens plain decoding would emit (greedy
        verify), just more of them per target pass. Rejected proposals
        need no KV rollback: every stale slot is at a position >= the
        row's new `processed`, and the next round's in-place scatter
        overwrites it before any attention read (the causal mask hides it
        until then). Over-provisioned tail blocks stay in the row's table
        for the next round and are released at finish/preemption — never
        leaked."""
        cfg = self.config
        k = self._draft_len
        active: List[tuple] = []
        for req in list(self._scheduled()):
            if req.state != DECODE:
                continue
            # Rows near the context limit shorten their round: writes
            # never pass max_context (the block table has no slots
            # there; a clipped write would corrupt the last block).
            allow = max(0, min(k, cfg.max_context - req.processed - 1))
            if self._ensure_blocks(req, req.processed + allow + 1):
                active.append((req, allow))
        active = [(r, a) for r, a in active
                  if r.state == DECODE and r.slot is not None]
        if not active:
            return False
        B = cfg.batch_slots
        toks = np.zeros((B, 1), np.int32)
        pos = np.zeros(B, np.int32)
        wmask_seq = np.zeros((k + 1, B, 1), bool)
        rows: List[Optional[Request]] = [None] * B
        for req, allow in active:
            i = req.slot
            rows[i] = req
            toks[i, 0] = req.cur_token
            pos[i] = req.processed
            wmask_seq[:allow + 1, i, 0] = True
        bt = self._block_table_rows(rows)
        props = self._call("propose", self._propose_fn, self._draft_arenas,
                           toks, bt, pos, wmask_seq)
        props = props.cpu().numpy()             # [B, k+1]; col j = d_{j+1}
        vtoks = np.zeros((B, k + 1), np.int32)
        vmask = np.zeros((B, k + 1), bool)
        for req, allow in active:
            i = req.slot
            vtoks[i, 0] = req.cur_token
            vtoks[i, 1:] = props[i, :k]
            vmask[i, :allow + 1] = True
        tgt = self._call("verify", self._verify_fn, self._arenas, vtoks, bt,
                         pos, vmask, *self._aidx(rows))
        tgt = tgt.cpu().numpy()                 # [B, k+1] target argmaxes
        for req, allow in active:
            i = req.slot
            a = 0
            while a < allow and props[i, a] == tgt[i, a]:
                a += 1
            self._spec_rounds += 1
            self._spec_proposed += allow
            self._spec_accepted += a
            self._spec_hist[a] += 1
            # KV through pos+a is now final; positions beyond hold
            # rejected-draft garbage the next round overwrites.
            req.processed += a + 1
            for j in range(a + 1):
                if req.done:
                    break
                token = int(props[i, j]) if j < a else int(tgt[i, a])
                self._emit_token(req, token, emissions)
        return True

    # ------------------------------------------------------------- helpers

    def _aidx(self, rows) -> tuple:
        """(per-row adapter index,) for a multiplexed engine, else ()."""
        if self._adapters is None:
            return ()
        return (np.asarray([r.adapter_row if r is not None else 0
                            for r in rows], np.int32),)

    def _call(self, name: str, fn, arenas, *args):
        """Run one program: on a mesh, send its record to the followers
        first; record its argument shapes, move the host arrays to the
        device in one copy, and call it on the arenas. On a mesh a program
        that fails breaks the lockstep (`lockstep.Lockstep.fail`)."""
        if self._lockstep is None:
            return self._run(name, fn, arenas, args)
        self._send(program=name, args=args)
        try:
            return self._run(name, fn, arenas, args)
        except BaseException as e:
            self._lockstep.fail(e)
            raise

    def _run(self, name: str, fn, arenas, args):
        self._shapes[name].add(tuple(a.shape for a in args))
        return fn(arenas, *self._upload(args))

    # ------------------------------------------------------------ lockstep

    def _send(self, **record) -> None:
        if self._adapters is not None:
            record["adapters"] = self._adapters.take_changes()
        self._lockstep.send(record)

    def follow(self) -> int:
        """A follower's loop: receive each record of the leader's, apply
        it (adapter rows, an arena reset) and run its program on this
        rank's shards, until the stop record. Returns the records applied.
        An exception ends the loop (the leader's step then fails on the
        mesh group's timeout)."""
        if self.is_leader:
            raise RuntimeError("the leader schedules; only a tp follower "
                               "follows")
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        applied = 0
        while True:
            record = self._lockstep.recv()
            if record.get("stop"):
                return applied
            with self._lock:
                if record.get("adapters"):
                    self._adapters.apply_changes(record["adapters"])
                if record.get("reset"):
                    self._reset_arenas()
                name = record.get("program")
                if name is not None:
                    arenas = (self._draft_arenas
                              if name in ("draft_prefill", "propose")
                              else self._arenas)
                    self._run(name, self._programs[name], arenas,
                              record["args"])
            applied += 1

    def _sends(self) -> bool:
        """Whether this engine still sends records: the leader of a mesh
        whose lockstep is neither stopped nor broken."""
        ls = self._lockstep
        return (ls is not None and ls.is_leader and not ls.stopped
                and ls.broken is None)

    def stop_followers(self) -> None:
        """Send the stop record (the leader of a mesh; once): every
        follower's `follow()` returns. Sends nothing once the lockstep is
        broken: the followers' waits run out instead."""
        with self._lock:
            if not self._sends():
                return
            self._lockstep.stopped = True
            self._send(stop=True)

    def heartbeat(self) -> None:
        """Send an empty record when the leader has sent none for the
        lockstep's `heartbeat_s`, so an idle follower's wait never reaches
        its limit. A send that fails breaks the lockstep and is logged."""
        if not self._sends():
            return
        if time.monotonic() - self._lockstep.last_sent \
                >= self._lockstep.heartbeat_s:
            with self._lock:
                try:
                    self._send()
                except Exception:  # noqa: BLE001 — the next step fails
                    logger.exception("lockstep: the heartbeat record was "
                                     "not sent")

    def _upload(self, arrays) -> List[torch.Tensor]:
        """Host arrays -> int64 (bool for masks) device tensors, through
        one buffer and one copy (pinned and asynchronous on the card, so
        it does not wait for the device)."""
        flat = torch.from_numpy(np.concatenate(
            [np.asarray(a, np.int64).ravel() for a in arrays]))
        if self._device.type == "cuda":
            flat = flat.pin_memory().to(self._device, non_blocking=True)
        out, off = [], 0
        for a in arrays:
            t = flat[off:off + a.size].view(a.shape)
            off += a.size
            out.append(t.bool() if a.dtype == bool else t)
        return out

    def _block_table_rows(self, reqs) -> np.ndarray:
        cfg = self.config
        bt = np.zeros((len(reqs), cfg.max_blocks_per_seq), np.int32)
        for i, req in enumerate(reqs):
            if req is None or req.done or req.state == WAITING:
                continue
            table = self._bm.block_table(req.request_id)
            bt[i, :len(table)] = table
        return bt

    def _emit_token(self, req: Request, token: int, emissions):
        req.generated.append(token)
        req.cur_token = token
        req.state = DECODE
        self._record_emit(req, ("token", token), emissions)
        if (len(req.generated) >= req.max_new_tokens
                or (self.config.eos_id is not None
                    and token == self.config.eos_id)):
            self._finish(req, emissions)

    def _record_emit(self, req: Request, event, emissions):
        """Route one client-visible event. Static mode holds everything
        back until the gang drains — that IS the baseline's latency."""
        if self.config.scheduling == "static" and event[0] == "token":
            req._held_emits.append(event)
            return
        self._fire(req, event, emissions)

    def _fire(self, req: Request, event, emissions):
        kind, payload = event
        if kind == "token":
            now = time.monotonic()
            if req.first_token_at is None:
                req.first_token_at = now
            self._tokens_emitted += 1
            self._rate_window.append((now, 1))
            # Prune the stale head here, not just in stats(): an unpolled
            # engine must not grow a tuple per token forever.
            while self._rate_window and now - self._rate_window[0][0] > 5.0:
                self._rate_window.pop(0)
            if req.on_token is not None:
                emissions.append((req.on_token, (req, payload)))
        else:  # finish
            req.finished_at = time.monotonic()
            if req.on_finish is not None:
                emissions.append((req.on_finish, (req,)))

    def _finish(self, req: Request, emissions, error: Optional[str] = None):
        req.state = FAILED if error else FINISHED
        req.error = error
        if error:
            self._failed += 1
        else:
            self._finished += 1
        if self.config.scheduling == "static" and not error:
            # Hold the slot (and blocks) until the whole gang drains:
            # request-level batching runs at the longest member's speed.
            req.state = _DONE_HOLD
            return
        for event in req._held_emits:   # static error: flush, then fail
            self._fire(req, event, emissions)
        req._held_emits = []
        # Donate the finished sequence's full-block prefix to the radix
        # cache BEFORE freeing: insert increfs the novel suffix, free
        # decrefs the request's own references, net the cache keeps
        # exactly the new blocks. Errors skip the donation (a cancelled
        # stream's KV is valid but its tail may be mid-write).
        if (self._prefix is not None and not error
                and self._bm.registered(req.request_id)):
            stream = req.prompt + req.generated
            nb = min(req.processed, len(stream)) // self.config.block_size
            if nb > 0:
                self._prefix.insert(
                    stream[:nb * self.config.block_size],
                    self._bm.block_table(req.request_id)[:nb])
        self._unpin_req(req)
        self._bm.free(req.request_id)
        if req.slot is not None:
            self._slots[req.slot] = None
            req.slot = None
        self._live.pop(req.request_id, None)
        self._fire(req, ("finish", None), emissions)
        self._record_phase_spans(req)

    def fail_all(self, error: str) -> int:
        """Abort every scheduled and waiting request with `error` (the
        EngineLoop's circuit breaker after repeated step failures —
        callers must see the failure, not hang on futures nothing will
        resolve). Completed static gang members are released as
        successes. Returns how many requests were failed."""
        emissions: List[tuple] = []
        failed = 0
        with self._lock:
            for req in list(self._scheduled()):
                if req.state == _DONE_HOLD:
                    self._release_hold(req, emissions)
                else:
                    self._finish(req, emissions, error=error)
                    failed += 1
            for req in self._waiting:
                req.state = FAILED
                req.error = error
                self._failed += 1
                failed += 1
                self._live.pop(req.request_id, None)
                self._fire(req, ("finish", None), emissions)
            self._waiting.clear()
            self._reset_arenas()
            # Fresh arenas invalidate every cached block's contents: a
            # warm radix tree pointing at zeroed KV would serve garbage.
            if self._prefix is not None:
                self._prefix.clear()
            if self._sends():
                try:
                    self._send(reset=True)
                except Exception:  # noqa: BLE001 — a follower gone: the
                    logger.exception("lockstep: the arena reset record "
                                     "was not sent")   # requests still fail
        for fn, args in emissions:
            try:
                fn(*args)
            except Exception:  # noqa: BLE001
                pass
        return failed

    def _reset_arenas(self) -> None:
        """Rebuild the arenas: a step that failed mid-execution may have
        left a chunk half written. The old arenas are released BEFORE the
        new ones are made, so at no point are two alive."""
        self._arenas = None
        self._arenas = self._new_arenas(self._model)
        if self._draft_arenas is not None:
            self._draft_arenas = None
            self._draft_arenas = self._new_arenas(self._draft_model)

    def _release_static_gang(self, emissions):
        if self.config.scheduling != "static":
            return
        scheduled = self._scheduled()
        if not scheduled or any(r.state != _DONE_HOLD for r in scheduled):
            return
        for req in scheduled:
            self._release_hold(req, emissions)

    def _release_hold(self, req: Request, emissions):
        """Complete a static DONE_HOLD member: flush its held events in
        order, free its slot and blocks, fire its finish."""
        req.state = FINISHED
        self._live.pop(req.request_id, None)
        for event in req._held_emits:
            self._fire(req, event, emissions)
        req._held_emits = []
        self._bm.free(req.request_id)
        self._slots[req.slot] = None
        req.slot = None
        self._fire(req, ("finish", None), emissions)
        self._record_phase_spans(req)

    def _record_phase_spans(self, req: Request):
        """TTFT decomposition, recorded once per finished request under
        its captured trace context: engine.queue (submit -> first
        admission), engine.prefill (admission -> first token),
        engine.decode (first token -> finish). With engine.preempt
        markers in between, a timeline answers "where did this request's
        latency go" per phase."""
        if not _tracing._ENABLED or req.trace_ctx is None:
            return
        tracer = _tracing.get_tracer()
        eo = _tracing.epoch_of
        end = req.finished_at if req.finished_at is not None \
            else time.monotonic()
        attrs = {"request": req.request_id}
        tracer.record_span(
            "engine.queue", eo(req.submitted_at),
            eo(req.admitted_at if req.admitted_at is not None else end),
            parent_ctx=req.trace_ctx, attrs=attrs, error=req.error)
        if req.admitted_at is not None:
            tracer.record_span(
                "engine.prefill", eo(req.admitted_at),
                eo(req.first_token_at if req.first_token_at is not None
                   else end),
                parent_ctx=req.trace_ctx,
                attrs=dict(attrs, prompt_tokens=len(req.prompt)))
        if req.first_token_at is not None:
            tracer.record_span(
                "engine.decode", eo(req.first_token_at), eo(end),
                parent_ctx=req.trace_ctx,
                attrs=dict(attrs, tokens=len(req.generated),
                           preemptions=req.preemptions))

    # --------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        """Engine statistics. Non-blocking: a long step can hold the
        engine lock, and a health check (stats with a short timeout) must
        not read that as a dead replica — fall back to the last snapshot
        instead of parking. `*_compiles` count the distinct argument shapes
        each program has seen (1 is the discipline)."""
        if not self._lock.acquire(timeout=0.2):
            return dict(self._last_stats)
        try:
            self._last_stats = self._stats_locked()
            return dict(self._last_stats)
        finally:
            self._lock.release()

    def _stats_locked(self) -> Dict[str, Any]:
        now = time.monotonic()
        self._rate_window = [(t, n) for t, n in self._rate_window
                             if now - t <= 5.0]
        window_tokens = sum(n for _, n in self._rate_window)
        span = (now - self._rate_window[0][0]) if self._rate_window else 0.0
        running = [r for r in self._slots if r is not None
                   and r.state in (PREFILL, DECODE)]
        return {
            "queue_depth": len(self._waiting),
            "running": len(running),
            "tp": self._tp,
            "batch_slots": self.config.batch_slots,
            "tokens_emitted": self._tokens_emitted,
            "tokens_per_sec": (window_tokens / span) if span > 0 else 0.0,
            "requests_finished": self._finished,
            "requests_failed": self._failed,
            "preemptions": self._preemptions,
            "recomputed_tokens": self._recomputed_tokens,
            "prefill_compiles": self._program_compiles("prefill"),
            "decode_compiles": self._program_compiles("decode"),
            "kv": self._bm.stats(),
            "prefix_cache": (self._prefix.stats() if self._prefix is not None
                             else {"enabled": False, "cached_blocks": 0,
                                   "hit_rate": 0.0, "hit_tokens": 0}),
            "spec_decode": {
                "draft_len": self._draft_len,
                "rounds": self._spec_rounds,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "accept_rate": (self._spec_accepted / self._spec_proposed
                                if self._spec_proposed else 0.0),
                "mean_accepted": (self._spec_accepted / self._spec_rounds
                                  if self._spec_rounds else 0.0),
                "accepted_hist": list(self._spec_hist),
                "draft_prefill_compiles":
                    self._program_compiles("draft_prefill"),
                "propose_compiles": self._program_compiles("propose"),
                "verify_compiles": self._program_compiles("verify"),
            },
            "slo": {
                "reserved_slots": self._slo_reserved,
                "waiting_interactive": sum(
                    1 for r in self._waiting
                    if r.slo_class == "interactive"),
                "waiting_batch": sum(1 for r in self._waiting
                                     if r.slo_class == "batch"),
            },
            **({"adapters": self._adapters.stats()}
               if self._adapters is not None else {}),
        }

    def check_no_leaks(self):
        """Test hook: once every request has finished, the only arena
        references left are the radix cache's (its synthetic tables are
        audited by check_consistency like live sequences), nothing is
        pinned, and the cache's own tree matches its tables. Without a
        cache this degenerates to the classic blocks_in_use == 0."""
        with self._lock:
            self._bm.check_consistency()
            cached = (self._prefix.cached_blocks()
                      if self._prefix is not None else 0)
            assert self._bm.blocks_in_use() == cached, (
                self._bm.stats(), cached)
            if self._prefix is not None:
                self._prefix.check_consistency()
                if not self._live:
                    assert self._prefix.total_pins() == 0

    def drop_prefix_cache(self) -> int:
        """Release every cached prefix block back to the pool (test
        drains, memory-pressure escape hatch). Returns blocks freed."""
        with self._lock:
            if self._prefix is None:
                return 0
            return self._prefix.clear()


class EngineLoop:
    """Background thread driving `engine.step()` while there is work.

    Submissions from any thread; an asyncio loop talks to it through
    thread-safe callbacks. The thread makes the engine's card its current
    device before its first step. On a mesh it drives the leader: while
    idle it keeps the followers' wait alive (`heartbeat`), and `stop`
    sends them the stop record."""

    def __init__(self, engine: InferenceEngine):
        self.engine = engine
        self._cv = threading.Condition()
        self._stopped = False
        self._thread = threading.Thread(target=self._run,
                                        name="inference-engine",
                                        daemon=True)
        self._thread.start()

    # After this many consecutive step failures every in-flight request
    # is failed (fail_all) instead of retrying the same broken state
    # forever while callers hang on futures nothing will resolve.
    MAX_CONSECUTIVE_FAILURES = 3

    def submit(self, *args, **kwargs) -> Request:
        # Check-and-enqueue under the loop's condition: a submit racing
        # stop() must either raise or land before stop's fail_all sweep —
        # never slip into a queue no thread will ever drain.
        with self._cv:
            if self._stopped:
                raise RuntimeError(
                    "engine loop is stopped (replica shutdown)")
            req = self.engine.add_request(*args, **kwargs)
            self._cv.notify()
        return req

    def _run(self):
        if self.engine._device.type == "cuda":
            torch.cuda.set_device(self.engine._device)
        failures = 0
        while True:
            with self._cv:
                while not self._stopped and not self.engine.has_work():
                    self._cv.wait(timeout=0.05)
                    self.engine.heartbeat()
                if self._stopped:
                    return
            try:
                self.engine.step()
                self.engine.heartbeat()
                failures = 0
            except Exception as e:  # noqa: BLE001 — scheduler survives a
                failures += 1       # bad step; circuit-break if persistent
                logger.exception("inference engine step failed (%d/%d)",
                                 failures, self.MAX_CONSECUTIVE_FAILURES)
                if failures >= self.MAX_CONSECUTIVE_FAILURES:
                    self.engine.fail_all(
                        f"engine step failed repeatedly: "
                        f"{type(e).__name__}: {e}")
                    failures = 0
                else:
                    time.sleep(0.01)

    def stop(self, timeout_s: float = 5.0):
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout_s)
        # Anything still parked (a request that slipped in as we stopped)
        # must fail fast, not hang its caller.
        self.engine.fail_all("engine loop stopped")
        self.engine.stop_followers()
