"""Reference deployments: batched inference replicas on the card.

The serving counterpart of the flagship model (BASELINE.json names a Serve
LLM deployment): a GPT-2 sampler replica that owns its card, pads incoming
prompts into one fixed batch shape, and rides `@serve.batch` so concurrent
HTTP requests share one forward pass per decode step.

Both samplers build their weights on their device from seed 0, and run on
the card the replica was granted unless the caller passes `device="cpu"`
(the CPU tests do).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch import serve

# One batch shape: @serve.batch caps request batches here and the samplers
# pad row counts to exactly this.
SAMPLER_BATCH = 8


def _prompts_and_budgets(requests: List[Dict[str, Any]], max_seq: int,
                         default_new: int):
    """Truncated prompts + per-request decode budgets (shared by all
    sampler deployments so clamping semantics can't drift)."""
    import numpy as np

    prompts = [list(r.get("ids", []))[: max_seq - 1] or [0]
               for r in requests]
    budgets = np.zeros(len(prompts), np.int64)
    for i, r in enumerate(requests):
        budgets[i] = max(1, min(int(r.get("max_new_tokens", default_new)),
                                max_seq - 1 - len(prompts[i])))
    return prompts, budgets


def gpt2_greedy(model, ids, lengths, budgets, max_pos: int):
    """Greedy decoding on a padded batch: ids [b, max_seq] (int64),
    lengths [b] and budgets [b] on the model's device. Runs max(budgets)
    full forwards; row i appends one token a step while step < budgets[i]
    and lengths[i] < max_pos. Returns (ids, lengths)."""
    import torch

    rows = torch.arange(ids.shape[0], device=ids.device)
    with torch.no_grad():
        for step in range(int(budgets.max())):
            logits = model(ids)
            nxt = logits[rows, lengths - 1].argmax(dim=-1)
            active = (step < budgets) & (lengths < max_pos)
            ids[rows, lengths] = torch.where(active, nxt, ids[rows, lengths])
            lengths = lengths + active.long()
    return ids, lengths


class _SamplerMetrics:
    _batches_served = 0
    _batch_size_sum = 0

    def _observe_batch(self, n: int):
        self._batches_served += 1
        self._batch_size_sum += n

    def metrics(self, _=None) -> Dict[str, Any]:
        served = self._batches_served
        return {
            "batches_served": served,
            "mean_batch_size":
                (self._batch_size_sum / served) if served else 0.0,
        }


@serve.deployment(max_concurrent_queries=32)
class GPT2Sampler(_SamplerMetrics):
    """Greedy sampler over a GPT-2 checkpoint (randomly initialized from
    seed 0 — serving-path benchmarking doesn't need trained weights).

    Request: {"ids": [int, ...], "max_new_tokens": int} -> {"ids": [...]}.
    Each decode step is one full forward of the padded [SAMPLER_BATCH,
    max_seq] batch through the port's `GPT2`, so on the card the flash
    forward kernel runs once per layer per step.
    """

    def __init__(self, model_size: str = "tiny", max_seq: int = 256,
                 default_new_tokens: int = 8, device: Optional[str] = None):
        from ray_tpu_torch._torch_env import replica_device
        from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config

        cfg = {"tiny": GPT2Config.tiny(seq=max_seq),
               "small": GPT2Config.small(),
               "medium": GPT2Config.medium()}[model_size]
        self._cfg = cfg
        self._max_seq = min(max_seq, cfg.n_positions)
        self._default_new = default_new_tokens
        self._device = replica_device(device)
        self._model = GPT2(cfg, device=self._device, seed=0).eval()
        self.forwards = 0

    @serve.batch(max_batch_size=SAMPLER_BATCH, batch_wait_timeout_s=0.02)
    async def __call__(self, requests: List[Dict[str, Any]]):
        import torch

        self._observe_batch(len(requests))
        prompts, budgets = _prompts_and_budgets(requests, self._max_seq,
                                                self._default_new)
        # Pad the batch dim to the decorator's cap: one shape for every
        # batch the flusher can produce.
        b = SAMPLER_BATCH
        ids = torch.zeros(b, self._max_seq, dtype=torch.long)
        lengths = torch.ones(b, dtype=torch.long)
        full_budgets = torch.zeros(b, dtype=torch.long)
        for i, p in enumerate(prompts):
            ids[i, : len(p)] = torch.tensor(p)
            lengths[i] = len(p)
            full_budgets[i] = int(budgets[i])
        dev = self._device
        ids, lengths = gpt2_greedy(self._model, ids.to(dev), lengths.to(dev),
                                   full_budgets.to(dev), self._max_seq - 1)
        self.forwards += int(full_budgets.max())
        out_ids, out_lens = ids.cpu().tolist(), lengths.cpu().tolist()
        return [{"ids": out_ids[i][: out_lens[i]]}
                for i in range(len(prompts))]


@serve.deployment(max_concurrent_queries=32)
class LlamaSampler(_SamplerMetrics):
    """KV-cached greedy sampler over a Llama-family model (BASELINE.json's
    Serve Llama deployment). Unlike GPT2Sampler's recompute-per-token
    loop, this prefills the prompt K/V once and then runs decode steps of
    one token against the cache (`Llama.decode` over `make_cache`).

    Request: {"ids": [int, ...], "max_new_tokens": int} -> {"ids": [...]}.
    """

    def __init__(self, model_size: str = "tiny", max_seq: int = 256,
                 default_new_tokens: int = 8, device: Optional[str] = None):
        from ray_tpu_torch._torch_env import replica_device
        from ray_tpu_torch.models.llama import Llama, LlamaConfig, make_cache

        cfg = {"tiny": LlamaConfig.tiny(seq=max_seq),
               "small": LlamaConfig.small(),
               "7b": LlamaConfig.llama7b()}[model_size]
        self._cfg = cfg
        self._max_seq = min(max_seq, cfg.n_positions)
        self._default_new = default_new_tokens
        self._device = replica_device(device)
        self._model = Llama(cfg, device=self._device, seed=0)
        # One preallocated cache, reused across batches: every slot a query
        # can see is rewritten during its own call (prefill writes the
        # prompt span, decode overwrites onward; the position mask hides
        # the rest).
        self._cache = make_cache(cfg, SAMPLER_BATCH, self._max_seq,
                                 device=self._device)

    @serve.batch(max_batch_size=SAMPLER_BATCH, batch_wait_timeout_s=0.02)
    async def __call__(self, requests: List[Dict[str, Any]]):
        self._observe_batch(len(requests))
        prompts, budgets = _prompts_and_budgets(requests, self._max_seq,
                                                self._default_new)
        return llama_greedy(self._model, self._cache, prompts, budgets,
                            self._max_seq)


def llama_greedy(model, cache, prompts, budgets, max_seq: int):
    """LlamaSampler's decode: the prompts padded into SAMPLER_BATCH rows
    (prompt length padded to a power of two, at least 8), one prefill,
    then max(budgets) decode steps of one token. Returns [{"ids": ...}]."""
    import torch

    dev = model.device
    b = SAMPLER_BATCH
    plen = max(len(p) for p in prompts)
    pad = 8
    while pad < plen:
        pad *= 2
    pad = min(pad, max_seq)
    ids = torch.zeros(b, pad, dtype=torch.long)
    lens = torch.ones(b, dtype=torch.long)
    full_budgets = torch.zeros(b, dtype=torch.long)
    for i, p in enumerate(prompts):
        ids[i, : len(p)] = torch.tensor(p)
        lens[i] = len(p)
        full_budgets[i] = int(budgets[i])
    ids, lens, full_budgets = ids.to(dev), lens.to(dev), full_budgets.to(dev)
    rows = torch.arange(b, device=dev)
    with torch.no_grad():
        logits, cache = model.decode(ids, cache,
                                     torch.zeros(b, dtype=torch.long,
                                                 device=dev))
        # Each row's next token comes from ITS last real position.
        tok = logits[rows, lens - 1].argmax(dim=-1)
        out = torch.zeros(b, max_seq, dtype=torch.long, device=dev)
        out[:, :pad] = ids
        for step in range(int(budgets.max())):
            active = (step < full_budgets) & (lens < max_seq - 1)
            out[rows, lens] = torch.where(active, tok, out[rows, lens])
            lens = lens + active.long()
            logits, cache = model.decode(tok[:, None], cache, lens - 1)
            tok = logits[:, -1].argmax(dim=-1)
    out_l, lens_l = out.cpu().tolist(), lens.cpu().tolist()
    return [{"ids": out_l[i][: lens_l[i]]} for i in range(len(prompts))]
