"""Serve integration for the continuous-batching engine.

`LLMServer` is a `@serve.deployment` hosting one `InferenceEngine` per
replica (the replica's actor owns the card; the engine thread runs the
step programs on it). Two entry points:

- `__call__` / `generate`: complete the whole generation, return
  ``{"ids": [...]}`` — wire-compatible with the `LlamaSampler` example.
- `stream`: an async generator yielding one event per produced token;
  the existing replica/handle/proxy stream plumbing carries them to
  Python callers (``handle.options(stream=True)``) and HTTP clients
  (chunked JSON lines) as they are emitted — time-to-first-token is one
  scheduler step, not one full generation.

The replica exports the engine's queue depth through the
``__serve_metrics__`` hook, so the controller's autoscaler sees queued
requests (not just in-flight RPCs) and scales replicas on real backlog.
``__serve_shutdown__`` stops the engine thread at replica teardown.

The engine runs on the card the replica was granted
(``ray_actor_options={"num_gpus": 1}``) unless the deployment is bound
with ``device="cpu"``; a replica with neither raises. Tokens and ids cross
the data plane as Python ints.

On a tp gang (``shard_spec=ShardSpec(tp=n, world_size=n)``, one rank a
card) every rank builds the lockstep engine on the gang's mesh: rank 0
(the replica the router sees) runs the `EngineLoop`, and every other rank
runs the engine's `follow()` on a thread. Draining rank 0
(`prepare_shutdown`, also the first act of the gang's kill) stops its
loop, which sends the followers the stop record. A step that fails on the
mesh fails rank 0's requests at once, and a follower that fails ends its
process, so the gang restarts as a unit.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch import serve
from ray_tpu_torch._torch_env import replica_device
from ray_tpu_torch.inference.engine import (EngineConfig, EngineLoop,
                                            InferenceEngine)

logger = logging.getLogger(__name__)


def _parse(payload: Optional[Dict[str, Any]], default_new: int):
    payload = payload or {}
    ids = [int(t) for t in payload.get("ids", [])] or [0]
    max_new = max(1, int(payload.get("max_new_tokens", default_new)))
    model_id = payload.get("model_id") or payload.get("model")
    slo = payload.get("slo_class") or payload.get("slo")
    return (ids, max_new,
            (str(model_id) if model_id is not None else None),
            (str(slo) if slo is not None else None))


def _ints(req) -> list:
    """The request's prompt + generated ids as Python ints."""
    return [int(t) for t in req.prompt] + [int(t) for t in req.generated]


@serve.deployment(max_concurrent_queries=64)
class LLMServer:
    """Continuous-batching LLM deployment.

    Request: ``{"ids": [int, ...], "max_new_tokens": int}``;
    response: ``{"ids": [prompt + generated]}`` (generate) or a stream of
    ``{"token": int}`` events followed by ``{"done": true, "ids": [...]}``
    (stream).
    """

    def __init__(self, model_size: str = "tiny",
                 max_model_len: int = 256,
                 default_new_tokens: int = 16,
                 engine_config: Optional[Dict[str, Any]] = None,
                 adapters: Optional[Dict[str, Dict[str, Any]]] = None,
                 max_resident_adapters: int = 0,
                 device: Optional[str] = None):
        kwargs = dict(engine_config or {})
        kwargs.setdefault("model_size", model_size)
        kwargs.setdefault("max_model_len", max_model_len)
        # Model multiplexing: `adapters` registers the replica's servable
        # LoRA models ({model_id: {"seed": int, "rank": r, "scale": s}}).
        # Weights are DERIVED (deterministically, from the seed) on
        # demand, loaded into the shared bank LRU-style — a respawned
        # replica reloads an adapter the moment a request names it, bit-
        # identical to before the crash. max_resident_adapters bounds
        # bank rows (default: all registered adapters resident at once).
        self._adapter_specs = {str(k): dict(v or {})
                               for k, v in (adapters or {}).items()}
        if self._adapter_specs:
            ranks = {int(s.get("rank", 8))
                     for s in self._adapter_specs.values()}
            if len(ranks) > 1:
                raise ValueError(
                    f"all adapters of a replica share one bank rank; "
                    f"got {sorted(ranks)}")
            kwargs.setdefault("max_adapters",
                              max_resident_adapters
                              or len(self._adapter_specs))
            kwargs.setdefault("lora_rank", ranks.pop())
        self._default_new = default_new_tokens
        self._config = EngineConfig(**kwargs)
        # Sharded replica groups: when this replica is a gang rank the
        # shard context was activated before this ctor ran; the gang's tp
        # mesh turns on the engine's tensor-parallel path (each rank's
        # shards from the same seed as an unsharded replica's weights).
        from ray_tpu_torch import shardgroup

        self._engine = InferenceEngine(self._config,
                                       device=replica_device(device),
                                       mesh=shardgroup.current_mesh())
        if self._adapter_specs:
            self._engine.register_adapter_source(self._load_adapter)
        self._loop: Optional[EngineLoop] = None
        self._follower: Optional[threading.Thread] = None
        if self._engine.is_leader:
            self._loop = EngineLoop(self._engine)
        else:
            self._follower = threading.Thread(target=self._follow,
                                              name="inference-follower",
                                              daemon=True)
            self._follower.start()

    def _follow(self) -> None:
        """A follower rank's thread: `follow()` until the stop record. A
        fault (here, or the leader's records stopping past the group's
        timeout) ends this rank's process, so the controller restarts the
        gang as a unit: its ranks are out of step for good."""
        try:
            self._engine.follow()
        except BaseException:  # noqa: BLE001 — the gang restarts on it
            logger.exception("tp follower failed: ending this rank")
            logging.shutdown()
            os._exit(1)

    def _submit(self, *args, **kwargs):
        if self._loop is None:
            raise RuntimeError("a tp follower rank takes no requests: "
                               "rank 0 of the gang serves them")
        return self._loop.submit(*args, **kwargs)

    def _load_adapter(self, model_id: str):
        """Engine adapter source: spec -> deterministic weights (the
        parity and chaos tests depend on seed => same bytes)."""
        from ray_tpu_torch.models.llama import make_adapter_weights

        spec = self._adapter_specs.get(model_id)
        if spec is None:
            raise ValueError(
                f"unknown model {model_id!r} (registered: "
                f"{sorted(self._adapter_specs)})")
        return make_adapter_weights(
            self._engine._model.config,
            rank=int(spec.get("rank", 8)),
            seed=int(spec.get("seed", 0)),
            scale=float(spec.get("scale", 0.05)))

    # ------------------------------------------------------------ complete

    async def __call__(self, payload=None):
        # HTTP clients reach methods only through __call__: a
        # ``"stream": true`` field switches to the token stream (the
        # replica pumps the returned async generator, the proxy relays
        # it as chunked JSON lines).
        if isinstance(payload, dict) and payload.get("stream"):
            return self.stream(payload)
        return await self.generate(payload)

    async def generate(self, payload=None):
        ids, max_new, model_id, slo = _parse(payload, self._default_new)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()

        def on_finish(req):
            def _resolve():
                if fut.done():
                    return
                if req.error:
                    fut.set_exception(RuntimeError(req.error))
                else:
                    fut.set_result(None)
            loop.call_soon_threadsafe(_resolve)

        req = self._submit(ids, max_new, on_finish=on_finish,
                           model_id=model_id, slo_class=slo)
        try:
            await fut
        except asyncio.CancelledError:
            # Caller abandoned the request: release its slot and blocks.
            self._engine.cancel(req.request_id)
            raise
        return {"ids": _ints(req)}

    # -------------------------------------------------------------- stream

    async def stream(self, payload=None):
        """Async generator: one ``{"token": t}`` per produced token, then
        ``{"done": True, "ids": [...]}`` — replica pumps it through the
        stream queue, the proxy relays chunked JSON lines, handles iterate
        it with ``options(stream=True)``."""
        ids, max_new, model_id, slo = _parse(payload, self._default_new)
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def on_token(req, token):
            loop.call_soon_threadsafe(queue.put_nowait, ("token", int(token)))

        def on_finish(req):
            loop.call_soon_threadsafe(queue.put_nowait, ("end", req))

        req = self._submit(ids, max_new, on_token=on_token,
                           on_finish=on_finish, model_id=model_id,
                           slo_class=slo)
        try:
            while True:
                kind, item = await queue.get()
                if kind == "token":
                    yield {"token": item}
                else:
                    if item.error:
                        raise RuntimeError(item.error)
                    yield {"done": True, "ids": _ints(item)}
                    return
        finally:
            # Client gone mid-stream (the replica's pump was cancelled /
            # the generator closed): abort the engine request so its
            # batch slot and KV blocks go back to live traffic instead
            # of decoding to budget for nobody. No-op when finished.
            self._engine.cancel(req.request_id)

    # ------------------------------------------------------------- control

    def metrics(self, _=None) -> Dict[str, Any]:
        return self._engine.stats()

    def __serve_metrics__(self) -> Dict[str, Any]:
        """Autoscaling signal (replica merges this into its stats): queued
        requests count toward pressure exactly like in-flight ones. For
        multiplexed replicas the resident adapter ids ride along — the
        controller pushes them in the routing table so routers prefer a
        replica that already holds the request's adapter."""
        stats = self._engine.stats()
        out = {"queue_depth": stats["queue_depth"],
               "running": stats["running"],
               "tokens_per_sec": stats["tokens_per_sec"],
               "prefix_hit_rate": stats["prefix_cache"].get("hit_rate", 0.0)}
        adapters = stats.get("adapters")
        if adapters is not None:
            out["adapters"] = adapters["resident"]
        return out

    def __serve_shutdown__(self) -> None:
        if self._loop is not None:
            self._loop.stop()
