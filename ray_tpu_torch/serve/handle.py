"""DeploymentHandle: Python-side entry into a deployment.

Equivalent of the reference's `RayServeHandle` (`serve/handle.py:78`).
``handle.remote(arg)`` routes through the process-local Router (admission
control + least-loaded choice) and returns an ObjectRef; composition
between deployments works because handles pickle down to their deployment
name and rebuild their router lazily inside the borrowing process.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

_router_lock = threading.Lock()
_router = None


def _process_router():
    """One Router per process, shared by every handle and thread (shared
    in-flight accounting keeps max_concurrent_queries global to the
    process)."""
    global _router
    import ray_tpu_torch
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME, SERVE_NAMESPACE
    from ray_tpu_torch.serve.router import Router

    with _router_lock:
        if _router is None or _router._stopped:
            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                                 namespace=SERVE_NAMESPACE)
            _router = Router(controller)
        return _router


def _drop_process_router():
    global _router
    with _router_lock:
        if _router is not None:
            _router.stop()
            _router = None


class DeploymentHandle:
    def __init__(self, deployment_name: str, method_name: str = "__call__",
                 stream: bool = False):
        self._deployment = deployment_name
        self._method = method_name
        self._stream = stream

    def options(self, method_name: Optional[str] = None,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        return DeploymentHandle(self._deployment,
                                method_name or self._method,
                                self._stream if stream is None else stream)

    def method(self, name: str) -> "DeploymentHandle":
        return DeploymentHandle(self._deployment, name, self._stream)

    def remote(self, *args, **kwargs) -> Any:
        ref = _process_router().assign(
            self._deployment, self._method, args, kwargs)
        if not self._stream:
            return ref
        return _StreamingResult(self._deployment, ref)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self._deployment, name, self._stream)

    def __reduce__(self):
        return DeploymentHandle, (self._deployment, self._method,
                                  self._stream)

    def __eq__(self, other):
        # Value equality so an unchanged redeploy (same graph, fresh handle
        # objects) doesn't read as a code change and drain replicas.
        return (isinstance(other, DeploymentHandle)
                and self._deployment == other._deployment
                and self._method == other._method)

    def __hash__(self):
        return hash((self._deployment, self._method))

    def __repr__(self):
        return f"DeploymentHandle({self._deployment!r}, {self._method!r})"


class _StreamingResult:
    """Iterator over a streamed deployment response
    (`handle.options(stream=True)`, reference streaming handles): the
    replica pumps generator items into a queue; this pulls batches via
    its stream_next method until exhaustion."""

    def __init__(self, deployment: str, ref):
        self._deployment = deployment
        self._ref = ref
        self._sid: Optional[str] = None
        self._buffer: list = []
        self._done = False

    def _start(self):
        import ray_tpu_torch

        marker = ray_tpu_torch.get(self._ref)
        if not (isinstance(marker, dict) and "__serve_stream__" in marker):
            # Non-generator result: yield it once for iterator symmetry.
            self._buffer = [marker]
            self._done = True
            return
        self._sid = marker["__serve_stream__"]

    def _replica_handle(self):
        handle = _process_router().replica_for_stream(
            self._deployment, self._sid)
        if handle is None:
            raise RuntimeError(
                f"replica for stream {self._sid} no longer in the routing "
                f"table; stream lost")
        return handle

    def __iter__(self):
        import ray_tpu_torch

        if self._sid is None and not self._done:
            self._start()
        while self._buffer or not self._done:
            while self._buffer:
                yield self._buffer.pop(0)
            if self._done:
                return
            batch = ray_tpu_torch.get(
                self._replica_handle().stream_next.remote(self._sid))
            self._buffer.extend(batch.get("items") or [])
            if batch.get("error"):
                self._done = True
                while self._buffer:
                    yield self._buffer.pop(0)
                raise RuntimeError(f"streamed call failed: {batch['error']}")
            if batch.get("done"):
                self._done = True
