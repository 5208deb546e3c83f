"""Lazy task DAGs: build with `.bind()`, run with `.execute()`.

The port's counterpart of `ray_tpu.dag`, the equivalent of the
reference's DAG API (`python/ray/dag/`): `fn.bind(...)`
returns a node instead of submitting; nodes compose into a DAG whose
`execute()` submits every task with its dependencies wired as ObjectRefs
(so the scheduler sees the whole graph's edges, and shared subtrees run
once). `InputNode` parameterizes a DAG for repeated execution.

    with InputNode() as x:
        dag = postprocess.bind(model.bind(x))
    out = ray_tpu_torch.get(dag.execute(batch))
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["DAGNode", "FunctionNode", "InputNode", "InputAttributeNode"]


class DAGNode:
    """Base: a lazily-bound computation with upstream DAGNode args."""

    def execute(self, *input_args, **input_kwargs):
        """Submit the whole DAG; returns the ObjectRef of this node's
        result. Shared nodes are submitted exactly once per execute."""
        cache: Dict[int, Any] = {}
        return self._resolve(cache, input_args, input_kwargs)

    def _resolve(self, cache, input_args, input_kwargs):
        raise NotImplementedError

    @staticmethod
    def _resolve_arg(arg, cache, input_args, input_kwargs):
        if isinstance(arg, DAGNode):
            return arg._resolve(cache, input_args, input_kwargs)
        if isinstance(arg, (list, tuple)):
            return type(arg)(
                DAGNode._resolve_arg(a, cache, input_args, input_kwargs)
                for a in arg)
        if isinstance(arg, dict):
            return {k: DAGNode._resolve_arg(v, cache, input_args,
                                            input_kwargs)
                    for k, v in arg.items()}
        return arg


class FunctionNode(DAGNode):
    """`remote_fn.bind(...)`: one task in the DAG."""

    def __init__(self, remote_fn, args: Tuple, kwargs: Dict,
                 options: Optional[Dict] = None):
        self._fn = remote_fn
        self._args = args
        self._kwargs = kwargs
        self._options = options or {}

    def options(self, **opts) -> "FunctionNode":
        return FunctionNode(self._fn, self._args, self._kwargs,
                            {**self._options, **opts})

    def _resolve(self, cache, input_args, input_kwargs):
        key = id(self)
        if key in cache:
            return cache[key]
        args = [self._resolve_arg(a, cache, input_args, input_kwargs)
                for a in self._args]
        kwargs = {k: self._resolve_arg(v, cache, input_args, input_kwargs)
                  for k, v in self._kwargs.items()}
        fn = self._fn.options(**self._options) if self._options else self._fn
        ref = fn.remote(*args, **kwargs)
        cache[key] = ref
        return ref

    # -- introspection (used by workflow's deterministic step ids) -------- #

    def _children(self) -> List["DAGNode"]:
        out: List[DAGNode] = []

        def walk(a):
            if isinstance(a, DAGNode):
                out.append(a)
            elif isinstance(a, (list, tuple)):
                for x in a:
                    walk(x)
            elif isinstance(a, dict):
                for x in a.values():
                    walk(x)

        for a in self._args:
            walk(a)
        for a in self._kwargs.values():
            walk(a)
        return out

    @property
    def name(self) -> str:
        fn = getattr(self._fn, "_function", None)
        return getattr(fn, "__name__", "task")

    def __repr__(self):
        return f"FunctionNode({self.name})"


class InputNode(DAGNode):
    """Placeholder for execute()-time arguments (reference
    `ray.dag.InputNode`); supports `with InputNode() as x:` and
    attribute/index access for multi-field inputs."""

    _local = threading.local()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _resolve(self, cache, input_args, input_kwargs):
        if not input_args and not input_kwargs:
            raise ValueError("DAG has an InputNode: execute() needs arguments")
        if len(input_args) == 1 and not input_kwargs:
            return input_args[0]
        return (input_args, input_kwargs)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return InputAttributeNode(self, name, kind="attr")

    def __getitem__(self, key):
        return InputAttributeNode(self, key, kind="item")


class InputAttributeNode(DAGNode):
    def __init__(self, parent: InputNode, key, kind: str):
        self._parent = parent
        self._key = key
        self._kind = kind

    def _resolve(self, cache, input_args, input_kwargs):
        if self._kind == "item" and isinstance(self._key, int) \
                and not input_kwargs:
            return input_args[self._key]
        if self._key in input_kwargs:
            return input_kwargs[self._key]
        base = self._parent._resolve(cache, input_args, input_kwargs)
        return getattr(base, self._key) if self._kind == "attr" \
            else base[self._key]
