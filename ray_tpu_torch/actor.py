"""Actor API: `@ray_tpu_torch.remote` on a class.

Equivalent of `python/ray/actor.py` (`ActorClass._remote` :660, `ActorHandle`,
`ActorMethod`): creation registers the actor with the GCS, which schedules a
dedicated worker; method calls go over the direct worker transport with
per-caller ordering. Handles are picklable and resolvable by name.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.common import TaskSpec, normalize_resources
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.ids import ActorID, TaskID
from ray_tpu_torch.exceptions import RaySystemError
from ray_tpu_torch.object_ref import ObjectRef

_VALID_ACTOR_OPTIONS = {
    "num_cpus", "num_gpus", "memory", "resources", "max_restarts",
    "max_task_retries", "max_concurrency", "name", "namespace", "lifetime",
    "get_if_exists", "scheduling_strategy", "runtime_env", "_metadata",
}


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def options(self, num_returns: int = 1, **_ignored) -> "ActorMethod":
        return ActorMethod(self._handle, self._method_name, num_returns)

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._method_name, args, kwargs,
                                    self._num_returns)


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str = "Actor",
                 method_num_returns: Optional[Dict[str, int]] = None):
        self._ray_actor_id = actor_id
        self._class_name = class_name
        self._method_num_returns = method_num_returns or {}

    @property
    def _actor_id(self) -> ActorID:
        return self._ray_actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name, self._method_num_returns.get(name, 1))

    def _invoke(self, method_name: str, args, kwargs, num_returns: int):
        import ray_tpu_torch

        runtime = ray_tpu_torch._require_runtime()
        ser_args, kwargs_keys, nested_refs = runtime.serialize_args(args, kwargs)
        spec = TaskSpec(
            task_id=TaskID.for_actor_task(self._ray_actor_id),
            job_id=runtime.job_id,
            name=f"{self._class_name}.{method_name}",
            function_id=None,
            function_blob=None,
            args=ser_args,
            kwargs_keys=kwargs_keys,
            num_returns=num_returns,
            actor_id=self._ray_actor_id,
            method_name=method_name,
            owner_address=runtime.worker_id.hex(),
            nested_refs=nested_refs,
        )
        return_ids = runtime.submit_actor_task(spec)
        refs = [ObjectRef(oid) for oid in return_ids]
        if num_returns == 1:
            return refs[0]
        return refs if num_returns else None

    def __ray_terminate__(self):
        return self._invoke("__ray_terminate__", (), {}, 0)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._ray_actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._ray_actor_id, self._class_name,
                              self._method_num_returns))

    def __hash__(self):
        return hash(self._ray_actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and \
            other._ray_actor_id == self._ray_actor_id


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        bad = set(self._options) - _VALID_ACTOR_OPTIONS
        if bad:
            raise ValueError(f"Invalid actor options: {bad}")
        self._class_blob: Optional[bytes] = None

    def options(self, **kwargs) -> "ActorClass":
        merged = dict(self._options)
        merged.update(kwargs)
        return ActorClass(self._cls, merged)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote().")

    @property
    def cls(self):
        return self._cls

    def remote(self, *args, **kwargs) -> ActorHandle:
        import ray_tpu_torch

        runtime = ray_tpu_torch._require_runtime()
        opts = self._options
        name = opts.get("name")
        namespace = opts.get("namespace") or runtime.namespace
        if name and opts.get("get_if_exists"):
            try:
                actor_id, spec = runtime.get_named_actor(name, namespace)
                return ActorHandle(actor_id, self._cls.__name__)
            except ValueError:
                pass
        if self._class_blob is None:
            self._class_blob = serialization.dumps(self._cls)
        # Reference semantics: an actor with no explicit resource request
        # needs 1 CPU to schedule its creation task but holds 0 for its
        # lifetime (placement vs lifetime resources).
        explicit = any(opts.get(k) is not None for k in
                       ("num_cpus", "num_gpus", "memory", "resources"))
        resources = normalize_resources(
            num_cpus=opts.get("num_cpus"),
            num_gpus=opts.get("num_gpus"),
            memory=opts.get("memory"),
            resources=opts.get("resources"),
            default_cpus=0.0,
        )
        from ray_tpu_torch.remote_function import _resolve_pg_strategy

        resources, strategy, pg_id, bundle_idx = _resolve_pg_strategy(opts, resources)
        # Placement must be computed AFTER PG rewriting so the creation task
        # requests the bundle-formatted resource names, not raw CPU the
        # placement group already absorbed.
        if pg_id is not None:
            placement_resources = dict(resources)
            if not explicit:
                # Default-resource actor in a PG: admission-control against
                # the bundle so N such actors can't all land concurrently on
                # a saturated bundle (mirror of the non-PG 1-CPU default).
                # Wildcard index (-1) gates on the group-wide wildcard
                # resource instead.
                from ray_tpu_torch.core.common import (
                    pg_bundle_resource_name,
                    pg_wildcard_resource_name,
                )

                strategy_obj = opts.get("scheduling_strategy")
                pg = strategy_obj.placement_group
                idx = strategy_obj.placement_group_bundle_index
                bundle = pg.bundles[idx] if idx >= 0 else pg.bundles[0]
                if bundle:
                    r, amt = next(iter(sorted(bundle.items())))
                    name = pg_bundle_resource_name(r, idx, pg.id) if idx >= 0 \
                        else pg_wildcard_resource_name(r, pg.id)
                    placement_resources = {name: min(1.0, amt)}
        else:
            placement_resources = dict(resources) if explicit else {"CPU": 1.0}
        ser_args, kwargs_keys, nested_refs = runtime.serialize_args(args, kwargs)
        actor_id = ActorID.of(runtime.job_id)
        spec = TaskSpec(
            task_id=TaskID.for_actor_creation(actor_id),
            job_id=runtime.job_id,
            name=self._cls.__name__,
            function_id=None,
            function_blob=None,
            args=ser_args,
            kwargs_keys=kwargs_keys,
            num_returns=0,
            resources=resources,
            placement_resources=placement_resources,
            actor_id=actor_id,
            actor_creation=True,
            actor_class_blob=self._class_blob,
            # Same contract as task_max_retries in remote_function.py:
            # the declared knob is the default, options() overrides it.
            actor_max_restarts=opts.get("max_restarts",
                                        GLOBAL_CONFIG.actor_max_restarts),
            actor_max_concurrency=opts.get("max_concurrency", 1),
            actor_name=name,
            actor_namespace=namespace,
            actor_lifetime=opts.get("lifetime"),
            scheduling_strategy=strategy,
            placement_group_id=pg_id,
            placement_group_bundle_index=bundle_idx,
            owner_address=runtime.worker_id.hex(),
            runtime_env=opts.get("runtime_env"),
            nested_refs=nested_refs,
        )
        try:
            runtime.create_actor(spec)
        except RaySystemError:
            if not (name and opts.get("get_if_exists")):
                raise
            # Another creator registered the name between our lookup and
            # our registration: get_if_exists returns its actor.
            try:
                actor_id, _ = runtime.get_named_actor(name, namespace)
            except ValueError:
                raise RaySystemError(
                    f"actor {name!r} could be neither created nor found"
                ) from None
        return ActorHandle(actor_id, self._cls.__name__)
