"""ray_tpu_torch.serve — model serving on the actor substrate.

API parity with the reference's `ray.serve` (`serve/api.py:267`,
`deployment.py:97`): ``@serve.deployment``, ``.bind()``, ``serve.run``,
``serve.shutdown``, ``serve.status``, ``get_deployment_handle``, and
``@serve.batch``. A deployment's replicas are actors scheduled with their
own resource grants (``num_gpus=1`` replicas own a card, see it as
``CUDA_VISIBLE_DEVICES``, and run batched inference on it; see
`batching.py`), the controller reconciles
replica actors and autoscales on queue depth, and per-node aiohttp proxies
front HTTP traffic.

Typical flow:

    @serve.deployment(num_replicas=2, max_concurrent_queries=4)
    class Echo:
        def __call__(self, payload):
            return payload

    app = Echo.bind()
    handle = serve.run(app)
    out = ray_tpu_torch.get(handle.remote({"x": 1}))
    serve.shutdown()
"""

from __future__ import annotations

import copy
import logging
import time
from dataclasses import replace as _dc_replace
from typing import Any, Callable, Dict, Optional, Union

from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.handle import DeploymentHandle, _drop_process_router
from ray_tpu_torch.shardgroup.spec import ShardSpec

logger = logging.getLogger(__name__)

_PROXY_NAME = "SERVE_PROXY"
_GRPC_PROXY_NAME = "SERVE_GRPC_PROXY"


class Application:
    """A bound deployment (class + init args), ready for serve.run."""

    def __init__(self, deployment: "Deployment", args, kwargs):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs


class Deployment:
    def __init__(self, target: Union[type, Callable], name: str,
                 config: DeploymentConfig):
        self._target = target
        self.name = name
        self.config = config

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                max_concurrent_queries: Optional[int] = None,
                autoscaling_config: Optional[AutoscalingConfig] = None,
                route_prefix: Optional[str] = None,
                ray_actor_options: Optional[Dict[str, Any]] = None,
                user_config: Any = None,
                shard_spec: Optional["ShardSpec"] = None,
                tenant: Optional[str] = None
                ) -> "Deployment":
        cfg = _dc_replace(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_concurrent_queries is not None:
            cfg.max_concurrent_queries = max_concurrent_queries
        if autoscaling_config is not None:
            cfg.autoscaling = autoscaling_config
        if route_prefix is not None:
            cfg.route_prefix = route_prefix
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        if user_config is not None:
            cfg.user_config = user_config
        if shard_spec is not None:
            cfg.shard_spec = shard_spec
        if tenant is not None:
            cfg.tenant = tenant
        return Deployment(self._target, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    @property
    def user_callable(self):
        if isinstance(self._target, type):
            return self._target
        from ray_tpu_torch.serve.replica import make_function_wrapper

        return make_function_wrapper(self._target)


def deployment(_target=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_concurrent_queries: int = 8,
               autoscaling_config: Optional[AutoscalingConfig] = None,
               route_prefix: Optional[str] = None,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               user_config: Any = None,
               shard_spec: Optional["ShardSpec"] = None,
               tenant: Optional[str] = None):
    """`@serve.deployment` on a class or function."""

    def wrap(target):
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            autoscaling=autoscaling_config,
            route_prefix=route_prefix,
            ray_actor_options=dict(ray_actor_options or {}),
            user_config=user_config,
            shard_spec=shard_spec,
            tenant=tenant,
        )
        return Deployment(target, name or target.__name__, cfg)

    return wrap(_target) if _target is not None else wrap


def ingress(app):
    """Expose an ASGI application as a deployment's HTTP interface.

    Reference `serve.ingress` (`python/ray/serve/api.py`): FastAPI /
    Starlette / any ASGI3 callable. HTTP requests routed to the
    deployment are translated to ASGI scope events on the replica
    (`replica.py:_handle_asgi`); streamed bodies relay back through the
    proxy's stream protocol.

    ``app`` may be the ASGI callable itself, a zero-arg factory
    returning one (for apps that don't pickle), or a one-arg factory
    receiving the deployment instance (routes needing deployment state)::

        @serve.deployment
        @serve.ingress(fastapi_app)
        class Api: ...
    """

    def wrap(cls):
        if not isinstance(cls, type):
            raise TypeError(
                "serve.ingress decorates the deployment class; apply it "
                "under @serve.deployment")
        cls.__serve_asgi_app__ = app
        return cls

    return wrap


# --------------------------------------------------------------------------- #
# Cluster-facing operations
# --------------------------------------------------------------------------- #


def _get_or_create_controller(create: bool = True):
    import ray_tpu_torch
    from ray_tpu_torch.serve.controller import (
        CONTROLLER_NAME,
        SERVE_NAMESPACE,
        ServeController,
    )

    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
    except Exception:  # noqa: BLE001 — not started yet
        if not create:
            raise
    controller = ray_tpu_torch.remote(ServeController).options(
        name=CONTROLLER_NAME, namespace=SERVE_NAMESPACE,
        lifetime="detached", max_concurrency=64, num_cpus=0.1,
    ).remote()
    # Crash recovery (reference controller.py:75): a checkpoint in the
    # GCS KV means a previous controller died — rebuild its state and
    # re-adopt surviving named replicas before reconciling.
    ray_tpu_torch.get(controller.restore.remote(), timeout=60.0)
    controller.reconcile_forever.remote()
    return controller


def start(http_host: str = "127.0.0.1", http_port: int = 8000,
          detached: bool = True, proxy_location: str = "HeadOnly") -> None:
    """Start the Serve control plane (controller + HTTP proxy).

    proxy_location="EveryNode" puts a controller-managed, health-checked
    proxy on every alive node (reference http_state.py:110); the default
    keeps the single head proxy.
    """
    controller = _get_or_create_controller()
    if proxy_location == "EveryNode":
        import ray_tpu_torch

        ray_tpu_torch.get(controller.set_proxy_config.remote(
            http_host, http_port, True), timeout=60.0)
    else:
        _ensure_proxy(http_host, http_port)


def _ensure_proxy_actor(name: str, cls, host: str, port: int) -> int:
    """Get-or-create a detached proxy actor and wait for its bound port —
    one implementation for the HTTP and gRPC front doors."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.controller import SERVE_NAMESPACE

    try:
        proxy = ray_tpu_torch.get_actor(name, namespace=SERVE_NAMESPACE)
    except Exception:  # noqa: BLE001
        proxy = ray_tpu_torch.remote(cls).options(
            name=name, namespace=SERVE_NAMESPACE,
            lifetime="detached", max_concurrency=256, num_cpus=0.1,
        ).remote(host, port)
    return ray_tpu_torch.get(proxy.ready.remote(), timeout=60.0)


def _ensure_proxy(host: str, port: int) -> int:
    from ray_tpu_torch.serve.proxy import HTTPProxy

    return _ensure_proxy_actor(_PROXY_NAME, HTTPProxy, host, port)


def _graph_order(root: Application) -> list:
    """Applications of a composed graph, dependencies first (reference
    deployment graphs: `Driver.bind(model_a.bind(), model_b.bind())`).
    Nested Applications in init args become DeploymentHandles at deploy
    time. Cycles and name collisions are errors."""
    order: list = []
    visiting: set = set()

    def walk_value(value):
        if isinstance(value, Application):
            walk(value)
        elif isinstance(value, (list, tuple)):
            for v in value:
                walk_value(v)
        elif isinstance(value, dict):
            for v in value.values():
                walk_value(v)

    def walk(app: Application):
        if any(a is app for a in order):
            return
        if id(app) in visiting:
            raise ValueError("deployment graph has a cycle at "
                             f"{app.deployment.name!r}")
        visiting.add(id(app))
        # Mirror _sub_handles' traversal exactly: anything that will be
        # substituted with a handle must also be deployed.
        for arg in list(app.init_args) + list(app.init_kwargs.values()):
            walk_value(arg)
        visiting.discard(id(app))
        order.append(app)

    walk(root)
    by_name: Dict[str, Application] = {}
    for a in order:
        other = by_name.setdefault(a.deployment.name, a)
        if other is not a:
            raise ValueError(
                f"two different bindings share the deployment name "
                f"{a.deployment.name!r}; use .options(name=...) to rename")
    return order


def _contains_app(value) -> bool:
    if isinstance(value, Application):
        return True
    if isinstance(value, (list, tuple)):
        return any(_contains_app(v) for v in value)
    if isinstance(value, dict):
        return any(_contains_app(v) for v in value.values())
    return False


def _sub_handles(value):
    if isinstance(value, Application):
        return DeploymentHandle(value.deployment.name)
    if not _contains_app(value):
        # Identity fast-path: containers without bindings pass through
        # untouched (preserving dict/list subclasses and their state).
        return value
    if isinstance(value, tuple) and hasattr(value, "_fields"):  # namedtuple
        return type(value)(*(_sub_handles(v) for v in value))
    if isinstance(value, (list, tuple)):
        return type(value)(_sub_handles(v) for v in value)
    if isinstance(value, dict):
        subbed = {k: _sub_handles(v) for k, v in value.items()}
        try:  # keep dict subclasses (defaultdict, OrderedDict, ...) intact
            out = copy.copy(value)
            out.clear()
            out.update(subbed)
            return out
        except Exception:  # noqa: BLE001 — exotic mapping; plain dict is fine
            return subbed
    return value


def _check_no_stray_apps(value, owner: str):
    """Applications hiding in containers the graph traversal does not
    descend into (sets, frozensets, arbitrary object attributes) would be
    pickled as inert data — fail loudly at deploy time instead."""
    if isinstance(value, Application):
        raise ValueError(
            f"un-substituted bound deployment in init args of {owner!r}: "
            "nested Applications are only resolved inside lists, tuples and "
            "dict values")
    if isinstance(value, (list, tuple, set, frozenset)):
        for v in value:
            _check_no_stray_apps(v, owner)
    elif isinstance(value, dict):
        for k, v in value.items():
            _check_no_stray_apps(k, owner)  # bindings as KEYS escape
            _check_no_stray_apps(v, owner)  # the substitution traversals


def run(app: Union[Application, Deployment], *, _blocking: bool = False,
        http: bool = False, http_host: str = "127.0.0.1",
        http_port: int = 8000, timeout_s: float = 60.0
        ) -> DeploymentHandle:
    """Deploy an application — or a whole composed graph (bound
    deployments passed as init args become live DeploymentHandles) — and
    wait until the initial replicas are RUNNING, dependencies first."""
    import ray_tpu_torch

    if isinstance(app, Deployment):
        app = app.bind()
    controller = _get_or_create_controller()
    for a in _graph_order(app):
        dep = a.deployment
        sub_args = _sub_handles(tuple(a.init_args))
        sub_kwargs = _sub_handles(dict(a.init_kwargs))
        _check_no_stray_apps(sub_args, dep.name)
        _check_no_stray_apps(sub_kwargs, dep.name)
        ray_tpu_torch.get(controller.deploy.remote(
            dep.name, dep.user_callable, sub_args, sub_kwargs,
            dep.config), timeout=timeout_s)
        ok = ray_tpu_torch.get(controller.wait_ready.remote(dep.name, timeout_s),
                         timeout=timeout_s + 5.0)
        if not ok:
            raise TimeoutError(
                f"deployment {dep.name!r} did not become ready "
                f"in {timeout_s}s")
    if http:
        _ensure_proxy(http_host, http_port)
    return DeploymentHandle(app.deployment.name)


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def register_tenant(name: str, *, tier: str = "bronze", weight: int = 0,
                    rps_limit: float = 0.0, burst: float = 0.0,
                    max_inflight: int = 0,
                    timeout_s: float = 30.0) -> None:
    """Create or update a tenant (docs/MULTITENANCY.md): a named
    principal with a priority tier (gold/silver/bronze), a request-rate
    quota (token bucket, over-quota requests answer 429 + Retry-After),
    a per-proxy in-flight cap, and a weighted-fair-queueing weight used
    when replica capacity is contended. Deployments bind to a tenant via
    ``@serve.deployment(tenant=...)``; the tenant must be registered
    before its deployments deploy."""
    import ray_tpu_torch
    from ray_tpu_torch.tenancy.registry import TenantSpec

    spec = TenantSpec(name=name, tier=tier, weight=weight,
                      rps_limit=rps_limit, burst=burst,
                      max_inflight=max_inflight)
    controller = _get_or_create_controller()
    ray_tpu_torch.get(controller.register_tenant.remote(spec.qos()),
                timeout=timeout_s)


def unregister_tenant(name: str, timeout_s: float = 30.0) -> None:
    """Remove a tenant; fails while it still owns deployments."""
    import ray_tpu_torch

    controller = _get_or_create_controller(create=False)
    ray_tpu_torch.get(controller.unregister_tenant.remote(name),
                timeout=timeout_s)


def tenants(timeout_s: float = 10.0) -> Dict[str, Dict[str, Any]]:
    """The registered tenants and their QoS specs."""
    import ray_tpu_torch

    try:
        controller = _get_or_create_controller(create=False)
    except Exception:  # noqa: BLE001 — no live controller: no tenants
        return {}
    return ray_tpu_torch.get(controller.tenants.remote(), timeout=timeout_s)


def status() -> Dict[str, Any]:
    import ray_tpu_torch

    try:
        controller = _get_or_create_controller(create=False)
    except Exception:  # noqa: BLE001 — no live controller
        # Transparent crash recovery: recreate ONLY when a previous
        # controller left a checkpoint — a status probe on a cluster that
        # never ran Serve must stay a read, not spawn a control plane.
        from ray_tpu_torch.serve.controller import ServeController

        runtime = ray_tpu_torch._require_runtime()
        ckpt = runtime.gcs.call(
            "kv_get", {"key": ServeController.CKPT_KEY})["value"]
        if not ckpt:
            return {}
        controller = _get_or_create_controller(create=True)
    return ray_tpu_torch.get(controller.status.remote(), timeout=10.0)


def http_port() -> int:
    """The bound port of the local HTTP proxy (starts it if needed)."""
    return _ensure_proxy("127.0.0.1", 0)


def grpc_port() -> int:
    """The bound port of the local gRPC proxy (starts it if needed).
    Requests route as `/ray_tpu_torch.serve/<Deployment>` with raw-bytes
    request/response (msgpack-decodable bodies are decoded for the
    deployment callable) — see serve/grpc_proxy.py."""
    return _ensure_grpc_proxy("127.0.0.1", 0)


def _ensure_grpc_proxy(host: str, port: int) -> int:
    from ray_tpu_torch.serve.grpc_proxy import GrpcProxy

    return _ensure_proxy_actor(_GRPC_PROXY_NAME, GrpcProxy, host, port)


def delete(name: str, timeout_s: float = 30.0) -> None:
    import ray_tpu_torch

    controller = _get_or_create_controller(create=False)
    ray_tpu_torch.get(controller.delete.remote(name), timeout=timeout_s)


def shutdown() -> None:
    """Tear down all deployments, the proxy, and the controller."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.controller import (
        CONTROLLER_NAME,
        SERVE_NAMESPACE,
    )

    _drop_process_router()
    for name in (_PROXY_NAME, _GRPC_PROXY_NAME):
        try:
            proxy = ray_tpu_torch.get_actor(name, namespace=SERVE_NAMESPACE)
            try:
                ray_tpu_torch.get(proxy.stop.remote(), timeout=5.0)
            except Exception:  # noqa: BLE001
                pass
            ray_tpu_torch.kill(proxy)
        except Exception:  # noqa: BLE001
            pass
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                             namespace=SERVE_NAMESPACE)
    except Exception:  # noqa: BLE001
        return
    try:
        ray_tpu_torch.get(controller.graceful_shutdown.remote(), timeout=10.0)
    except Exception:  # noqa: BLE001
        pass
    try:
        ray_tpu_torch.kill(controller)
    except Exception:  # noqa: BLE001
        pass


def build(app):
    """Application -> editable config dict (reference `serve build`)."""
    from ray_tpu_torch.serve.schema import build as _build

    return _build(app)


def deploy_config(config, *, timeout_s: float = 60.0):
    """Deploy applications from a config dict (reference REST deploy)."""
    from ray_tpu_torch.serve.schema import deploy_config as _deploy

    return _deploy(config, timeout_s=timeout_s)


__all__ = [
    "Application", "AutoscalingConfig", "Deployment", "DeploymentConfig",
    "DeploymentHandle", "ShardSpec", "batch", "build", "delete",
    "deploy_config", "deployment", "get_deployment_handle", "grpc_port",
    "http_port", "ingress", "register_tenant", "run", "shutdown", "start",
    "status", "tenants", "unregister_tenant",
]
