"""Declarative Serve config: build an app to a dict/YAML, deploy from one.

Equivalent of the reference's `python/ray/serve/schema.py` +
`serve build`/`serve deploy` CLI flow: an application is described by an
import path plus per-deployment config overrides, validated and applied
without touching the application code. Plain dicts rather than pydantic
models (not a baked-in dependency) — `validate_config` gives the same
fail-at-submit ergonomics.

Config shape::

    http: {host: "127.0.0.1", port: 8000}
    applications:
      - name: default
        import_path: my_module:app        # Application or Deployment
        deployments:                      # optional per-deployment overrides
          - name: GPT2Sampler
            num_replicas: 2
            max_concurrent_queries: 16
            autoscaling: {min_replicas: 1, max_replicas: 4,
                          target_ongoing_requests: 2.0}
            route_prefix: /gpt2
"""

from __future__ import annotations

import importlib
from dataclasses import asdict
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve.config import AutoscalingConfig

_DEPLOYMENT_KEYS = {"name", "num_replicas", "max_concurrent_queries",
                    "autoscaling", "route_prefix", "ray_actor_options",
                    "shard_spec"}


def validate_config(config: Dict[str, Any]) -> None:
    if not isinstance(config, dict):
        raise ValueError("serve config must be a mapping")
    apps = config.get("applications")
    if not isinstance(apps, list) or not apps:
        raise ValueError("serve config needs a non-empty 'applications' list")
    for app in apps:
        if "import_path" not in app:
            raise ValueError(
                f"application {app.get('name', '?')!r} needs an import_path "
                "('module:attribute')")
        if ":" not in app["import_path"]:
            raise ValueError(
                f"import_path {app['import_path']!r} must be "
                "'module:attribute'")
        for dep in app.get("deployments", []) or []:
            if "name" not in dep:
                raise ValueError("every deployment override needs a 'name'")
            unknown = set(dep) - _DEPLOYMENT_KEYS
            if unknown:
                raise ValueError(
                    f"unknown deployment option(s) {sorted(unknown)} for "
                    f"{dep['name']!r}; valid: {sorted(_DEPLOYMENT_KEYS)}")
    http = config.get("http") or {}
    if http and not isinstance(http.get("port", 0), int):
        raise ValueError("http.port must be an integer")


def import_attr(import_path: str):
    module_name, attr = import_path.split(":", 1)
    module = importlib.import_module(module_name)
    obj = module
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _apply_overrides(app, overrides: List[Dict[str, Any]]):
    """Return the app graph with per-deployment config overrides applied.

    Deployment objects are shared by reference inside Application nodes;
    overriding swaps each affected node's deployment for an `.options()`
    copy so the caller's module-level objects stay untouched.
    """
    from ray_tpu_torch.serve import Application

    by_name = {o["name"]: o for o in overrides}
    consumed = set()

    def overridden(dep):
        o = by_name.get(dep.name)
        if not o:
            return dep
        consumed.add(dep.name)
        kwargs: Dict[str, Any] = {}
        if "num_replicas" in o:
            kwargs["num_replicas"] = int(o["num_replicas"])
        if "max_concurrent_queries" in o:
            kwargs["max_concurrent_queries"] = int(o["max_concurrent_queries"])
        if "route_prefix" in o:
            kwargs["route_prefix"] = o["route_prefix"]
        if "ray_actor_options" in o:
            kwargs["ray_actor_options"] = dict(o["ray_actor_options"])
        if "autoscaling" in o and o["autoscaling"] is not None:
            kwargs["autoscaling_config"] = AutoscalingConfig(
                **o["autoscaling"])
        if "shard_spec" in o and o["shard_spec"] is not None:
            from ray_tpu_torch.shardgroup import ShardSpec

            kwargs["shard_spec"] = ShardSpec(**o["shard_spec"])
        return dep.options(**kwargs) if kwargs else dep

    def rebuild(node):
        if isinstance(node, Application):
            new_args = tuple(rebuild(a) for a in node.init_args)
            new_kwargs = {k: rebuild(v) for k, v in node.init_kwargs.items()}
            return Application(overridden(node.deployment), new_args,
                               new_kwargs)
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        return node

    rebuilt = rebuild(app)
    unmatched = set(by_name) - consumed
    if unmatched:
        # A typo'd name silently deploying defaults would be worse than an
        # error (the operator believes their scale-up applied).
        raise ValueError(
            f"deployment override(s) {sorted(unmatched)} match no "
            "deployment in the application graph")
    return rebuilt


def build(app) -> Dict[str, Any]:
    """Application graph -> config dict (reference `serve build`): every
    deployment's current config, ready to edit and `deploy_config`."""
    from ray_tpu_torch.serve import Deployment, _graph_order

    if isinstance(app, Deployment):
        app = app.bind()
    deployments = []
    for node in _graph_order(app):
        cfg = node.deployment.config
        entry: Dict[str, Any] = {
            "name": node.deployment.name,
            "num_replicas": cfg.num_replicas,
            "max_concurrent_queries": cfg.max_concurrent_queries,
        }
        if cfg.route_prefix:
            entry["route_prefix"] = cfg.route_prefix
        if cfg.ray_actor_options:
            entry["ray_actor_options"] = dict(cfg.ray_actor_options)
        if cfg.autoscaling is not None:
            entry["autoscaling"] = asdict(cfg.autoscaling)
        if cfg.shard_spec is not None:
            entry["shard_spec"] = asdict(cfg.shard_spec)
        deployments.append(entry)
    return {"applications": [{"name": "default",
                              "import_path": "<module>:<app>",
                              "deployments": deployments}]}


def deploy_config(config: Dict[str, Any], *, timeout_s: float = 60.0):
    """Deploy every application in a validated config dict; returns the
    handle of the last application's root deployment."""
    from ray_tpu_torch import serve

    validate_config(config)
    http = config.get("http") or {}
    handle = None
    for app_cfg in config["applications"]:
        target = import_attr(app_cfg["import_path"])
        if isinstance(target, serve.Deployment):
            target = target.bind()
        target = _apply_overrides(target,
                                  app_cfg.get("deployments") or [])
        handle = serve.run(target, timeout_s=timeout_s,
                           http=bool(http),
                           http_host=http.get("host", "127.0.0.1"),
                           http_port=int(http.get("port", 8000)))
    return handle


def deploy_config_file(path: str, *, timeout_s: float = 60.0):
    import yaml

    with open(path) as f:
        config = yaml.safe_load(f)
    return deploy_config(config, timeout_s=timeout_s)
