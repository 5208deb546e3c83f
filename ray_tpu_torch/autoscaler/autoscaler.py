"""StandardAutoscaler + NodeProvider abstraction.

The port's counterpart of `ray_tpu/autoscaler/autoscaler.py`, with `GPU`
as the accelerator resource of a node shape (`{"CPU": c, "GPU": n}`).
Reference: `autoscaler/_private/autoscaler.py:172` (reconcile loop),
`resource_demand_scheduler.py` (bin-packing), `node_provider.py` (cloud
abstraction). One worker node type; multi-type scheduling is a config list
away but the reference's own benchmarks run homogeneous worker groups.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.rpc import RpcClient

logger = logging.getLogger(__name__)


@dataclass
class AutoscalerConfig:
    min_workers: int = 0
    max_workers: int = 4
    # Worker node shape (the provider's node_config).
    node_resources: Dict[str, float] = field(default_factory=lambda: {"CPU": 2})
    idle_timeout_s: float = 30.0
    # A just-launched node counts as busy for this long: boot + join +
    # first dispatch take time (minutes for a real GPU VM), and judging
    # it idle meanwhile livelocks launch->terminate->relaunch.
    launch_grace_s: float = 60.0
    update_period_s: float = 1.0
    # Fraction of outstanding demand to satisfy per tick (1.0 = all at
    # once; reference upscaling_speed semantics).
    upscaling_speed: float = 1.0


class NodeProvider:
    """Cloud abstraction (reference node_provider.py): the autoscaler only
    creates/terminates/lists — everything else is the cluster's problem."""

    def create_node(self, node_resources: Dict[str, float]) -> Any:
        raise NotImplementedError

    def terminate_node(self, handle: Any) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[Any]:
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Launch worker nodes as in-process raylets on a `Cluster` sim — the
    test/laptop provider (reference local/node_provider.py)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self._managed: List[Any] = []

    def create_node(self, node_resources: Dict[str, float]) -> Any:
        kw = dict(node_resources)
        num_cpus = kw.pop("CPU", 1)
        num_gpus = kw.pop("GPU", 0)
        raylet = self.cluster.add_node(num_cpus=num_cpus, num_gpus=num_gpus,
                                       resources=kw or None)
        self._managed.append(raylet)
        return raylet

    def terminate_node(self, handle: Any) -> None:
        if handle in self._managed:
            self._managed.remove(handle)
        self.cluster.remove_node(handle)

    def non_terminated_nodes(self) -> List[Any]:
        return list(self._managed)


def _fits(capacity: Dict[str, float], shape: Dict[str, float]) -> bool:
    return all(capacity.get(r, 0.0) + 1e-9 >= a for r, a in shape.items())


def _take(capacity: Dict[str, float], shape: Dict[str, float]):
    for r, a in shape.items():
        capacity[r] = capacity.get(r, 0.0) - a


class StandardAutoscaler:
    """The reconcile loop: demand -> target node count -> provider calls."""

    def __init__(self, gcs_address: str, provider: NodeProvider,
                 config: Optional[AutoscalerConfig] = None):
        self.config = config or AutoscalerConfig()
        self.provider = provider
        self._gcs = RpcClient(gcs_address, name="autoscaler->gcs")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # node key -> monotonic time it was last seen busy. Keyed by the
        # provider's stable handle.name when present — id() could be
        # reused by a later handle and hand a fresh node a stale idle
        # clock — and pruned against the live node set each update.
        self._last_busy: Dict[Any, float] = {}
        self.num_launches = 0
        self.num_terminations = 0

    # ------------------------------------------------------------ lifecycle

    def start(self):
        self._thread = threading.Thread(target=self._loop,
                                        name="autoscaler", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self):
        # Honor min_workers immediately, then reconcile periodically.
        while not self._stop.wait(self.config.update_period_s):
            try:
                self.update()
            except Exception:
                logger.exception("autoscaler update failed")

    # -------------------------------------------------------------- update

    def update(self):
        cfg = self.config
        managed = self.provider.non_terminated_nodes()

        # 1. Floor: min_workers.
        while len(managed) < cfg.min_workers:
            self._launch()
            managed = self.provider.non_terminated_nodes()

        # 2. Demand: queued shapes + explicit requests, minus what current
        # capacity could eventually absorb (bin-pack against TOTALs — a
        # busy-but-sufficient cluster must not trigger scale-up).
        resp = self._gcs.call("resource_demand", timeout=5)
        view = self._gcs.call("get_resource_view", timeout=5)

        # 2a. Dead-node replacement: a managed node the cluster has marked
        # DEAD (crashed, not drained by us) is reaped NOW and relaunched
        # one-for-one in the same tick — waiting out the idle timeout
        # would leave capacity down for the whole window (the 100-node
        # chaos envelope kills nodes continuously and measures exactly
        # this replacement latency). One-for-one, not refill-to-min:
        # when demand has already scaled the fleet past min_workers, a
        # crash must restore the PRE-DEATH size, or recovery would wait
        # on demand re-materializing (idle scale-down reclaims any
        # overshoot later).
        replaced = 0
        pre_death = len(managed)
        for handle in list(managed):
            node_hex = self._node_hex(handle, view)
            if node_hex is None:
                continue  # still booting: not yet judgeable
            entry = view.get(node_hex)
            if entry is not None and not entry.get("alive"):
                logger.warning("autoscaler: managed node %s is DEAD — "
                               "replacing", node_hex[:12])
                self.provider.terminate_node(handle)
                self._last_busy.pop(self._node_key(handle), None)
                self.num_terminations += 1
                replaced += 1
        if replaced:
            managed = self.provider.non_terminated_nodes()
            want = max(cfg.min_workers, min(cfg.max_workers, pre_death))
            while len(managed) < want:
                self._launch()
                managed = self.provider.non_terminated_nodes()
        totals = [dict(e["total"]) for e in view.values() if e.get("alive")]
        unmet: List[Dict[str, float]] = []
        for shape in list(resp.get("demand", [])) + list(
                resp.get("requests", [])):
            for cap in totals:
                if _fits(cap, shape):
                    _take(cap, shape)
                    break
            else:
                if _fits(dict(cfg.node_resources), shape):
                    unmet.append(shape)
                # else: no node type can ever run it — not our problem
        if unmet:
            # Pack unmet shapes into virtual nodes of the configured type
            # to size the launch.
            virtual: List[Dict[str, float]] = []
            for shape in unmet:
                for cap in virtual:
                    if _fits(cap, shape):
                        _take(cap, shape)
                        break
                else:
                    if len(managed) + len(virtual) < cfg.max_workers:
                        virtual.append(dict(cfg.node_resources))
                        _take(virtual[-1], shape)
            to_launch = max(1, int(len(virtual) * cfg.upscaling_speed)) \
                if virtual else 0
            to_launch = min(to_launch, cfg.max_workers - len(managed))
            for _ in range(to_launch):
                self._launch()
            if to_launch:
                return  # let new capacity land before judging idleness

        # 3. Scale-down: terminate managed nodes idle past the timeout.
        now = time.monotonic()
        live = list(self.provider.non_terminated_nodes())
        live_keys = {self._node_key(h) for h in live}
        for stale in [k for k in self._last_busy if k not in live_keys]:
            self._last_busy.pop(stale, None)  # provider dropped the node
        demand = resp.get("demand", [])
        for handle in live:
            hid = self._node_key(handle)
            idle = self._node_is_idle(handle, view, demand)
            if not idle:
                self._last_busy[hid] = now
                continue
            last = self._last_busy.setdefault(hid, now)
            if last > now:
                # Launch grace still pending, but the node has already
                # joined the view and reports idle — boot is over, so the
                # normal idle clock applies from here. (The grace's job is
                # only to protect the create->join window, during which
                # _node_is_idle returns False anyway; keeping the full
                # grace would let an over-launched never-used node linger
                # grace+idle_timeout after the burst that spawned it.)
                self._last_busy[hid] = last = now
            if now - last > cfg.idle_timeout_s and \
                    len(self.provider.non_terminated_nodes()) > cfg.min_workers:
                logger.info("autoscaler: terminating idle node")
                self.provider.terminate_node(handle)
                self._last_busy.pop(hid, None)
                self.num_terminations += 1

    @staticmethod
    def _node_key(handle) -> Any:
        return getattr(handle, "name", None) or id(handle)

    def _node_hex(self, handle, view) -> Optional[str]:
        """Resolve a provider handle to its ray node id hex (None while
        the node hasn't joined the view yet)."""
        node_hex = getattr(handle, "node_id", None)
        if node_hex is not None and hasattr(node_hex, "hex"):
            node_hex = node_hex.hex()
        if node_hex is None and hasattr(self.provider, "resolve_node_id"):
            node_hex = self.provider.resolve_node_id(handle, view)
        return node_hex

    def _node_is_idle(self, handle, view, demand) -> bool:
        # Cloud providers map VM -> ray node lazily (label lookup).
        node_hex = self._node_hex(handle, view)
        if node_hex is None:
            return False  # not yet joined: never "idle" (still booting)
        entry = view.get(node_hex)
        if entry is None or not entry.get("alive"):
            return True  # dead managed node: reap it
        if any(_fits(entry["total"], shape) for shape in demand):
            # Queued work that this node could run keeps it: a lease
            # waiting for its worker to start holds no resources, so the
            # node only looks idle (a GPU worker is a cold start of
            # seconds, and reaping the node kills the task it was about to
            # run), and a node passed over by tasks queued elsewhere would
            # be launched again for them at once.
            return False
        return entry["available"] == entry["total"]

    def _launch(self):
        logger.info("autoscaler: launching worker node %s",
                    self.config.node_resources)
        handle = self.provider.create_node(dict(self.config.node_resources))
        # Launch grace: the idle clock starts after boot allowance.
        self._last_busy[self._node_key(handle)] = (
            time.monotonic() + self.config.launch_grace_s)
        self.num_launches += 1


def request_resources(bundles: Optional[List[Dict[str, float]]] = None,
                      num_cpus: Optional[int] = None):
    """reference `ray.autoscaler.sdk.request_resources`: pin a capacity
    floor with the connected cluster's autoscaler."""
    import ray_tpu_torch

    runtime = ray_tpu_torch._global_runtime
    if runtime is None:
        raise RuntimeError("ray_tpu_torch.init() first")
    if num_cpus is not None:
        bundles = (bundles or []) + [{"CPU": 1.0}] * int(num_cpus)
    runtime.gcs.call("request_resources", {"bundles": bundles or []},
                     timeout=5)
