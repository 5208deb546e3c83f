"""GCE GPU-VM node provider: scale the cluster with H100 VMs.

The port's counterpart of `ray_tpu/autoscaler/gcp.py` (the TPU-VM
provider), and like it the equivalent of the reference's GCP node
provider (`python/ray/autoscaler/_private/gcp/node_provider.py`, and the
`_private/fake_multi_node/node_provider.py` testing pattern). Nodes are
Compute Engine instances (`compute/v1` `instances`) of the A3 series:
`a3-highgpu-{1,2,4,8}g`, 1 to 8 H100 80GB cards each (GCE's "GPU machine
types"). The provider only speaks three verbs — `instances.insert` /
`delete` / `list` with a label filter — through a pluggable `transport`,
so tests verify the exact REST bodies without any cloud, and a fake
transport can back the "VMs" with in-process raylets (or with the daemons
their startup scripts start) for an end-to-end autoscaler loop.

Auth in real deployments comes from the VM's metadata server (the default
transport fetches an access token from `metadata.google.internal`);
nothing here imports a cloud SDK.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.parse
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.autoscaler import NodeProvider
from ray_tpu_torch.util.accelerators import GPU_GENERATIONS

logger = logging.getLogger(__name__)

COMPUTE_API = "https://compute.googleapis.com/compute/v1"
# GCE labels of the VMs this provider manages: the port's own keys, so a
# cluster of the JAX package in the same project never adopts them.
CLUSTER_LABEL = "ray-tpu-torch-cluster"
TYPE_LABEL = "ray-tpu-torch-node-type"
# The ray node label a VM's startup script registers (idle mapping).
VM_NAME_LABEL = "gpu-vm-name"

# GCE's A3 High series: `a3-highgpu-<n>g` carries n H100 80GB cards.
MACHINE_SERIES = "a3-highgpu"
GENERATION = "h100"
GCE_ACCELERATOR = "nvidia-h100-80gb"
VCPUS_PER_GPU = 26.0    # a3-highgpu-8g: 208 vCPUs for 8 cards
# Instance states that no longer hold a node (a deleted VM disappears).
_GONE = ("STOPPING", "SUSPENDING", "SUSPENDED", "TERMINATED")


def machine_gpus(machine_type: str) -> int:
    """Cards of an A3 machine type, from its name and the registry:
    'a3-highgpu-8g' -> 8. The count must divide the generation's
    `gpus_per_host` (GCE offers 1, 2, 4 and 8)."""
    prefix = MACHINE_SERIES + "-"
    count = machine_type[len(prefix):-1] \
        if machine_type.startswith(prefix) and machine_type.endswith("g") \
        else ""
    per_host = GPU_GENERATIONS[GENERATION].gpus_per_host
    if not count.isdigit() or not 1 <= int(count) <= per_host \
            or per_host % int(count):
        raise ValueError(
            f"{machine_type!r} is not an {MACHINE_SERIES}-<n>g machine type "
            f"with n dividing {per_host}")
    return int(count)


@dataclass
class GCEGPUConfig:
    project: str
    zone: str
    cluster_name: str
    head_address: str                      # GCS address workers join
    machine_type: str = "a3-highgpu-1g"
    # STANDARD or SPOT (GCE's scheduling.provisioningModel).
    provisioning_model: str = "STANDARD"
    source_image: str = ("projects/deeplearning-platform-release/global/"
                         "images/family/common-cu124-debian-11")
    boot_disk_size_gb: int = 200
    boot_disk_type: str = "pd-ssd"
    network: str = "default"
    # Bind host of the joining node: 'auto' is the VM's primary IP, which
    # the head can dial; a fake on one machine passes 127.0.0.1.
    host: str = "auto"
    # Shell run by the VM at boot; {head_address}, {node_name}, {host} and
    # {num_gpus} are substituted. The default boots a worker node against
    # the head's GCS, advertising the machine type's cards (`python3`: a
    # Debian image has no `python`).
    startup_script: str = (
        "#!/bin/bash\n"
        "python3 -m ray_tpu_torch start --address={head_address} "
        "--host {host} --num-gpus {num_gpus} "
        "--labels " + VM_NAME_LABEL + "={node_name}\n")
    extra_labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class GPUNodeHandle:
    """Provider-side view of one GPU VM."""

    name: str
    state: str = "PROVISIONING"  # PROVISIONING | STAGING | RUNNING | ...
    node_id: Any = None          # ray NodeID once resolved (fake providers
    #                              set it directly; real ones resolve via
    #                              the gpu-vm-name label)


class GCEGPUNodeProvider(NodeProvider):
    """Create/terminate/list GPU VMs through the Compute Engine REST API."""

    def __init__(self, config: GCEGPUConfig,
                 transport: Optional[Callable[[str, str, Optional[dict]],
                                              dict]] = None):
        self.config = config
        self.num_gpus = machine_gpus(config.machine_type)
        self.transport = transport or _MetadataAuthTransport()
        self._lock = threading.Lock()
        self._nodes: Dict[str, GPUNodeHandle] = {}

    # ----------------------------------------------------------------- urls

    def _instances(self) -> str:
        c = self.config
        return f"{COMPUTE_API}/projects/{c.project}/zones/{c.zone}/instances"

    # ---------------------------------------------------------- provider api

    def instance_body(self, name: str) -> dict:
        """The `instances.insert` body of one worker VM."""
        c = self.config
        zone = f"zones/{c.zone}"
        spot = c.provisioning_model == "SPOT"
        scheduling = {
            # A GPU VM cannot live-migrate: GCE requires TERMINATE.
            "onHostMaintenance": "TERMINATE",
            "automaticRestart": not spot,
            "provisioningModel": c.provisioning_model,
        }
        if spot:
            scheduling["instanceTerminationAction"] = "DELETE"
        script = c.startup_script.format(
            head_address=c.head_address, node_name=name, host=c.host,
            num_gpus=self.num_gpus)
        return {
            "name": name,
            "machineType": f"{zone}/machineTypes/{c.machine_type}",
            "guestAccelerators": [{
                "acceleratorType":
                    f"{zone}/acceleratorTypes/{GCE_ACCELERATOR}",
                "acceleratorCount": self.num_gpus}],
            "scheduling": scheduling,
            "disks": [{
                "boot": True, "autoDelete": True,
                "initializeParams": {
                    "sourceImage": c.source_image,
                    "diskSizeGb": str(c.boot_disk_size_gb),
                    "diskType": f"{zone}/diskTypes/{c.boot_disk_type}"}}],
            # No accessConfigs: no external IP (the TPU provider's
            # enableExternalIps False).
            "networkInterfaces": [
                {"network": f"global/networks/{c.network}"}],
            "labels": {CLUSTER_LABEL: c.cluster_name,
                       TYPE_LABEL: "worker", **c.extra_labels},
            "metadata": {"items": [
                {"key": "startup-script", "value": script}]},
        }

    def create_node(self, node_resources: Dict[str, float]) -> GPUNodeHandle:
        name = f"{self.config.cluster_name}-worker-{uuid.uuid4().hex[:8]}"
        self.transport("POST", self._instances(), self.instance_body(name))
        handle = GPUNodeHandle(name=name)
        with self._lock:
            self._nodes[name] = handle
        return handle

    def terminate_node(self, handle: GPUNodeHandle) -> None:
        self.transport("DELETE", f"{self._instances()}/{handle.name}", None)
        with self._lock:
            self._nodes.pop(handle.name, None)

    def non_terminated_nodes(self) -> List[GPUNodeHandle]:
        query = urllib.parse.urlencode(
            {"filter": f"labels.{CLUSTER_LABEL}={self.config.cluster_name}"})
        resp = self.transport("GET", f"{self._instances()}?{query}", None)
        out: List[GPUNodeHandle] = []
        with self._lock:
            for inst in resp.get("items", []):
                name = inst["name"]
                state = inst.get("status", "PROVISIONING")
                if state in _GONE:
                    self._nodes.pop(name, None)
                    continue
                handle = self._nodes.get(name)
                if handle is None:
                    handle = GPUNodeHandle(name=name)   # adopted (restart)
                    self._nodes[name] = handle
                handle.state = state
                if inst.get("ray_node_id") is not None:
                    handle.node_id = inst["ray_node_id"]
                out.append(handle)
        return out

    def resolve_node_id(self, handle: GPUNodeHandle,
                        view: Dict[str, Any]) -> Optional[str]:
        """Map a GPU VM to its ray node via the `gpu-vm-name` label the
        startup script registers (autoscaler idle scoring)."""
        if handle.node_id is not None:
            return handle.node_id.hex() if hasattr(handle.node_id, "hex") \
                else str(handle.node_id)
        for node_hex, entry in view.items():
            if entry.get("labels", {}).get(VM_NAME_LABEL) == handle.name:
                return node_hex
        return None

    def node_resources_for(self) -> Dict[str, float]:
        return {"CPU": VCPUS_PER_GPU * self.num_gpus,
                "GPU": float(self.num_gpus)}


class _MetadataAuthTransport:
    """Real transport: REST via urllib with a metadata-server token.

    Only constructed on an actual GCP VM; import-time side-effect free so
    the module loads anywhere.
    """

    TOKEN_URL = ("http://metadata.google.internal/computeMetadata/v1/"
                 "instance/service-accounts/default/token")

    def __init__(self):
        self._token: Optional[str] = None
        self._token_expiry = 0.0

    def _get_token(self) -> str:
        import urllib.request

        if self._token and time.time() < self._token_expiry - 60:
            return self._token
        req = urllib.request.Request(self.TOKEN_URL,
                                     headers={"Metadata-Flavor": "Google"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            payload = json.loads(resp.read())
        self._token = payload["access_token"]
        self._token_expiry = time.time() + payload.get("expires_in", 3600)
        return self._token

    def __call__(self, method: str, url: str, body: Optional[dict]) -> dict:
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Authorization": f"Bearer {self._get_token()}",
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            raw = resp.read()
        return json.loads(raw) if raw else {}


def _startup_script(body: dict) -> str:
    return next(item["value"] for item in body["metadata"]["items"]
                if item["key"] == "startup-script")


class SubprocessFakeGPUTransport:
    """Fake Compute API that EXECUTES each VM's startup script verbatim in
    a subprocess (bash), so the join path a real GPU VM would take —
    `python -m ray_tpu_torch start --address=...` daemonizing a worker
    node — is exercised end-to-end, not just recorded. DELETE terminates
    the daemon the script started (a real API call deletes the VM).

    Requires RAY_TPU_TORCH_TMPDIR to point at this fake cluster's
    directory so daemon records are discoverable and isolated per test.
    The script's `python3` is this interpreter (its directory leads PATH).
    """

    def __init__(self, env: Optional[Dict[str, str]] = None,
                 startup_timeout_s: float = 60.0):
        import os as _os
        import sys as _sys

        self.env = dict(_os.environ)
        self.env.update(env or {})
        self.env["PATH"] = _os.pathsep.join(
            p for p in (_os.path.dirname(_sys.executable),
                        self.env.get("PATH")) if p)
        self.startup_timeout_s = startup_timeout_s
        self.calls: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        # name -> {"body", "created", "pid", "node_id"}
        self.nodes: Dict[str, Dict[str, Any]] = {}

    def _daemon_records(self) -> Dict[int, Dict[str, Any]]:
        from ray_tpu_torch.scripts.cluster_cli import read_daemon_records

        return read_daemon_records(self.env.get("RAY_TPU_TORCH_TMPDIR"))

    def __call__(self, method: str, url: str, body: Optional[dict]) -> dict:
        import os as _os
        import subprocess
        import tempfile

        with self._lock:
            self.calls.append({"method": method, "url": url, "body": body})
        if method == "POST":
            name = body["name"]
            before = set(self._daemon_records())
            with tempfile.NamedTemporaryFile(
                    "w", suffix=".sh", delete=False) as f:
                f.write(_startup_script(body))
                path = f.name
            try:
                proc = subprocess.run(
                    ["bash", path], env=self.env, capture_output=True,
                    text=True, timeout=self.startup_timeout_s)
            finally:
                _os.unlink(path)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"startup script failed (rc={proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            new = {pid: rec for pid, rec in self._daemon_records().items()
                   if pid not in before and rec.get("role") == "worker"}
            if len(new) != 1:
                raise RuntimeError(
                    f"startup script left {len(new)} new worker daemons "
                    f"(expected 1): {new}")
            pid, rec = next(iter(new.items()))
            with self._lock:
                self.nodes[name] = {"body": body, "created": time.time(),
                                    "pid": pid, "node_id": rec["node_id"]}
            return {"name": name}
        if method == "DELETE":
            import signal as _signal

            name = url.rsplit("/", 1)[-1]
            with self._lock:
                rec = self.nodes.pop(name, None)
            if rec is not None:
                try:
                    _os.kill(rec["pid"], _signal.SIGTERM)
                except ProcessLookupError:
                    pass
            return {}
        if method == "GET":
            with self._lock:
                items = [{"name": name, "status": "RUNNING",
                          "ray_node_id": rec["node_id"]}
                         for name, rec in self.nodes.items()]
            return {"items": items}
        raise ValueError(f"unexpected method {method}")


class FakeGPUTransport:
    """Records every REST call and simulates the Compute API's instance
    table — optionally backing each "VM" with an in-process raylet on a
    `Cluster` (the reference's fake_multi_node testing pattern), so the
    autoscaler loop runs end-to-end with zero cloud. Its raylets advertise
    `gpus_per_vm` GPUs (0 by default: virtual CPU raylets; on the CPU a
    GPU grant only sets the worker's env)."""

    def __init__(self, cluster=None, gpus_per_vm: float = 0,
                 cpus_per_vm: float = 2.0, ready_delay_s: float = 0.0):
        self.calls: List[Dict[str, Any]] = []
        self.cluster = cluster
        self.gpus_per_vm = gpus_per_vm
        self.cpus_per_vm = cpus_per_vm
        self.ready_delay_s = ready_delay_s
        self._lock = threading.Lock()
        # name -> {"body", "created", "raylet"}
        self.nodes: Dict[str, Dict[str, Any]] = {}

    def __call__(self, method: str, url: str, body: Optional[dict]) -> dict:
        with self._lock:
            self.calls.append({"method": method, "url": url, "body": body})
        if method == "POST":
            name = body["name"]
            raylet = None
            if self.cluster is not None:
                raylet = self.cluster.add_node(
                    num_cpus=self.cpus_per_vm, num_gpus=self.gpus_per_vm,
                    labels={VM_NAME_LABEL: name})
            with self._lock:
                self.nodes[name] = {"body": body, "created": time.time(),
                                    "raylet": raylet}
            return {"name": name}
        if method == "DELETE":
            name = url.rsplit("/", 1)[-1]
            with self._lock:
                rec = self.nodes.pop(name, None)
            if rec and rec.get("raylet") is not None \
                    and self.cluster is not None:
                self.cluster.remove_node(rec["raylet"])
            return {}
        if method == "GET":
            items = []
            with self._lock:
                for name, rec in self.nodes.items():
                    ready = time.time() - rec["created"] >= self.ready_delay_s
                    inst = {"name": name,
                            "status": "RUNNING" if ready else "STAGING"}
                    if rec.get("raylet") is not None:
                        inst["ray_node_id"] = rec["raylet"].node_id
                    items.append(inst)
            return {"items": items}
        raise ValueError(f"unexpected method {method}")
