"""`ray_tpu_torch start` / `ray_tpu_torch stop`: a cluster of OS processes.

The port's counterpart of `ray_tpu/scripts/cluster_cli.py`, the equivalent
of `ray start` / `ray stop` (`python/ray/scripts/scripts.py:535,1231`).
`start --head` daemonizes a head node (GCS + raylet + dashboard) detached
from any driver; `start --address=HOST:PORT` daemonizes a worker node that
joins an existing head — this is the command GPU-VM startup scripts run
(`ray_tpu_torch/autoscaler/gcp.py` GCEGPUConfig.startup_script). A node
advertises `--num-gpus` cards, else the ones `core/node.py detect_gpus`
counts. `stop` terminates every daemon of the port started on this
machine, and never a daemon of the JAX package (`_pid_is_ray_daemon`).

Drivers connect with `ray_tpu_torch.init(address="host:port")` (or "auto",
which reads the cluster file written by `start --head`) and can connect,
disconnect, and reconnect without affecting the cluster — the reference
runs `gcs_server`/`raylet` as processes separate from any driver for the
same reason (`python/ray/_private/services.py:1280,1353`). The daemons are
fresh execs of this interpreter, never forks of the caller, so a caller
that has initialised CUDA passes none of it on.

Daemon bookkeeping lives under `$RAY_TPU_TORCH_TMPDIR` (default
`$TMPDIR/ray_tpu_torch`, where the port's session dirs are too):
- `ray_current_cluster.json` — head address, read by init("auto")
- `daemons/<pid>.json` — one record per node daemon on this machine
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

_READY_TIMEOUT_S = 40.0


def tmp_base(base: Optional[str] = None) -> str:
    return base or os.environ.get("RAY_TPU_TORCH_TMPDIR") or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch")


def cluster_file(base: Optional[str] = None) -> str:
    return os.path.join(tmp_base(base), "ray_current_cluster.json")


def daemon_dir(base: Optional[str] = None) -> str:
    return os.path.join(tmp_base(base), "daemons")


def read_cluster_address(base: Optional[str] = None) -> Optional[str]:
    try:
        with open(cluster_file(base)) as f:
            return json.load(f)["address"]
    except Exception:  # noqa: BLE001 — missing/corrupt: no cluster
        return None


def read_daemon_records(base: Optional[str] = None) -> Dict[int, Dict[str, Any]]:
    """pid -> record for every daemon bookkeeping file on this machine
    (stale records for dead pids included — callers check liveness)."""
    out: Dict[int, Dict[str, Any]] = {}
    d = daemon_dir(base)
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in names:
        path = os.path.join(d, name)
        try:
            with open(path) as f:
                rec = json.load(f)
            rec["_path"] = path
            out[rec["pid"]] = rec
        except Exception:  # noqa: BLE001 — partial write; skip
            pass
    return out


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def _pid_is_ray_daemon(pid: int) -> bool:
    """True only when `pid` is alive AND still one of the port's node
    daemons — a stale record surviving a SIGKILLed daemon must never get
    a recycled PID (some unrelated process) signalled, nor a daemon of
    the JAX package (`-m ray_tpu start`), whose cmdline holds `ray_tpu`
    but not `ray_tpu_torch`."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmdline = f.read()
    except OSError:
        return _pid_alive(pid)  # no /proc (non-Linux): fall back to liveness
    return b"ray_tpu_torch" in cmdline.split(b"\0")


def resolve_bind_host(host: str) -> str:
    """`auto` (and the unroutable-as-advertised 0.0.0.0) resolve to this
    machine's primary interface IP, so the bound address is the same one
    peers can dial — bind host doubles as the advertised address
    throughout (NodeInfo.address, the cluster file, lease replies)."""
    if host not in ("auto", "0.0.0.0"):
        return host
    from ray_tpu_torch.util.net import primary_ip

    return primary_ip()


def _daemon_record_path(pid: int) -> str:
    return os.path.join(daemon_dir(), f"{pid}.json")


def _parse_labels(text: Optional[str]) -> Optional[Dict[str, str]]:
    if not text:
        return None
    out = {}
    for pair in text.split(","):
        if not pair:
            continue
        k, _, v = pair.partition("=")
        out[k.strip()] = v.strip()
    return out


def add_start_parser(sub) -> None:
    p = sub.add_parser("start", help="start a head or worker node daemon")
    p.add_argument("--head", action="store_true",
                   help="start a new cluster head (GCS + raylet)")
    p.add_argument("--address", dest="join_address", default=None,
                   help="GCS address of an existing head to join "
                        "(this is what GPU-VM startup scripts pass)")
    p.add_argument("--port", type=int, default=0,
                   help="fixed GCS port for --head (default: ephemeral)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind+advertise host for GCS/raylet; 'auto' picks "
                        "this machine's primary IP (use for multi-machine)")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None,
                   help="GPUs this node advertises (default: the cards "
                        "core/node.py detect_gpus counts)")
    p.add_argument("--resources", default=None,
                   help='extra resources as JSON, e.g. \'{"worker": 1}\'')
    p.add_argument("--object-store-memory", type=int, default=0)
    p.add_argument("--labels", default=None, help="k=v[,k=v...] node labels")
    p.add_argument("--block", action="store_true",
                   help="run in the foreground instead of daemonizing")


def add_stop_parser(sub) -> None:
    p = sub.add_parser("stop", help="stop all node daemons on this machine")
    p.add_argument("--force", action="store_true",
                   help="SIGKILL immediately instead of graceful SIGTERM")
    p.add_argument("--grace-period", type=float, default=10.0)


def cmd_start(args, global_address: Optional[str]) -> int:
    join = args.join_address or (None if args.head else global_address)
    if args.head == bool(join):
        print("error: pass exactly one of --head or --address=HOST:PORT",
              file=sys.stderr)
        return 2
    if args.head:
        # Refuse to hijack a live cluster: a second head would silently
        # redirect every init(address="auto") driver. The live head daemon
        # RECORD is the signal — the cluster file alone can be pruned or
        # corrupt while the head still runs.
        live = [rec for pid, rec in read_daemon_records().items()
                if rec.get("role") == "head" and _pid_is_ray_daemon(pid)]
        if live:
            addr = read_cluster_address() or live[0].get("gcs_address")
            print(f"error: a cluster is already running at {addr} "
                  "(run `python -m ray_tpu_torch stop` first)", file=sys.stderr)
            return 1
    if args.block:
        return _run_blocking(args, join)
    # Daemonize: re-exec this command with --block in a new session so the
    # node survives this CLI (and any future driver) exiting.
    os.makedirs(os.path.join(tmp_base(), "logs"), exist_ok=True)
    os.makedirs(daemon_dir(), exist_ok=True)
    argv = [sys.executable, "-m", "ray_tpu_torch", "start", "--block"]
    if args.head:
        argv += ["--head", "--port", str(args.port)]
    else:
        argv += ["--address", join]
    argv += ["--host", args.host]
    if args.num_cpus is not None:
        argv += ["--num-cpus", str(args.num_cpus)]
    if args.num_gpus is not None:
        argv += ["--num-gpus", str(args.num_gpus)]
    if args.resources:
        argv += ["--resources", args.resources]
    if args.object_store_memory:
        argv += ["--object-store-memory", str(args.object_store_memory)]
    if args.labels:
        argv += ["--labels", args.labels]
    log_path = os.path.join(
        tmp_base(), "logs",
        f"node-{'head' if args.head else 'worker'}-{int(time.time())}.log")
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(
            argv, stdout=log, stderr=log, stdin=subprocess.DEVNULL,
            start_new_session=True)
    record_path = _daemon_record_path(proc.pid)
    deadline = time.time() + _READY_TIMEOUT_S
    while time.time() < deadline:
        if proc.poll() is not None:
            print(f"error: node daemon exited with rc={proc.returncode}; "
                  f"log: {log_path}", file=sys.stderr)
            return 1
        try:
            with open(record_path) as f:
                rec = json.load(f)
            break
        except Exception:  # noqa: BLE001 — not written yet
            time.sleep(0.1)
    else:
        print(f"error: node daemon not ready after {_READY_TIMEOUT_S:.0f}s; "
              f"log: {log_path}", file=sys.stderr)
        return 1
    if args.head:
        print(f"ray_tpu_torch head started at {rec['gcs_address']} (pid {proc.pid})")
        print(f"  connect drivers with: ray_tpu_torch.init(address="
              f"\"{rec['gcs_address']}\")")
        print(f"  add nodes with:       python -m ray_tpu_torch start "
              f"--address={rec['gcs_address']}")
    else:
        print(f"ray_tpu_torch node joined {join} "
              f"(node {rec['node_id'][:12]}, pid {proc.pid})")
    return 0


def _run_blocking(args, join: Optional[str]) -> int:
    from ray_tpu_torch.core.node import Node

    os.makedirs(daemon_dir(), exist_ok=True)
    resources = json.loads(args.resources) if args.resources else None
    host = resolve_bind_host(args.host)
    node = Node(
        head=args.head,
        gcs_address=join,
        gcs_host=host,
        gcs_port=args.port,
        host=host,
        num_cpus=args.num_cpus,
        num_gpus=args.num_gpus,
        resources=resources,
        object_store_memory=args.object_store_memory,
        labels=_parse_labels(args.labels),
    )
    record = {
        "pid": os.getpid(),
        "role": "head" if args.head else "worker",
        "gcs_address": node.gcs_address,
        "raylet_address": node.raylet_address,
        "node_id": node.node_id.hex(),
        "session_dir": node.session_dir,
        "started_at": time.time(),
    }
    record_path = _daemon_record_path(os.getpid())
    with open(record_path, "w") as f:
        json.dump(record, f)
    wrote_cluster_file = False
    if args.head:
        with open(cluster_file(), "w") as f:
            json.dump({"address": node.gcs_address}, f)
        wrote_cluster_file = True

    stopping = {"flag": False}

    def _term(signum, frame):
        if stopping["flag"]:
            return
        stopping["flag"] = True
        try:
            node.shutdown()
        finally:
            doomed = [record_path]
            # Only remove the cluster file if it still points at THIS head —
            # a newer cluster may have claimed it since.
            if wrote_cluster_file and \
                    read_cluster_address() == node.gcs_address:
                doomed.append(cluster_file())
            for path in doomed:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            os._exit(0)

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    print(f"node up: gcs={node.gcs_address} raylet={node.raylet_address} "
          f"(pid {os.getpid()})", flush=True)
    while True:  # woken only by signals
        time.sleep(3600)


def _stop_group(records: List[Dict[str, Any]], force: bool,
                grace_period: float) -> int:
    """Signal every daemon in the group first, then run ONE shared grace
    wait, then SIGKILL stragglers — N slow workers cost one grace period,
    not N."""
    sig = signal.SIGKILL if force else signal.SIGTERM
    waiting: List[int] = []
    stopped = 0
    for rec in records:
        if not _pid_is_ray_daemon(rec["pid"]):
            continue  # stale record: dead daemon or recycled PID
        try:
            os.kill(rec["pid"], sig)
            stopped += 1
            waiting.append(rec["pid"])
        except ProcessLookupError:
            pass
    if not force:
        deadline = time.time() + grace_period
        while waiting and time.time() < deadline:
            waiting = [pid for pid in waiting if _pid_alive(pid)]
            if waiting:
                time.sleep(0.1)
        for pid in waiting:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for rec in records:
        try:
            os.unlink(rec["_path"])
        except OSError:
            pass
    return stopped


def cmd_stop(args) -> int:
    records = list(read_daemon_records().values())
    # Workers first, head last, so departing nodes can still report to GCS.
    workers = [r for r in records if r.get("role") != "head"]
    heads = [r for r in records if r.get("role") == "head"]
    stopped = _stop_group(workers, args.force, args.grace_period)
    stopped += _stop_group(heads, args.force, args.grace_period)
    try:
        os.unlink(cluster_file())
    except OSError:
        pass
    print(f"stopped {stopped} node daemon(s)")
    return 0
