"""The port's cluster CLI (`python -m ray_tpu_torch start / stop / status
...`), `init(address="auto")` and the tracing CLI, from real OS processes.

Each test gives the port its own `RAY_TPU_TORCH_TMPDIR` (the daemons'
records and the cluster file) and stops what it started. The module starts
one head of the JAX package's CLI beside them (`RAY_TPU_TMPDIR` of its
own): the `status` JSON must have its keys, and the port's `stop` must
leave it alive even where a record names its pid.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import RaySystemError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    env.update(extra)
    return env


def _cli(args, env, package="ray_tpu_torch", timeout=90):
    return subprocess.run(
        [sys.executable, "-m", package, *args], env=env,
        cwd=env.get("RAY_TPU_TORCH_TMPDIR") or env.get("RAY_TPU_TMPDIR"),
        capture_output=True, text=True, timeout=timeout)


def _address(out):
    return out.stdout.split("started at ")[1].split()[0]


def _wait_gone(pid, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.05)
    return False


def _records(base):
    out = []
    for name in os.listdir(os.path.join(base, "daemons")):
        with open(os.path.join(base, "daemons", name)) as f:
            out.append(json.load(f))
    return out


@pytest.fixture
def port_env(tmp_path):
    env = _env(RAY_TPU_TORCH_TMPDIR=str(tmp_path))
    yield env
    _cli(["stop", "--force"], env, timeout=60)


@pytest.fixture(scope="module")
def ref_head(tmp_path_factory):
    """A head of the JAX package's CLI, for the whole module."""
    base = tmp_path_factory.mktemp("ref")
    env = _env(RAY_TPU_TMPDIR=str(base))
    out = _cli(["start", "--head", "--num-cpus", "1"], env, package="ray_tpu")
    assert out.returncode == 0, out.stderr
    (rec,) = _records(str(base))
    yield {"env": env, "address": _address(out), "pid": rec["pid"]}
    _cli(["stop", "--force"], env, package="ray_tpu", timeout=60)


def test_help_of_both_clis():
    for module in ("ray_tpu_torch", "ray_tpu_torch.observability"):
        out = _cli(["--help"], _env(), package=module)
        assert out.returncode == 0, out.stderr
        assert "usage:" in out.stdout
    out = _cli(["start", "--help"], _env())
    assert "--num-gpus" in out.stdout and "--num-tpus" not in out.stdout


def test_two_node_cluster_from_cli_processes(port_env):
    """Head + worker as separate daemonized OS processes; a driver
    connects with init(address="auto"), runs work on both (a GPU task on
    the worker's card), disconnects, reconnects; `stop` tears everything
    down."""
    env = port_env
    head = _cli(["start", "--head", "--num-cpus", "1", "--num-gpus", "0",
                 "--resources", '{"head_marker": 1}'], env)
    assert head.returncode == 0, head.stderr
    address = _address(head)
    worker = _cli(["start", "--address", address, "--num-cpus", "1",
                   "--num-gpus", "1", "--resources", '{"worker_marker": 1}',
                   "--labels", "kind=worker-vm"], env)
    assert worker.returncode == 0, worker.stderr

    base = env["RAY_TPU_TORCH_TMPDIR"]
    recs = _records(base)
    assert sorted(r["role"] for r in recs) == ["head", "worker"]
    for r in recs:
        os.kill(r["pid"], 0)  # alive
        assert r["session_dir"].startswith(base)
    with open(os.path.join(base, "ray_current_cluster.json")) as f:
        assert json.load(f) == {"address": address}

    driver = r"""
import os, time
import ray_tpu_torch as rt

rt.init(address="auto")
deadline = time.time() + 30
while time.time() < deadline:
    alive = [n for n in rt.nodes() if n["Alive"]]
    if len(alive) == 2:
        break
    time.sleep(0.05)
assert len(alive) == 2, alive
assert any(n.get("Labels", {}).get("kind") == "worker-vm" for n in alive)
assert rt.cluster_resources()["GPU"] == 1.0

@rt.remote(num_gpus=1, resources={"worker_marker": 0.1})
def on_worker():
    return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

@rt.remote(resources={"head_marker": 0.1})
def on_head():
    return os.getpid()

(wpid, cards), hpid = rt.get([on_worker.remote(), on_head.remote()],
                             timeout=60)
assert wpid != hpid and cards == "0", (wpid, hpid, cards)
print("DRIVER_OK", wpid, hpid)
"""
    for _ in range(2):  # twice: a driver's exit must not hurt the cluster
        out = subprocess.run([sys.executable, "-c", driver], env=env,
                             cwd=base, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, (out.stdout, out.stderr)
        assert "DRIVER_OK" in out.stdout

    stop = _cli(["stop"], env)
    assert stop.returncode == 0, stop.stderr
    assert "stopped 2" in stop.stdout
    for r in recs:
        assert _wait_gone(r["pid"]), f"daemon {r['pid']} alive after stop"
    assert not os.path.exists(os.path.join(base, "ray_current_cluster.json"))
    assert os.listdir(os.path.join(base, "daemons")) == []


def test_head_survives_driver_sigkill(port_env):
    """A driver's SIGKILL does not take the cluster down: the head is a
    process of its own, unlike an in-process `ray_tpu_torch.init()`."""
    env = port_env
    head = _cli(["start", "--head", "--num-cpus", "1", "--num-gpus", "0"],
                env)
    assert head.returncode == 0, head.stderr
    address = _address(head)
    crasher = (
        "import ray_tpu_torch as rt, time\n"
        f"rt.init(address={address!r})\n"
        "print('CONNECTED', flush=True)\n"
        "time.sleep(60)\n")
    proc = subprocess.Popen([sys.executable, "-c", crasher], env=env,
                            stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline().strip() == "CONNECTED"
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=10)
    check = (
        "import ray_tpu_torch as rt\n"
        f"rt.init(address={address!r})\n"
        "@rt.remote\n"
        "def f(): return 41 + 1\n"
        "assert rt.get(f.remote(), timeout=60) == 42\n"
        "print('STILL_UP')\n")
    out = subprocess.run([sys.executable, "-c", check], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "STILL_UP" in out.stdout


def test_init_auto_status_and_tracing_cli(port_env, ref_head, monkeypatch):
    """`init(address="auto")` reads the cluster file; a head started
    without `--num-gpus` counts its cards through `detect_gpus`; the
    `status` JSON has the JAX package's keys; the tracing CLI reads the
    GCS from --address or RAY_TPU_TORCH_GCS_ADDRESS."""
    env = dict(port_env, RAY_TPU_TORCH_NUM_GPUS="2")
    base = env["RAY_TPU_TORCH_TMPDIR"]
    monkeypatch.setenv("RAY_TPU_TORCH_TMPDIR", base)
    monkeypatch.delenv("RAY_TPU_TORCH_ADDRESS", raising=False)
    with pytest.raises(RaySystemError, match="no running cluster"):
        ray_tpu_torch.init(address="auto")
    head = _cli(["start", "--head", "--num-cpus", "1"], env)
    assert head.returncode == 0, head.stderr
    address = _address(head)
    again = _cli(["start", "--head"], env)
    assert again.returncode == 1 and address in again.stderr

    info = ray_tpu_torch.init(address="auto")
    try:
        assert info["gcs_address"] == address
        assert ray_tpu_torch.cluster_resources()["GPU"] == 2.0
    finally:
        ray_tpu_torch.shutdown()

    ours = _cli(["status"], dict(env, RAY_TPU_TORCH_ADDRESS=address))
    ref = _cli(["--address", ref_head["address"], "status"],
               ref_head["env"], package="ray_tpu")
    assert ours.returncode == 0 and ref.returncode == 0, (ours.stderr,
                                                          ref.stderr)
    ours, ref = json.loads(ours.stdout), json.loads(ref.stdout)
    assert sorted(ours) == sorted(ref) == [
        "actors", "nodes", "resources_available", "resources_total"]
    assert sorted(ours["actors"]) == sorted(ref["actors"])
    assert ours["nodes"] == 1 and ours["resources_total"]["GPU"] == 2.0

    out = _cli(["--address", address, "timeline", "--out", "-"], env,
               package="ray_tpu_torch.observability")
    assert out.returncode == 0, out.stderr
    assert "traceEvents" in json.loads(out.stdout.splitlines()[-1])
    out = _cli(["trace", "0" * 32],
               dict(env, RAY_TPU_TORCH_GCS_ADDRESS=address),
               package="ray_tpu_torch.observability")
    assert out.returncode == 0, out.stderr
    missing = _cli(["timeline"], env, package="ray_tpu_torch.observability")
    assert missing.returncode != 0
    assert "RAY_TPU_TORCH_GCS_ADDRESS" in missing.stderr


def test_stop_spares_a_reference_daemon(port_env, ref_head):
    """The port's `stop` signals only the port's daemons: a record that
    names the JAX package's head (a stale record, a recycled pid) is
    dropped, and that head lives on and still serves."""
    env = port_env
    head = _cli(["start", "--head", "--num-cpus", "1", "--num-gpus", "0"],
                env)
    assert head.returncode == 0, head.stderr
    base = env["RAY_TPU_TORCH_TMPDIR"]
    (ours,) = _records(base)
    planted = os.path.join(base, "daemons", f"{ref_head['pid']}.json")
    with open(planted, "w") as f:
        json.dump({"pid": ref_head["pid"], "role": "worker"}, f)

    stop = _cli(["stop", "--force"], env)
    assert stop.returncode == 0, stop.stderr
    assert "stopped 1" in stop.stdout
    assert _wait_gone(ours["pid"])
    os.kill(ref_head["pid"], 0)        # the reference head is alive
    assert not os.path.exists(planted)
    check = (
        "import ray_tpu\n"
        f"ray_tpu.init(address={ref_head['address']!r})\n"
        "print(len([n for n in ray_tpu.nodes() if n['Alive']]))\n")
    out = subprocess.run([sys.executable, "-c", check], env=ref_head["env"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.split()[-1] == "1", out.stderr
