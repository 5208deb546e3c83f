"""The port's cross-language gateway (`ray_tpu_torch.xlang`) against the
unchanged C++ client of `cpp/`.

`cpp/examples/smoke.cc` is compiled with g++ as it is and run against the
port's gateway, as tests/test_cpp_client.py runs it against the JAX
package's: KV, objects both ways, tasks by `module:name` (sync and
submitted), a named actor and a remote error. The wire format is the JAX
package's (the same frame header, raw msgpack payloads), so the same binary
speaks to both: the last test drives each package's gateway in turn. Skips
where g++ is absent.
"""

import os
import shutil
import socket
import struct
import subprocess

import msgpack
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch import xlang

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke_binary(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    out = tmp_path_factory.mktemp("cppbin") / "smoke"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-I", os.path.join(REPO, "cpp", "include"),
         os.path.join(REPO, "cpp", "examples", "smoke.cc"), "-o", str(out)],
        check=True, capture_output=True, text=True, timeout=120)
    return str(out)


class Counter:
    def __init__(self):
        self.x = 0

    def inc(self, n):
        self.x += n
        return self.x


def fresh_counter(mod):
    """The named actor smoke.cc drives, at 0 (one left by an earlier run
    is killed first)."""
    try:
        old = mod.get_actor("xlang-counter")
    except Exception:  # noqa: BLE001 — no such actor yet
        old = None
    if old is not None:
        mod.kill(old)
    counter = mod.remote(Counter).options(name="xlang-counter").remote()
    assert mod.get(counter.inc.remote(0), timeout=60) == 0


@pytest.fixture(scope="module")
def gateway():
    """The port's runtime and its gateway. Workers import
    tests/xlang_mod.py (tests/ is on PYTHONPATH)."""
    ray_tpu_torch.init(num_cpus=2)
    try:
        yield xlang.start_gateway()
    finally:
        xlang.stop_gateway()
        ray_tpu_torch.shutdown()


def _raw_call(address, method, payload, req_id=1):
    """One raw-msgpack request, framed as the C++ client frames it:
    [4B LE total][4B LE envlen][msgpack {i, k, m}][msgpack payload]."""
    host, port = address.rsplit(":", 1)
    env = msgpack.packb({"i": req_id, "k": "req", "m": method})
    body = msgpack.packb(payload, use_bin_type=True)
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(struct.pack("<II", 4 + len(env) + len(body), len(env))
                  + env + body)
        head = b""
        while len(head) < 8:
            head += s.recv(8 - len(head))
        total, envlen = struct.unpack("<II", head)
        rest = b""
        while len(rest) < total - 4:
            rest += s.recv(total - 4 - len(rest))
    reply_env = msgpack.unpackb(rest[:envlen], raw=False)
    body = rest[envlen:]
    return reply_env, (msgpack.unpackb(body, raw=False, strict_map_key=False)
                       if body else None)


def test_cpp_client_end_to_end(smoke_binary, gateway):
    runtime = ray_tpu_torch._require_runtime()
    # Discovery: the gateway's address is published in the GCS KV.
    resp = runtime.gcs.call("kv_get", {"namespace": xlang.GATEWAY_KV_NS,
                                       "key": xlang.GATEWAY_KV_KEY})
    assert resp["value"].decode() == gateway
    assert xlang.start_gateway() == gateway        # idempotent

    fresh_counter(ray_tpu_torch)
    py_ref = ray_tpu_torch.put({"greeting": "from-python"})
    proc = subprocess.run([smoke_binary, gateway, py_ref.hex()],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "SMOKE OK" in proc.stdout

    # The C++ put, read back in Python.
    put_id = next(line.split()[1] for line in proc.stdout.splitlines()
                  if line.startswith("PUT_ID "))
    from ray_tpu_torch.core.ids import ObjectID

    value = runtime.get([ObjectID.from_hex(put_id)], timeout=30)[0]
    assert value == {"kind": "from-cpp", "nums": [1, 2, 3], "pi": 3.5}
    # The KV the C++ side wrote.
    resp = runtime.gcs.call("kv_get", {"namespace": "xlang-user",
                                       "key": b"cpp-key"})
    assert resp["value"] == b"cpp-value"


def test_raw_methods_and_errors(gateway):
    env, out = _raw_call(gateway, "xlang_ping", {})
    assert out == {"ok": True} and not env.get("e")
    _, out = _raw_call(gateway, "xlang_put", {"value": [1, "two", b"3"]})
    oid = out["id"]
    _, out = _raw_call(gateway, "xlang_get", {"id": oid, "timeout": 30})
    assert out == {"value": [1, "two", b"3"]}
    assert _raw_call(gateway, "xlang_free", {"id": oid})[1] == {"freed": True}
    _, out = _raw_call(gateway, "xlang_call", {
        "fn": "xlang_mod:add", "args": [2, 3], "mode": "submit"})
    _, got = _raw_call(gateway, "xlang_get", {"id": out["id"]})
    assert got == {"value": 5}
    # Not cross-language data: a UUID has no msgpack form.
    env, _ = _raw_call(gateway, "xlang_call", {"fn": "uuid:uuid4"})
    assert "not cross-language serializable" in env["e"]
    env, _ = _raw_call(gateway, "xlang_call", {"fn": "no_colon_or_dot"})
    assert "must be 'module:attr'" in env["e"]


def test_the_same_binary_drives_both_packages_gateways(smoke_binary,
                                                       gateway):
    """One binary, two clusters: the JAX package's gateway and the port's
    answer it the same way."""
    from ray_tpu import xlang as ref_xlang

    ray_tpu.init(num_cpus=2)
    try:
        ref_address = ref_xlang.start_gateway()
        outs = []
        for mod, address in ((ray_tpu, ref_address),
                             (ray_tpu_torch, gateway)):
            fresh_counter(mod)
            proc = subprocess.run([smoke_binary, address], capture_output=True,
                                  text=True, timeout=120)
            outs.append((proc.returncode, proc.stdout.splitlines()[-1:]))
    finally:
        ref_xlang.stop_gateway()
        ray_tpu.shutdown()
    assert outs == [(0, ["SMOKE OK"])] * 2
