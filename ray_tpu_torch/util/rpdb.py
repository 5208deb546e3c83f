"""Remote pdb: breakpoints inside tasks/actors, attached from the CLI.

Equivalent of the reference's `python/ray/util/rpdb.py` (`ray debug`): a
worker hitting `set_trace()` opens a TCP listener, advertises itself in
the GCS KV, and blocks in a socket-backed Pdb until a debugger client
attaches (`python -m ray_tpu_torch debug`) or the wait times out. Post-mortem
via `post_mortem()` in an except block.
"""

from __future__ import annotations

import json
import os
import pdb
import socket
import sys
import time
from typing import Any, Dict, List, Optional

_KV_PREFIX = "__rpdb__:"


class _SocketIO:
    """File-like stdin/stdout over one accepted connection."""

    def __init__(self, conn: socket.socket):
        self._conn = conn
        self._rfile = conn.makefile("r")
        self._wfile = conn.makefile("w")

    def readline(self):
        return self._rfile.readline()

    def read(self, n):
        return self._rfile.read(n)

    def write(self, data):
        self._wfile.write(data)
        return len(data)

    def flush(self):
        try:
            self._wfile.flush()
        except Exception:  # noqa: BLE001 — client went away mid-session
            pass

    def close(self):
        for f in (self._rfile, self._wfile, self._conn):
            try:
                f.close()
            except Exception:  # noqa: BLE001
                pass


class _RemotePdb(pdb.Pdb):
    def __init__(self, io: _SocketIO):
        super().__init__(stdin=io, stdout=io)
        self.use_rawinput = False
        self.prompt = "(ray_tpu_torch-pdb) "
        self._io = io

    # continue/quit end the remote session: stop tracing BEFORE control
    # returns to the worker (otherwise the next traced call lands the
    # debugger inside this module's own cleanup code). A post-mortem
    # session traces nothing: it has no bottom frame to continue from.
    def _end_session(self):
        if getattr(self, "botframe", None) is not None:
            self.clear_all_breaks()
            self.set_continue()
        self._io.close()
        return 1

    def do_continue(self, arg):
        return self._end_session()

    do_c = do_cont = do_continue

    def do_quit(self, arg):
        return self._end_session()  # quit must not kill the worker

    do_q = do_exit = do_quit

    def do_EOF(self, arg):
        # Client disconnected: detach-and-continue. The inherited handler
        # would raise BdbQuit into the traced task, killing it.
        return self.do_continue(arg)


def _bind_host() -> str:
    """Debugger listeners bind localhost by default: an attached pdb is
    arbitrary code execution, so exposing it beyond the node requires the
    explicit ``RAY_TPU_TORCH_DEBUGGER_EXTERNAL=1`` opt-in (mirroring the
    reference's RAY_DEBUGGER_EXTERNAL, `python/ray/util/rpdb.py`)."""
    if os.environ.get("RAY_TPU_TORCH_DEBUGGER_EXTERNAL", "") in ("1", "true"):
        return "0.0.0.0"
    return "127.0.0.1"


def _node_ip() -> str:
    """This node's address as seen by the rest of the cluster: the raylet
    address workers were launched with, else a best-effort local IP."""
    addr = os.environ.get("RAY_TPU_TORCH_RAYLET_ADDRESS", "")
    if ":" in addr:
        host = addr.rsplit(":", 1)[0]
        if host not in ("", "0.0.0.0"):
            return host
    from ray_tpu_torch.util.net import primary_ip

    return primary_ip()


def _advertise(entry: Dict[str, Any]) -> Optional[str]:
    try:
        import ray_tpu_torch

        runtime = ray_tpu_torch._require_runtime()
        key = f"{_KV_PREFIX}{entry['id']}"
        runtime.gcs.call("kv_put", {"key": key,
                                    "value": json.dumps(entry).encode()})
        return key
    except Exception:  # noqa: BLE001 — no cluster: local-only breakpoint
        return None


def _unadvertise(key: Optional[str]) -> None:
    if key is None:
        return
    try:
        import ray_tpu_torch

        ray_tpu_torch._require_runtime().gcs.call("kv_del", {"key": key})
    except Exception:  # noqa: BLE001
        pass


def set_trace(frame=None, timeout_s: float = 300.0):
    """Block in a remote pdb session at the caller's frame.

    Advertises `host:port` in the GCS KV so `python -m ray_tpu_torch debug` can
    list and attach; gives up (and continues execution) after `timeout_s`
    with no client.
    """
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    bind_host = _bind_host()
    listener.bind((bind_host, 0))
    listener.listen(1)
    port = listener.getsockname()[1]
    host = _node_ip() if bind_host == "0.0.0.0" else "127.0.0.1"
    frame = frame or sys._getframe().f_back
    entry = {
        "id": f"{os.getpid()}-{port}",
        "host": host,
        "port": port,
        "pid": os.getpid(),
        "filename": frame.f_code.co_filename,
        "lineno": frame.f_lineno,
        "function": frame.f_code.co_name,
        "ts": time.time(),
    }
    key = _advertise(entry)
    print(f"ray_tpu_torch debugger waiting on {host}:{port} "
          f"({entry['filename']}:{entry['lineno']}) — attach with "
          "`python -m ray_tpu_torch debug`", file=sys.stderr, flush=True)
    listener.settimeout(timeout_s)
    try:
        conn, _ = listener.accept()
    except socket.timeout:
        print("ray_tpu_torch debugger: no client attached; continuing",
              file=sys.stderr)
        return
    finally:
        _unadvertise(key)
        listener.close()
    io = _SocketIO(conn)
    # Last statement on purpose: the first trace event after this call
    # must land in the CALLER's frame, not in cleanup code here.
    _RemotePdb(io).set_trace(frame)


def post_mortem(tb=None, timeout_s: float = 300.0):
    """Debug an exception's traceback remotely (call in an except block)."""
    if tb is None:
        tb = sys.exc_info()[2]
    if tb is None:
        raise ValueError("no traceback to debug")
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    bind_host = _bind_host()
    listener.bind((bind_host, 0))
    listener.listen(1)
    port = listener.getsockname()[1]
    host = _node_ip() if bind_host == "0.0.0.0" else "127.0.0.1"
    entry = {"id": f"{os.getpid()}-{port}", "host": host, "port": port,
             "pid": os.getpid(), "filename": "<post-mortem>", "lineno": 0,
             "function": "post_mortem", "ts": time.time()}
    key = _advertise(entry)
    print(f"ray_tpu_torch post-mortem waiting on {host}:{port}",
          file=sys.stderr, flush=True)
    listener.settimeout(timeout_s)
    try:
        conn, _ = listener.accept()
    except socket.timeout:
        return
    finally:
        _unadvertise(key)
        listener.close()
    io = _SocketIO(conn)
    try:
        _RemotePdb(io).interaction(None, tb)
    finally:
        io.close()


# --------------------------------------------------------------------------- #
# Client side (CLI)
# --------------------------------------------------------------------------- #


def list_breakpoints() -> List[Dict[str, Any]]:
    import ray_tpu_torch

    runtime = ray_tpu_torch._require_runtime()
    keys = runtime.gcs.call("kv_keys", {"prefix": _KV_PREFIX})["keys"]
    out = []
    for k in keys:
        try:
            v = runtime.gcs.call("kv_get", {"key": k})["value"]
            if v:
                out.append(json.loads(v))
        except Exception:  # noqa: BLE001
            pass
    return sorted(out, key=lambda e: e["ts"])


def attach(entry: Dict[str, Any], stdin=None, stdout=None) -> None:
    """Bridge this terminal to the advertised pdb session."""
    import threading

    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    conn = socket.create_connection((entry["host"], entry["port"]),
                                    timeout=10)

    def pump_out():
        # Byte-wise pump: the pdb prompt has no trailing newline, so a
        # line-based reader would never show it to an interactive user.
        while True:
            try:
                data = conn.recv(4096)
            except OSError:
                break
            if not data:
                break
            stdout.write(data.decode(errors="replace"))
            stdout.flush()

    t = threading.Thread(target=pump_out, daemon=True)
    t.start()
    session_ended = False
    try:
        for line in stdin:
            try:
                conn.sendall(line.encode() if isinstance(line, str)
                             else line)
            except OSError:  # server ended the session already
                session_ended = True
                break
            if line.strip() in ("c", "cont", "continue",
                                "q", "quit", "exit"):
                session_ended = True
                break
            if not t.is_alive():  # server closed: stop reading stdin
                session_ended = True
                break
    finally:
        if session_ended:
            # Server is ending the session: drain its last responses
            # before closing (closing first races them away).
            t.join(timeout=5)
        # stdin-EOF without a terminator: close NOW — the server is still
        # waiting for commands, and our close triggers its do_EOF detach.
        try:
            conn.close()
        except Exception:  # noqa: BLE001
            pass
        t.join(timeout=2)
