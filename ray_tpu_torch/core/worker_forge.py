"""Worker forge: a per-node forkserver that spawns workers in milliseconds.

The reference hides worker cold starts by prestarting one worker per core
(`worker_pool.h:347`); beyond that target every spawn still pays a full
``exec`` plus the Python import bill (about a second for the worker
module set, several with torch). That bill is the actor-creation bottleneck:
every serve replica is an actor, and replica scale-up serializes behind
interpreter cold starts.

The forge is a **template process**, one per OS process hosting raylets
(shared by in-process fake clusters, since the import cache it exists to
amortize is per-process; on a real deployment that is one per raylet) and
reused across clusters — clients detach on node stop and the template
lingers, self-exiting when its parent dies or no control connection
remains for 30s:

- it preimports the heavy module set (``worker_forge_preimports``, default
  ``ray_tpu_torch.core.worker,numpy``) and then does nothing but watch a unix
  socket — single-threaded, no RPC clients, CUDA never initialised;
- on a spawn request it ``fork()``s: the child inherits the warm module
  cache (copy-on-write), applies its granted env vars, redirects stdio to
  its worker log, reseeds per-process RNG state, and only THEN connects to
  the raylet and runs the normal worker main loop;
- it reaps its children via SIGCHLD and streams ``exit`` events back to the
  raylet, so forged-worker death detection is event-driven (no waitpid
  surface exists across the process boundary).

Fork-safety contract (asserted, not assumed): at fork time the template
must have exactly one thread and CUDA uninitialised
(``torch.cuda.is_initialized()`` false, read only if torch was imported) —
a forked child of a multi-threaded parent can deadlock on locks held by
threads that don't survive the fork, and CUDA state does not survive a
fork at all. The template refuses to fork when the contract is violated
(the raylet falls back to cold spawn), and ``status`` exposes the
thread/CUDA state so tests can pin it. The template runs with
``CUDA_VISIBLE_DEVICES=""``, as CPU workers do.

Fork-incompatible grants — a GPU grant (``RAY_TPU_TORCH_GRANTED_GPU``),
whose worker must start with its own ``CUDA_VISIBLE_DEVICES`` — always
take the cold ``exec`` path.

Wire protocol (length-prefixed msgpack frames over the unix socket):

    -> {c: "spawn", env: {delta vars}, cwd, log}   => {ok, pid | error}
    -> {c: "status"}                               => {ok, pid, threads,
                                                       cuda_initialized,
                                                       preimported, ...}
    <- {c: "exit", pid, code}                      (async, broadcast)

Replies are FIFO per connection (the client serializes calls); ``exit``
events interleave and are routed by the client's reader thread.
"""

from __future__ import annotations

import logging
import os
import tempfile
import queue
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import msgpack
from ray_tpu_torch.core.common import GPU_GRANT

logger = logging.getLogger(__name__)

_HDR = struct.Struct("<I")

# Template-side liveness/orphan policy.
_IDLE_EXIT_S = 30.0       # no control connection this long -> exit
_SELECT_TICK_S = 1.0      # ppid / idle / term-flag check cadence


def _send_frame(sock: socket.socket, obj: Dict[str, Any],
                lock: Optional[threading.Lock] = None):
    buf = msgpack.packb(obj)
    data = _HDR.pack(len(buf)) + buf
    if lock is not None:
        with lock:
            sock.sendall(data)
    else:
        sock.sendall(data)


def _recv_frame(sock: socket.socket) -> Dict[str, Any]:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            raise ConnectionError("forge peer closed")
        hdr += chunk
    (n,) = _HDR.unpack(hdr)
    body = bytearray()
    while len(body) < n:
        chunk = sock.recv(n - len(body))
        if not chunk:
            raise ConnectionError("forge peer closed")
        body += chunk
    return msgpack.unpackb(bytes(body))


def process_tag() -> str:
    """Marker carried in the template's argv (and therefore in every
    forked worker's cmdline): identifies the driver/raylet process that
    owns the template, for orphan scans and debugging."""
    return f"rttforge-{os.getpid()}"


# --------------------------------------------------------------------------- #
# Template (forge process) side
# --------------------------------------------------------------------------- #


class _ForgeTemplate:
    """The forkserver loop. Runs as ``python -m ray_tpu_torch.core.worker_forge``;
    deliberately single-threaded — see the module fork-safety contract."""

    def __init__(self, socket_path: str, preimports: List[str]):
        self._socket_path = socket_path
        self._preimports = preimports
        self._preimported: List[str] = []
        self._import_errors: Dict[str, str] = {}
        self._children: set = set()
        self._forks = 0
        self._term = False
        self._start_ppid = os.getppid()
        self._conns: List[socket.socket] = []
        self._listener: Optional[socket.socket] = None
        self._wakeup_r = -1
        self._wakeup_w = -1
        self._last_conn_s = time.monotonic()

    # ------------------------------------------------------------ lifecycle

    def run(self) -> int:
        for mod in self._preimports:
            mod = mod.strip()
            if not mod:
                continue
            try:
                __import__(mod)
                self._preimported.append(mod)
            except Exception as e:  # noqa: BLE001 — degrade, don't die
                self._import_errors[mod] = f"{type(e).__name__}: {e}"
                logger.warning("forge preimport of %s failed: %s", mod, e)
        try:
            os.unlink(self._socket_path)
        except OSError:
            pass
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self._socket_path)
        self._listener.listen(8)
        # SIGCHLD wakes the select loop through the wakeup pipe so child
        # exits are reaped (and reported) immediately, not on the next tick.
        self._wakeup_r, self._wakeup_w = os.pipe()
        os.set_blocking(self._wakeup_w, False)
        signal.set_wakeup_fd(self._wakeup_w)
        signal.signal(signal.SIGCHLD, lambda s, f: None)
        signal.signal(signal.SIGTERM, self._on_term)
        logger.info("forge ready on %s (preimported: %s)",
                    self._socket_path, ",".join(self._preimported))
        try:
            self._loop()
        finally:
            self._shutdown()
        return 0

    def _on_term(self, signum, frame):
        self._term = True

    def _shutdown(self):
        # Forward TERM to surviving children: the raylet kills the workers
        # it knows about before stopping the forge, so anything left here
        # is an in-flight spawn that must not outlive the node.
        for pid in list(self._children):
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass
        try:
            os.unlink(self._socket_path)
        except OSError:
            pass

    # ----------------------------------------------------------- main loop

    def _loop(self):
        import select

        while not self._term:
            rlist = [self._listener, self._wakeup_r] + self._conns
            try:
                ready, _, _ = select.select(rlist, [], [], _SELECT_TICK_S)
            except InterruptedError:
                ready = []
            except OSError:
                return
            self._reap()
            if self._term:
                return
            if os.getppid() != self._start_ppid:
                logger.info("forge parent died; exiting")
                return
            if not self._conns and \
                    time.monotonic() - self._last_conn_s > _IDLE_EXIT_S:
                logger.info("forge idle with no control connection; exiting")
                return
            for r in ready:
                if r is self._wakeup_r:
                    try:
                        os.read(self._wakeup_r, 4096)
                    except OSError:
                        pass
                elif r is self._listener:
                    try:
                        conn, _ = self._listener.accept()
                        self._conns.append(conn)
                        self._last_conn_s = time.monotonic()
                    except OSError:
                        pass
                else:
                    self._serve_one(r)
            if self._conns:
                self._last_conn_s = time.monotonic()

    def _serve_one(self, conn: socket.socket):
        try:
            req = _recv_frame(conn)
        except (ConnectionError, OSError):
            self._drop_conn(conn)
            return
        cmd = req.get("c")
        try:
            if cmd == "spawn":
                reply = self._handle_spawn(req)
            elif cmd == "status":
                reply = self._status()
            else:
                reply = {"ok": False, "error": f"unknown command {cmd!r}"}
        except Exception as e:  # noqa: BLE001 — reply, don't die
            logger.exception("forge command %s failed", cmd)
            reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        reply["i"] = req.get("i", 0)  # correlation id, echoed verbatim
        try:
            _send_frame(conn, reply)
        except OSError:
            self._drop_conn(conn)

    def _drop_conn(self, conn: socket.socket):
        try:
            conn.close()
        except OSError:
            pass
        if conn in self._conns:
            self._conns.remove(conn)
        self._last_conn_s = time.monotonic()

    def _status(self) -> Dict[str, Any]:
        # Read without importing torch: a template that never imported it
        # cannot have initialised CUDA.
        torch = sys.modules.get("torch")
        cuda = bool(torch is not None and torch.cuda.is_initialized())
        return {"ok": True, "pid": os.getpid(),
                "threads": threading.active_count(),
                "cuda_initialized": cuda,
                "preimported": list(self._preimported),
                "import_errors": dict(self._import_errors),
                "forks": self._forks,
                "children": len(self._children)}

    def _reap(self):
        while True:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                return
            if pid == 0:
                return
            self._children.discard(pid)
            try:
                code = os.waitstatus_to_exitcode(status)
            except ValueError:
                code = -1
            event = {"c": "exit", "pid": pid, "code": code}
            for conn in list(self._conns):
                try:
                    _send_frame(conn, event)
                except OSError:
                    self._drop_conn(conn)

    # ---------------------------------------------------------------- fork

    def _handle_spawn(self, req: Dict[str, Any]) -> Dict[str, Any]:
        # Fork-safety contract: refuse rather than fork a process whose
        # other threads may hold locks the child would inherit frozen.
        if threading.active_count() != 1:
            return {"ok": False,
                    "error": f"template has {threading.active_count()} "
                             "threads; fork is unsafe"}
        st = self._status()
        if st["cuda_initialized"]:
            return {"ok": False,
                    "error": "template initialized CUDA; fork is unsafe"}
        self._reap()  # bound the zombie window even under spawn storms
        pid = os.fork()
        if pid != 0:
            self._forks += 1
            self._children.add(pid)
            return {"ok": True, "pid": pid}
        # ------------------------------------------------------- child
        try:
            self._child_main(req)
        except BaseException:  # noqa: BLE001 — child must never return
            import traceback

            traceback.print_exc()
        finally:
            os._exit(1)

    def _child_main(self, req: Dict[str, Any]):
        # Shed every forge artifact before touching worker state: signal
        # plumbing first (a stray SIGCHLD must not write a closed pipe),
        # then the inherited sockets.
        signal.set_wakeup_fd(-1)
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        self._children.clear()
        for s in [self._listener] + self._conns:
            try:
                s.close()
            except OSError:
                pass
        for fd in (self._wakeup_r, self._wakeup_w):
            try:
                os.close(fd)
            except OSError:
                pass
        log_path = req.get("log")
        if log_path:
            fd = os.open(log_path,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            sys.stdout.flush()
            sys.stderr.flush()
            os.dup2(fd, 1)
            os.dup2(fd, 2)
            os.close(fd)
        env = {str(k): str(v) for k, v in (req.get("env") or {}).items()}
        os.environ.update(env)
        cwd = req.get("cwd")
        if cwd:
            try:
                os.chdir(cwd)
            except OSError:
                pass
        # PYTHONPATH landed after interpreter start: graft it onto sys.path
        # so worker-side function/module resolution matches a cold spawn.
        for p in reversed(os.environ.get("PYTHONPATH", "")
                          .split(os.pathsep)):
            if p and p not in sys.path:
                sys.path.insert(0, p)
        from ray_tpu_torch.core import worker

        worker.forked_main()
        os._exit(0)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="ray_tpu_torch.core.worker_forge")
    ap.add_argument("--socket", required=True)
    ap.add_argument("--tag", default="", help="owner-process marker (lands "
                    "in this process's and every forked worker's argv, so "
                    "orphan scans can find them)")
    ap.add_argument("--preimports", default="")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format=(f"%(asctime)s [forge pid={os.getpid()}] "
                "%(levelname)s %(name)s: %(message)s"))
    tmpl = _ForgeTemplate(args.socket, args.preimports.split(","))
    return tmpl.run()


# --------------------------------------------------------------------------- #
# Raylet (client) side
# --------------------------------------------------------------------------- #


class ForgeUnavailable(RuntimeError):
    """The forge cannot serve this spawn (dead, not ready, or refused)."""


class _ForgedProc:
    """Popen-quacking handle for a forge-forked worker.

    The worker is a child of the forge template, not of this process, so
    the Popen surface (poll/wait/terminate/kill) is emulated from forge
    ``exit`` events, falling back to liveness probes once the template
    incarnation that forked the worker is gone (events can no longer
    arrive; the orphaned child gets reparented and reaped by init)."""

    def __init__(self, pid: int, forge: "WorkerForge", generation: int):
        self.pid = pid
        self.returncode: Optional[int] = None
        self._forge = forge
        self._generation = generation
        self._exited = threading.Event()

    def _mark_exited(self, code: int):
        if self.returncode is None:
            self.returncode = code
        self._exited.set()

    def _events_lost(self) -> bool:
        f = self._forge
        return f is None or f.generation != self._generation or not f.alive

    def poll(self) -> Optional[int]:
        if self.returncode is None and self._events_lost():
            try:
                os.kill(self.pid, 0)
            except ProcessLookupError:
                self._mark_exited(-1)
            except PermissionError:
                pass  # exists under another uid: pid recycled, leave None
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.poll() is not None:
                return self.returncode
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise subprocess.TimeoutExpired("forged-worker", timeout)
            # Short slices: the event path resolves instantly; the slice
            # only bounds the probe cadence after a forge death.
            step = 0.2 if remaining is None else min(0.2, remaining)
            if self._exited.wait(step):
                return self.returncode

    def _signal(self, sig: int):
        if self.returncode is not None:
            return
        try:
            os.kill(self.pid, sig)
        except (ProcessLookupError, PermissionError):
            pass

    def terminate(self):
        self._signal(signal.SIGTERM)

    def kill(self):
        self._signal(signal.SIGKILL)


_CONN_LOST = object()  # reply-queue sentinel: reader died mid-call


class _SharedTemplate:
    """One template PROCESS, shared by every WorkerForge client in this
    process and reused across clusters.

    Why shared: the template's value is its warm import cache, and the
    import bill is per-process — N in-process raylets (cluster_utils fake
    clusters, the bench envelope, the test suite) each paying ~1s of
    template imports per cluster would cost more than cold spawns save.
    One template serves any raylet: every spawn request carries its full
    env delta (raylet/GCS addresses, session, worker id), so the template
    holds no per-cluster state. On a real deployment (one raylet per host
    process) this is exactly one template per raylet, as before.

    Lifetime: lazily (re)launched on demand; never killed on client
    stop — it lingers and self-reaps via its own guards (exits when its
    parent process dies or after 30s with no control connection), so the
    next cluster in a long-lived process reconnects to a warm template
    instead of re-paying the imports. `kill()` exists for a wedged
    template (reply timeout) and for tests."""

    def __init__(self, preimports: str):
        self.preimports = preimports
        self.lock = threading.Lock()
        self.proc: Optional[subprocess.Popen] = None
        self.launching = False
        self._seq = 0
        self.socket_path = ""
        base = os.environ.get("RAY_TPU_TORCH_TMPDIR") or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch")
        self.log_path = os.path.join(base, f"{process_tag()}.log")

    def ensure(self) -> str:
        """Launch the template if it isn't running; returns the socket
        path clients should (re)connect to. The Popen runs OUTSIDE the
        lock (RL002); a concurrent ensure() sees `launching` and just
        returns the new socket path — its connect loop retries until the
        fresh template binds it."""
        with self.lock:
            if (self.proc is not None and self.proc.poll() is None) \
                    or self.launching:
                return self.socket_path
            self.launching = True
            self._seq += 1
            # Proc-scoped /tmp path: short (AF_UNIX 107-byte limit) and
            # independent of any session dir that may be torn down while
            # the template lingers.
            self.socket_path = f"/tmp/{process_tag()}-{self._seq}.sock"
            path = self.socket_path
        proc = None
        try:
            proc = self._launch(path)
        finally:
            with self.lock:
                self.proc = proc
                self.launching = False
        return path

    def _launch(self, socket_path: str) -> subprocess.Popen:
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        env = dict(os.environ)
        env.update(GLOBAL_CONFIG.to_env())
        # Template mirrors the CPU-worker env (WorkerPool.spawn_worker):
        # no card is visible to it or to the workers it forks.
        env["CUDA_VISIBLE_DEVICES"] = ""
        import ray_tpu_torch as _pkg

        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(_pkg.__file__)))
        parts = [pkg_root, os.getcwd()] + \
            ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
        os.makedirs(os.path.dirname(self.log_path), exist_ok=True)
        out = open(self.log_path, "ab")
        try:
            return subprocess.Popen(
                [sys.executable, "-u", "-m", "ray_tpu_torch.core.worker_forge",
                 "--socket", socket_path,
                 "--tag", process_tag(),
                 "--preimports", self.preimports],
                env=env, stdout=out, stderr=subprocess.STDOUT,
                cwd=os.getcwd(), close_fds=True)
        finally:
            out.close()

    def kill(self):
        with self.lock:
            proc = self.proc
        if proc is None or proc.poll() is not None:
            return
        try:
            proc.terminate()
            proc.wait(timeout=2.0)
        except subprocess.TimeoutExpired:
            try:
                proc.kill()
                proc.wait(timeout=1.0)
            except (OSError, subprocess.TimeoutExpired):
                pass
        except OSError:
            pass


_templates_lock = threading.Lock()
_templates: Dict[str, _SharedTemplate] = {}


def shared_template(preimports: str) -> _SharedTemplate:
    with _templates_lock:
        t = _templates.get(preimports)
        if t is None:
            t = _templates[preimports] = _SharedTemplate(preimports)
        return t


class WorkerForge:
    """Raylet-side forge lifecycle + spawn client.

    Thread model: ``spawn``/``status`` calls pipeline freely — requests
    carry correlation ids, a reader thread routes each reply to its
    caller's slot (and exit events to the raylet callback), so no caller
    ever blocks while holding a lock. Template (re)starts run on
    background threads. All threads are daemons AND joined on ``stop()``.
    Never call into this class while holding the worker-pool or raylet
    lock — spawn is a socket round trip (RL002).
    """

    # Give up on the forge after this many consecutive template failures
    # (crash-looping template: every spawn would eat a restart attempt).
    MAX_CONSECUTIVE_FAILURES = 5

    def __init__(self, session_dir: str, session_suffix: str,
                 node_hex: str,
                 on_worker_exit: Optional[Callable[[int, int], None]] = None,
                 preimports: Optional[str] = None):
        self._session_dir = session_dir
        self._session_suffix = session_suffix
        self._node_hex = node_hex
        self.on_worker_exit = on_worker_exit
        # Per-runtime-env template override (comma-separated module list):
        # a job whose runtime_env carries `preimports` gets its own forge
        # keyed on this set, so its workers fork with the job's heavy
        # modules already imported. None -> the node-wide default set.
        self._preimports_override = preimports
        self._template: Optional[_SharedTemplate] = None
        self.generation = 0
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._msg_counter = 0
        self._pending: Dict[int, "queue.Queue"] = {}  # msg id -> reply slot
        self._ready = threading.Event()
        self._stopped = threading.Event()
        self._restarting = False
        self._consecutive_failures = 0
        self._procs: Dict[int, _ForgedProc] = {}
        self._early_exits: Dict[int, int] = {}
        self._threads: List[threading.Thread] = []

    # ------------------------------------------------------------ lifecycle

    @property
    def alive(self) -> bool:
        return self._ready.is_set()

    @property
    def proc(self) -> Optional[subprocess.Popen]:
        """The (shared) template process handle."""
        return self._template.proc if self._template is not None else None

    def wait_ready(self, timeout: float = 30.0) -> bool:
        return self._ready.wait(timeout)

    @staticmethod
    def compatible(env_extra: Dict[str, str]) -> bool:
        """Can this grant run in a forked worker? A GPU grant sets the
        worker's CUDA_VISIBLE_DEVICES, which CUDA reads once, when it
        initialises; a fork also must never carry CUDA state. So a GPU
        worker is always a cold spawn."""
        return GPU_GRANT not in env_extra

    def start(self):
        """Attach to the process-shared template — launching it if
        needed — and connect in the background (a fresh template pays the
        preimport bill before it binds the socket; spawns before
        readiness fall back to cold). A warm lingering template from an
        earlier cluster in this process connects in milliseconds."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        self._template = shared_template(
            self._preimports_override
            if self._preimports_override is not None
            else GLOBAL_CONFIG.worker_forge_preimports)
        self._launch_template()
        t = threading.Thread(target=self._connect_loop,
                             args=(self.generation,),
                             name="forge-connect", daemon=True)
        t.start()
        self._track(t)

    def _launch_template(self):
        self.generation += 1
        with self._state_lock:
            self._procs.clear()  # stale generation: they self-detect
            self._early_exits.clear()
        self._socket_path = self._template.ensure()

    def _connect_loop(self, generation: int):
        deadline = time.monotonic() + 60.0
        while not self._stopped.is_set() and generation == self.generation:
            proc = self._template.proc
            if not self._template.launching and (
                    proc is None or proc.poll() is not None):
                self._template_failed("template exited during startup")
                return
            try:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.connect(self._socket_path)
            except OSError:
                if time.monotonic() > deadline:
                    self._template_failed("template never became ready")
                    return
                time.sleep(0.05)
                continue
            if self._stopped.is_set() or generation != self.generation:
                # Lost the race with stop()/restart: this socket belongs
                # to nobody — close it rather than leak the fd.
                try:
                    sock.close()
                except OSError:
                    pass
                return
            self._sock = sock
            self._consecutive_failures = 0
            self._ready.set()
            t = threading.Thread(target=self._read_loop,
                                 args=(sock, generation),
                                 name="forge-reader", daemon=True)
            t.start()
            self._track(t)
            return

    def _template_failed(self, reason: str):
        logger.warning("worker forge: %s (cold spawns continue)", reason)
        self._consecutive_failures += 1
        self._mark_dead()
        if self._consecutive_failures < self.MAX_CONSECUTIVE_FAILURES:
            self.restart_async()
        else:
            logger.error(
                "worker forge disabled after %d consecutive failures — "
                "see %s", self._consecutive_failures,
                self._template.log_path if self._template else "?")

    def _mark_dead(self):
        self._ready.clear()
        sock, self._sock = self._sock, None
        if sock is not None:
            # shutdown() BEFORE close: close() alone does not wake a
            # reader blocked in recv() on a healthy connection (the
            # lingering shared template keeps its end open), and stop()
            # would then burn its full join timeout per forge client.
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        # Unblock every call parked on a reply slot.
        with self._state_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for slot in pending:
            slot.put(_CONN_LOST)

    def _read_loop(self, sock: socket.socket, generation: int):
        try:
            while not self._stopped.is_set():
                frame = _recv_frame(sock)
                if frame.get("c") == "exit":
                    pid, code = frame["pid"], frame["code"]
                    with self._state_lock:
                        proc = self._procs.pop(pid, None)
                        if proc is None:
                            # Exit raced the spawn reply: stash for the
                            # spawn() caller to consume on registration.
                            # Bounded: exit events broadcast to EVERY
                            # client of the shared template, so most pids
                            # here belong to other raylets' workers and
                            # no spawn() of ours will ever claim them.
                            self._early_exits[pid] = code
                            while len(self._early_exits) > 256:
                                self._early_exits.pop(
                                    next(iter(self._early_exits)))
                    if proc is not None:
                        proc._mark_exited(code)
                    cb = self.on_worker_exit
                    if cb is not None and proc is not None:
                        try:
                            cb(pid, code)
                        except Exception:  # noqa: BLE001 — observer only
                            logger.exception("forge exit callback failed")
                else:
                    with self._state_lock:
                        slot = self._pending.pop(frame.get("i", 0), None)
                    if slot is not None:
                        slot.put(frame)
        except (ConnectionError, OSError):
            pass
        finally:
            if not self._stopped.is_set() and generation == self.generation:
                self._template_failed("control connection lost")

    def restart_async(self):
        """Relaunch a dead template in the background (spawns keep falling
        back to cold until the new one is ready)."""
        with self._state_lock:
            if (self._stopped.is_set() or self._ready.is_set()
                    or self._restarting
                    or self._consecutive_failures
                    >= self.MAX_CONSECUTIVE_FAILURES):
                return
            self._restarting = True
        t = threading.Thread(target=self._restart, name="forge-restart",
                             daemon=True)
        t.start()
        self._track(t)

    def _restart(self):
        try:
            while (not self._stopped.is_set() and not self._ready.is_set()
                   and self._consecutive_failures
                   < self.MAX_CONSECUTIVE_FAILURES):
                # Settle delay: lets a dying template release its socket
                # and spaces out attempts when the template crash-loops.
                backoff = min(5.0, 0.5 * (2 ** self._consecutive_failures))
                if self._stopped.wait(backoff):
                    return
                if self._consecutive_failures >= 2:
                    # Repeated failures against a live process: the shared
                    # template is wedged, not merely our connection —
                    # escalate to a kill + respawn. A single failure only
                    # reconnects (the template serves other raylets too).
                    self._template.kill()
                self._launch_template()
                self._connect_loop(self.generation)
        finally:
            with self._state_lock:
                self._restarting = False

    def stop(self):
        """Detach from the shared template (which lingers for the next
        cluster in this process and self-exits on idle or parent death —
        never killed here: other raylets may still be using it)."""
        self._stopped.set()
        self._mark_dead()
        with self._state_lock:
            threads = list(self._threads)
            self._threads.clear()
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)

    def _track(self, t: threading.Thread):
        with self._state_lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    # ----------------------------------------------------------------- RPC

    def _call(self, req: Dict[str, Any],
              timeout: float = 10.0) -> Dict[str, Any]:
        sock = self._sock
        if sock is None or not self._ready.is_set():
            raise ForgeUnavailable("forge is not running")
        slot: "queue.Queue" = queue.Queue()
        with self._state_lock:
            self._msg_counter += 1
            msg_id = self._msg_counter
            self._pending[msg_id] = slot
        req = dict(req, i=msg_id)
        try:
            _send_frame(sock, req, self._send_lock)
        except OSError as e:
            with self._state_lock:
                self._pending.pop(msg_id, None)
            self._mark_dead()
            raise ForgeUnavailable(f"forge send failed: {e}")
        try:
            reply = slot.get(timeout=timeout)
        except queue.Empty:
            with self._state_lock:
                self._pending.pop(msg_id, None)
            # A wedged template can't be trusted with the next fork.
            self._mark_dead()
            raise ForgeUnavailable("forge reply timed out")
        if reply is _CONN_LOST:
            raise ForgeUnavailable("forge died mid-call")
        if not reply.get("ok"):
            raise ForgeUnavailable(reply.get("error", "forge refused"))
        return reply

    def spawn(self, env_delta: Dict[str, str], cwd: str,
              log_path: str) -> _ForgedProc:
        """Fork a fully-imported worker; returns its Popen-like handle.
        Raises ForgeUnavailable (caller falls back to cold spawn)."""
        from ray_tpu_torch.observability import tracing as _tracing

        with _tracing.get_tracer().start_span("forge.fork") as span:
            reply = self._call({"c": "spawn", "env": env_delta, "cwd": cwd,
                                "log": log_path})
            span.set_attr("pid", reply.get("pid"))
        pid = reply["pid"]
        proc = _ForgedProc(pid, self, self.generation)
        with self._state_lock:
            early = self._early_exits.pop(pid, None)
            if early is None:
                self._procs[pid] = proc
        if early is not None:
            proc._mark_exited(early)
        return proc

    def status(self) -> Dict[str, Any]:
        """Template introspection (fork-safety tests, debug_state)."""
        return self._call({"c": "status"})


if __name__ == "__main__":
    sys.exit(main())
