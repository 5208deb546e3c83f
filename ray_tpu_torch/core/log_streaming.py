"""Worker log streaming to the driver.

Equivalent of the reference's log_to_driver pipeline (worker stdout/stderr
files tailed by the log monitor and republished over GCS pubsub to the
driver, `python/ray/_private/log_monitor.py`). Redesigned in-process: each
worker tees sys.stdout/stderr — lines still land in the per-worker log file,
and batched copies ride the LOG pubsub channel; subscribed drivers reprint
them with a worker prefix.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, List

LOG_CHANNEL = "LOG"
_FLUSH_PERIOD_S = 0.25
_MAX_BUFFER_LINES = 2000  # drop (count) beyond this between flushes


class _TeeStream:
    def __init__(self, base, streamer: "LogStreamer", name: str):
        self._base = base
        self._streamer = streamer
        self._name = name

    def write(self, s: str) -> int:
        n = self._base.write(s)
        self._streamer.feed(self._name, s)
        return n

    def flush(self):
        self._base.flush()

    def __getattr__(self, attr):  # fileno, isatty, encoding, ...
        return getattr(self._base, attr)


class LogStreamer:
    """Worker side: batch stdout/stderr lines to the LOG pubsub channel.

    `job_provider` returns the job hex of the task currently executing (or
    None) so drivers can filter out other jobs' output — the reference's
    log monitor scopes streams to the owning driver the same way.
    """

    def __init__(self, gcs_client, worker_id_hex: str, pid: int,
                 job_provider=None):
        self._gcs = gcs_client
        self._id = worker_id_hex[:12]
        self._pid = pid
        self._job_provider = job_provider or (lambda: None)
        self._lock = threading.Lock()
        self._pending: List[tuple] = []  # (stream, line)
        self._partial = {"stdout": "", "stderr": ""}
        self._dropped = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="log-stream", daemon=True)

    def install(self):
        sys.stdout = _TeeStream(sys.stdout, self, "stdout")
        sys.stderr = _TeeStream(sys.stderr, self, "stderr")
        self._thread.start()

    def feed(self, stream: str, s: str):
        with self._lock:
            buf = self._partial[stream] + s
            *lines, self._partial[stream] = buf.split("\n")
            for line in lines:
                if len(self._pending) >= _MAX_BUFFER_LINES:
                    self._dropped += 1
                else:
                    self._pending.append((stream, line))

    def _loop(self):
        while not self._stop.wait(_FLUSH_PERIOD_S):
            self.flush()

    def flush(self):
        with self._lock:
            if not self._pending and not self._dropped:
                return
            batch, self._pending = self._pending, []
            dropped, self._dropped = self._dropped, 0
        try:
            job = self._job_provider()
        except Exception:  # noqa: BLE001
            job = None
        try:
            self._gcs.call("publish", {
                "channel": LOG_CHANNEL, "key": b"*",
                "message": {"worker": self._id, "pid": self._pid, "job": job,
                            "lines": batch, "dropped": dropped}}, timeout=5)
        except Exception:  # noqa: BLE001 — logs are best-effort
            pass

    def stop(self):
        self._stop.set()
        self.flush()


def print_log_batch(message: Any, out=None):
    """Driver side: render one LOG pubsub message (reference
    print_to_stdstream formatting: '(pid=..., worker=...)' prefix)."""
    out = out or sys.stderr
    prefix = f"({message['worker']} pid={message['pid']})"
    for _stream, line in message.get("lines", []):
        print(f"{prefix} {line}", file=out)
    if message.get("dropped"):
        print(f"{prefix} ... {message['dropped']} log lines dropped "
              "(rate limit)", file=out)
