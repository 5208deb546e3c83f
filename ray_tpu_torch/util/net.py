"""Network address helpers shared by the CLI, debugger, and backends (the
port's counterpart of `ray_tpu/util/net.py`)."""

from __future__ import annotations

import socket


def primary_ip() -> str:
    """This machine's primary interface IP — the address peers can dial.

    UDP-connect route lookup (no packet is sent), with hostname-resolution
    and loopback fallbacks for isolated machines.
    """
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("8.8.8.8", 80))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"
