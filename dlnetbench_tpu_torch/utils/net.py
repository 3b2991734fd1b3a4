"""Loopback networking helpers."""
from __future__ import annotations

import socket


def free_port() -> int:
    """An OS-assigned free TCP port on loopback.  Another process can
    take it before the caller binds it, so a bind failure there is
    retryable."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
