"""Loopback networking helpers."""
from __future__ import annotations

import socket


def free_port() -> int:
    """An OS-assigned TCP port free on every local address (a store
    listens on all of them).  Another process can take it before the
    caller binds it, so a bind failure there is retryable."""
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]
