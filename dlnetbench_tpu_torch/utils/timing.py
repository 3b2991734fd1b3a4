"""Wall-clock timing of eager torch programs.

A CUDA call returns before the device finishes, so every measurement
here fences with ``torch.cuda.synchronize()`` on the card, around the
whole program and never inside it (on-device overlap is preserved).

The JAX package's ``utils/timing.py`` fences its remote TPU backend
with a device-to-host transfer and subtracts the measured round trip,
because ``block_until_ready`` there only acknowledges dispatch.  None of
that applies here: ``synchronize()`` waits for the device, and there is
no round trip to subtract.
"""
from __future__ import annotations

import time

import torch


def fence(device: torch.device | str | None = None) -> None:
    """Wait for the device's queued work (a no-op on the CPU, where
    torch ops are synchronous)."""
    dev = torch.device(device) if device is not None else None
    if (dev is None or dev.type == "cuda") and torch.cuda.is_available():
        torch.cuda.synchronize(dev)


def time_callable(fn, *args, reps: int = 1, device=None,
                  **kwargs) -> list[float]:
    """Run ``fn(*args)`` ``reps`` times, fencing before and after each
    run; returns seconds per run.  The caller warms up first."""
    out = []
    for _ in range(reps):
        fence(device)
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        fence(device)
        out.append(time.perf_counter() - t0)
    return out
