"""Wall-clock timing of eager torch programs.

A CUDA call returns before the device finishes, so every measurement
here fences with ``torch.cuda.synchronize()`` on the card, around the
whole program and never inside it (on-device overlap is preserved).

The JAX package's ``utils/timing.py`` fences its remote TPU backend
with a device-to-host transfer and subtracts the measured round trip,
because ``block_until_ready`` there only acknowledges dispatch.  None of
that applies here: ``synchronize()`` waits for the device, and there is
no round trip to subtract.  ``fence_rtt_s`` measures what an empty
fence costs the host, which the proxies' records carry as
``host_rtt_us``.

While span tracing is on (``metrics/spans.py``), the fence that closes
each timed run or chain is a ``fence`` span, so the merged timeline
shows the host waiting on the device apart from the dispatch burst;
the check is one global load, so an untraced run pays nothing more.
"""
from __future__ import annotations

import statistics
import time

import torch

from dlnetbench_tpu_torch.metrics import spans


def fence(device: torch.device | str | None = None) -> None:
    """Wait for the device's queued work (a no-op on the CPU, where
    torch ops are synchronous)."""
    dev = torch.device(device) if device is not None else None
    if (dev is None or dev.type == "cuda") and torch.cuda.is_available():
        torch.cuda.synchronize(dev)


def _closing_fence(device, k: int) -> None:
    """The fence that ends a timed run (a ``fence`` span when
    tracing)."""
    if spans.is_enabled():
        with spans.span("fence", k=k):
            fence(device)
        return
    fence(device)


def time_callable(fn, *args, reps: int = 1, device=None,
                  **kwargs) -> list[float]:
    """Run ``fn(*args)`` ``reps`` times, fencing before and after each
    run; returns seconds per run.  The caller warms up first."""
    out = []
    for _ in range(reps):
        fence(device)
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _closing_fence(device, 1)
        out.append(time.perf_counter() - t0)
    return out


def time_chain(fn, *args, k: int = 1, device=None, **kwargs) -> float:
    """Run ``fn(*args)`` ``k`` times back to back with one fence after
    the last call (and one before the first); returns seconds per
    iteration.  Each call's device work queues behind the previous
    call's, so the chain is k honest iterations, and the fence's host
    cost is paid once per chain instead of once per iteration."""
    if k <= 1:
        return time_callable(fn, *args, device=device, **kwargs)[0]
    fence(device)
    t0 = time.perf_counter()
    for _ in range(k):
        fn(*args, **kwargs)
    _closing_fence(device, k)
    return (time.perf_counter() - t0) / k


def fence_rtt_s(device=None, reps: int = 5) -> float:
    """Host time of a fence with nothing queued (the least of ``reps``
    samples): the floor every fenced sample pays once."""
    fence(device)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fence(device)
        out.append(time.perf_counter() - t0)
    return min(out)


def median_us(samples_s: list[float]) -> float:
    return statistics.median(samples_s) * 1e6
