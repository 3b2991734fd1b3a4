"""Build-time warming of a proxy's step programs (the contract of the
JAX package's ``core/executor.py``).

A torch step has nothing to compile ahead of time, but its first call
still pays one-time costs: capturing the burn's CUDA graphs for each
trip count, creating the NCCL communicators, the library handles.
``compile_programs`` runs every program once at build time, fenced, so
none of that lands in ``warmup_times_us`` (and through it in
``estimate_runs``).  It records the time of that call as the program's
``compile_ms`` and, on the card, its peak device memory
(``torch.cuda.max_memory_allocated``) under ``aot``.  The JAX package's
donation has no counterpart: the steps update their buffers in place.
"""
from __future__ import annotations

import time
from collections.abc import Callable

import torch

from dlnetbench_tpu_torch.utils.timing import fence


def compile_programs(programs: dict[str, Callable], device: torch.device,
                     global_meta: dict | None = None
                     ) -> dict[str, Callable]:
    """Warm each zero-argument program once; returns them unchanged."""
    compile_ms, aot = {}, {}
    cuda = device.type == "cuda"
    for name, fn in programs.items():
        fence(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        fn()
        fence(device)
        compile_ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
        aot[name] = ({"peak_memory_bytes":
                      torch.cuda.max_memory_allocated(device)}
                     if cuda else {})
    if global_meta is not None:
        global_meta["compile_ms"] = compile_ms
        global_meta["aot"] = aot
    return programs
