"""Launching `_loop` congestor jobs (the reference's interference
primitives, Makefile.common:96-109 / dp.cpp:251-256) on the port's
native binaries — shared by ``examples/congestion_study.py`` and
``examples/pod_study.py --congest`` so the orphan-reaping discipline and
the spawn recipe exist once (the JAX package's ``utils/congest.py``).

A job is one process a rank: over the TCP fabric on the CPU, or with
``backend="nccl"`` over NCCL on the cards, one card a process
(``--procs`` = world; ``cards`` names them, and a world of 1 is one
process on its card).  The default job is JAX's two-rank pair.

A `_loop` job runs forever: callers MUST reap with ``kill_group``
(SIGKILL to the process group — each child gets its own session so a
killed parent still leaves them reapable by group id, never saturating
the host as orphans).
"""
from __future__ import annotations

import os
import signal
import subprocess
import time
from pathlib import Path

from dlnetbench_tpu_torch.utils.net import free_port


def launch_pair(bin_dir: Path, binary: str, model: str, repo: str | Path,
                time_scale: float, size_scale: float,
                extra: list[str] | None = None,
                outs: list[Path] | None = None, backend: str = "tcp",
                world: int = 2, cards: list[int] | None = None,
                env: dict | None = None) -> list[subprocess.Popen]:
    """A ``world``-rank job of ``binary``, one process a rank, each in a
    process group of its own.  No bind-retry here — use
    ``launch_pair_retry`` for long-lived congestors where a TOCTOU port
    steal must not abort the caller."""
    if backend not in ("tcp", "nccl"):
        raise ValueError(f"backend {backend!r}: tcp | nccl")
    if backend == "nccl" and cards is not None and len(cards) < world:
        raise ValueError(f"{world} ranks need {world} cards, got {cards}")
    port = free_port()
    procs = []
    for r in range(world):
        argv = [str(bin_dir / binary), "--model", model,
                "--world", str(world), "--backend", backend,
                "--time_scale", str(time_scale),
                "--size_scale", str(size_scale),
                "--no_topology", "--base_path", str(repo)]
        if world > 1:
            argv += ["--rank", str(r), "--coordinator", f"127.0.0.1:{port}"]
            if backend == "nccl":
                argv += ["--procs", str(world)]
        if backend == "nccl" and cards is not None:
            argv += ["--devices", str(cards[r])]
        argv += list(extra or [])
        if outs is not None:
            argv += ["--out", str(outs[r])]
        procs.append(subprocess.Popen(
            argv, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True, env=env))
    return procs


def launch_pair_retry(bin_dir: Path, binary: str, model: str,
                      repo: str | Path, time_scale: float,
                      size_scale: float, extra: list[str] | None = None,
                      attempts: int = 3, settle_s: float = 1.0,
                      **job) -> list[subprocess.Popen]:
    """``launch_pair`` with the repo's fresh-port retry discipline (the
    probed port can be stolen before rank 0 binds it — TOCTOU): give the
    job ``settle_s`` to come up; if a process died, reap them all and
    retry on a new port.  ``job``: ``launch_pair``'s backend, world,
    cards and env."""
    last: list[subprocess.Popen] = []
    for _ in range(attempts):
        procs = launch_pair(bin_dir, binary, model, repo, time_scale,
                            size_scale, extra, **job)
        time.sleep(settle_s)
        if all(p.poll() is None for p in procs):
            return procs
        kill_group(procs)
        last = procs
    raise RuntimeError(
        f"{binary} job died during startup {attempts} times "
        f"(rcs {[p.returncode for p in last]})")


def kill_group(procs: list[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        p.wait()
