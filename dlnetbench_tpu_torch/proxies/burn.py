"""Calibrated on-device compute burn — the reference's ``usleep`` made
into device work (reference cpp/data_parallel/dp.cpp:93, 98; the JAX
package's ``proxies/burn.py``).

A host sleep between collective launches would put the host on the
critical path and stop the collectives overlapping the compute the
benchmark exists to measure.  The burn instead keeps the device busy
with a strictly sequential chain on a small matrix:

    state <- tanh(state @ state / n)      x iters

with the JAX package's rounding: the product summed in f32, scaled and
passed through ``tanh`` in f32, then rounded to the bf16 state.  One
iteration is three launches (a cast to f32, one ``addmm`` with the
scale as alpha, ``tanh`` written into the bf16 state), a few
microseconds each: issued eagerly from Python, the host would be slower
than the card.

The product is an f32 GEMM, on the CUDA cores, where JAX's runs on the
matrix unit.  A bf16 product with an f32 output (the tensor cores; the
same sums) was measured against it on an H100 by
``python -m dlnetbench_tpu_torch.burn_probe``: 2.5x fewer ns an
iteration, but its cost an iteration differs between graph sizes by up
to 7 %, so the calibration misses long burns, and its two speed modes
lie 8 % apart against the f32 form's 5.5 %.  What the burn must give is
a calibrated time, so it keeps the f32 form.  On the card the chain is therefore captured as CUDA
graphs on the current stream: one graph of ``CHUNK`` iterations,
replayed ``iters // CHUNK`` times, and one graph for each remainder, so
a burn of any length is a handful of graph launches and no graph grows
past ``CHUNK`` iterations.  Collectives stay outside the graphs.  On the
CPU the same three ops run eagerly.

The per-iteration cost is calibrated once per (shape, dtype, device
name) by differencing two trip counts, so launch overheads cancel, and
any microsecond budget maps to a trip count (``BurnCalibration``).  On
the card each trip count is timed as ``CAL_REPLAYS`` back-to-back calls
between two CUDA events on a card the host synchronised, with nothing
queued before them: the host's launch cost of a graph (which grows with
its nodes, and more so after a ``torch.profiler`` session) enters only
the first call, whose graph runs for hundreds of microseconds while the
host queues the rest; on the CPU each call is timed fenced.

The card's chain runs at one of two speed levels about 5.5 % apart, and
the level can change in the middle of a calibration.  So the card times
the two trip counts in alternation, as pairs, takes the median of the
pairs' slopes, and holds it against a long chain timed just before and
just after; it measures again (``CAL_TRIES`` times at most) until all
three agree within ``CAL_AGREE``, which makes it a calibration of the
level in force rather than a mix of two.

On a traced run (``metrics/spans.py``) each graph capture is a
``compile`` span (``what="cuda_graph"``) and each calibration a
``calibrate`` span, where the JAX package's executor compiles and its
burn calibrates.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
from pathlib import Path

import torch

from dlnetbench_tpu_torch.metrics import spans
from dlnetbench_tpu_torch.utils.timing import time_callable

DEFAULT_SHAPE = (256, 256)
DEFAULT_DTYPE = torch.bfloat16
CHUNK = 512          # iterations in the replayed graph
CAL_ITERS = (64, 256)
CAL_REPLAYS = 16     # back-to-back calls a card timing averages
CAL_PAIRS = 5        # (lo, hi) timings in alternation, a try
CAL_LONG = 4 * CHUNK  # the long chain a try's slope is held against
CAL_LONG_REPLAYS = 4
CAL_AGREE = 0.02     # the slope within 2 % of the chain before and after
CAL_TRIES = 6
# the persisted key of a card's calibration names its method: a value
# timed another way (fenced single launches, or the two trip counts one
# after the other) is never reused
CARD_METHOD = "paired"
ENV_CACHE_DIR = "DLNB_COMPILE_CACHE_DIR"


def make_state(shape=DEFAULT_SHAPE, dtype=DEFAULT_DTYPE,
               device="cpu") -> torch.Tensor:
    """Deterministic, well-conditioned initial state in (-1, 1) — made on
    the CPU, so every device starts from the same bits."""
    n, m = shape
    i = torch.arange(n, dtype=torch.float32)[:, None]
    j = torch.arange(m, dtype=torch.float32)[None, :]
    return (torch.sin(i * 0.7 + j * 1.3).to(dtype) * 0.5).to(device)


class Burner:
    """The burn chain on one device: the state, its f32 scratch and, on
    the card, the captured graphs (by trip count)."""

    def __init__(self, device, shape=DEFAULT_SHAPE, dtype=DEFAULT_DTYPE):
        self.device = torch.device(device)
        self.state = make_state(shape, dtype, self.device)
        self._x = torch.empty(shape, dtype=torch.float32,
                              device=self.device)
        self._p = torch.zeros(shape, dtype=torch.float32,
                              device=self.device)
        self._scale = 1.0 / shape[-1]
        self._graphs = {}

    def _iteration(self) -> None:
        self._x.copy_(self.state)
        self._p.addmm_(self._x, self._x, beta=0.0, alpha=self._scale)
        torch.tanh(self._p, out=self.state)

    def eager(self, iters: int) -> None:
        for _ in range(iters):
            self._iteration()

    def _graph(self, iters: int):
        g = self._graphs.get(iters)
        if g is None:
            with spans.span("compile", what="cuda_graph", iters=iters):
                g = self._capture(iters)
            self._graphs[iters] = g
        return g

    def _capture(self, iters: int):
        # warm the library handles on a side stream, then put the state
        # back: a replay must continue the chain where it was
        saved = self.state.clone()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._iteration()
            self.state.copy_(saved)
        torch.cuda.current_stream(self.device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        # thread_local: NCCL's watchdog thread may query its events
        # while this thread captures
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            self.eager(iters)
        return g

    def __call__(self, iters: int) -> None:
        """Advance the chain ``iters`` times on the current stream."""
        if iters <= 0:
            return
        if self.device.type != "cuda":
            self.eager(iters)
            return
        full, rem = divmod(iters, CHUNK)
        if full:
            g = self._graph(CHUNK)
            for _ in range(full):
                g.replay()
        if rem:
            self._graph(rem).replay()


@dataclasses.dataclass(frozen=True)
class BurnCalibration:
    ns_per_iter: float
    shape: tuple
    dtype: str
    device_kind: str

    def iters_for_us(self, us: float) -> int:
        if us <= 0:
            return 0
        return max(1, round(us * 1000.0 / self.ns_per_iter))

    def us_for_iters(self, iters: int) -> float:
        return iters * self.ns_per_iter / 1000.0


def plan(cal: BurnCalibration, iters: int) -> dict:
    """A step's burn as a record states it: the calibration and the µs
    its ``iters`` iterations should take, against which the measured
    compute leg shows the burn's drift."""
    return {"ns_per_iter": cal.ns_per_iter, "iters": iters,
            "planned_us": cal.us_for_iters(iters)}


def device_kind(device) -> str:
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _replayed_s(burner: Burner, iters: int, reps: int,
                replays: int = CAL_REPLAYS) -> float:
    """Seconds of one ``burner(iters)`` on the card: the least, over
    ``reps`` timings, of ``replays`` back-to-back calls between two
    CUDA events, over ``replays``.  Nothing is queued before the start
    event: the chain starts on an idle card, as the card case's long
    chain does (queue 3 (a) of ROADMAP.md: the level a chain runs at
    follows what ran before it)."""
    dev = burner.device
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(replays):
            burner(iters)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3 / replays)
    return best


def _paired_ns(timed) -> float:
    """ns an iteration from ``timed(iters, replays)`` (seconds a call):
    each try takes the median slope of ``CAL_PAIRS`` (lo, hi) timings in
    alternation and keeps it when it lies within ``CAL_AGREE`` of a long
    chain's ns an iteration timed before and after the pairs, so no
    speed switch fell inside the try; after ``CAL_TRIES`` tries without
    that, the last long chain's figure (the level in force last)."""
    n_lo, n_hi = CAL_ITERS

    def chain_ns():
        return timed(CAL_LONG, CAL_LONG_REPLAYS) * 1e9 / CAL_LONG

    for _ in range(CAL_TRIES):
        before = chain_ns()
        slopes = []
        for _ in range(CAL_PAIRS):
            t_lo = timed(n_lo, CAL_REPLAYS)
            t_hi = timed(n_hi, CAL_REPLAYS)
            slopes.append((t_hi - t_lo) * 1e9 / (n_hi - n_lo))
        ns = statistics.median(slopes)
        after = chain_ns()
        if all(abs(ns / c - 1.0) <= CAL_AGREE for c in (before, after)):
            return ns
    return after


def _timed_s(burner: Burner, iters: int, reps: int) -> float:
    return min(time_callable(burner, iters, reps=reps,
                             device=burner.device))


def _measure(burner: Burner, kind: str) -> BurnCalibration:
    n_lo, n_hi = CAL_ITERS
    burner(n_lo)                      # capture both graphs, warm
    burner(n_hi)
    if burner.device.type == "cuda":
        burner(CAL_LONG)
        ns = _paired_ns(lambda iters, replays: _replayed_s(
            burner, iters, 1, replays))
    else:
        t_lo = _timed_s(burner, n_lo, 5)
        t_hi = _timed_s(burner, n_hi, 5)
        ns = (t_hi - t_lo) * 1e9 / (n_hi - n_lo)
        if ns <= 0:                   # timer noise: widen the gap
            t_hi = _timed_s(burner, n_hi * 8, 3)
            ns = max((t_hi - t_lo) * 1e9 / (n_hi * 8 - n_lo), 1.0)
    return BurnCalibration(ns_per_iter=ns,
                           shape=tuple(burner.state.shape),
                           dtype=str(burner.state.dtype).split(".")[-1],
                           device_kind=kind)


_CAL_CACHE: dict = {}


def _persist_path() -> Path | None:
    d = os.environ.get(ENV_CACHE_DIR)
    return Path(d) / "burn_calibration.json" if d else None


def _persist_key(key) -> str:
    """The calibration's key in the persisted file: (shape, dtype,
    device name), and on a card the timing method."""
    parts = list(map(str, key))
    if key[2] != "cpu":
        parts.append(CARD_METHOD)
    return ":".join(parts)


def _load_persisted(path: Path, key) -> BurnCalibration | None:
    try:
        entry = json.loads(path.read_text())[_persist_key(key)]
        return BurnCalibration(ns_per_iter=float(entry), shape=key[0],
                               dtype=key[1], device_kind=key[2])
    except (OSError, KeyError, TypeError, ValueError):
        return None


def _store_persisted(path: Path, key, cal: BurnCalibration) -> None:
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        try:
            data = json.loads(path.read_text())
        except (OSError, ValueError):
            data = {}
        if not isinstance(data, dict):
            data = {}
        data[_persist_key(key)] = cal.ns_per_iter
        tmp = path.with_suffix(f".{os.getpid()}-{os.urandom(4).hex()}.tmp")
        tmp.write_text(json.dumps(data))
        tmp.replace(path)             # readers never see a torn file
    except OSError:
        pass                          # persistence is an optimization


def calibrate(burner: Burner) -> BurnCalibration:
    """ns per iteration of ``burner``'s chain on its device, cached in
    the process per (shape, dtype, device name) and, when
    ``DLNB_COMPILE_CACHE_DIR`` is set, persisted there."""
    with spans.span("calibrate", what="burn"):
        return _calibrated(burner)


def _calibrated(burner: Burner) -> BurnCalibration:
    kind = device_kind(burner.device)
    key = (tuple(burner.state.shape),
           str(burner.state.dtype).split(".")[-1], kind)
    if key not in _CAL_CACHE:
        persist = _persist_path()
        cal = _load_persisted(persist, key) if persist else None
        if cal is None:
            cal = _measure(burner, kind)
            if persist:
                _store_persisted(persist, key, cal)
        _CAL_CACHE[key] = cal
    return _CAL_CACHE[key]
