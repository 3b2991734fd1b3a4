"""The proxies' compute burn on a card, timed chain by chain beside the
card's state: what moves the compute leg away from its calibration.

    python -m dlnetbench_tpu_torch.burn_probe [--chains 16] [--proxies 8]
        [--after-profiler] [--out burn_probe.jsonl]

For each form of the chain (``cuda_cores``: the proxies' burn, the
state copied to f32 and an f32 product; ``tensor``: a bf16 product with
an f32 output, on the tensor cores) it prints, one JSON line each:

  * ``calibration``: 8 fresh calibrations (ns an iteration, by the
    burn's own differencing of two trip counts);
  * ``graph``: ns an iteration inside the replayed graph of each size
    (64, 256 and ``CHUNK`` iterations), replayed for about 100 ms;
  * ``chain``: the compute leg of ``llama3_8b_16_bfloat16`` at time
    scale 0.05 (what ``chip_smoke.py``'s proxy phase burns), timed
    ``--chains`` times, in turns whole and in DP's pieces (the forward,
    then 8 buckets), with an idle gap of 0.5 s before every other
    pair: host ms, the ratio to the planned time and to the
    calibration, and the card's SM and memory clocks, power,
    temperature and NVML's clock-event reasons read in the middle of
    the chain, and the mean power from the energy counter;
  * ``energy_counter``: the intervals between updates of NVML's energy
    counter, polled through one leg;
  * ``burner``: the whole leg three times on each of 6 fresh burners.

With ``--proxies`` it then builds the DP (8 buckets) and FSDP (8 units)
proxies at world 1, bf16 buffers at full size, once on each form, and
times their full and compute-only steps in turns (``proxy`` lines, the
same fields), beside the proxy's own calibration.

With ``--after-profiler`` it then runs one ``torch.profiler`` session
(CPU and CUDA activities) over a burn and measures the proxies' form
again: its ``calibration`` and ``graph`` lines, and with ``--proxies``
its DP and FSDP steps, each tagged ``"after_profiler": true`` (a
session earlier in the process slows each graph launch on the host; the
calibration times back-to-back replays, which hide that cost, and the
compute legs show whether it still follows the chain).

It needs a card (NVML through ``libnvidia-ml.so.1``) and imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from dlnetbench_tpu_torch.core.model_stats import load_model_stats
from dlnetbench_tpu_torch.metrics.energy import NvmlSampler
from dlnetbench_tpu_torch.proxies import burn as burnlib

NVML_CLOCK_MEM = 2
NVML_TEMPERATURE_GPU = 0
MODEL = "llama3_8b_16_bfloat16"    # chip_smoke.py's proxy phase
TIME_SCALE = 0.05
GAP_S = 0.5
CAL_REPS = 8


class _TensorCoreBurner(burnlib.Burner):
    """The chain with a bf16 product and an f32 output, on the tensor
    cores (the same sums: bf16 products are exact in f32): two launches
    an iteration."""

    def _iteration(self) -> None:
        torch.addmm(self._p, self.state, self.state,
                    out_dtype=torch.float32, beta=0.0, alpha=self._scale,
                    out=self._p)
        torch.tanh(self._p, out=self.state)


class _CardState:
    """NVML reads beyond the energy sampler's: memory clock,
    temperature and the clock-event reasons bitmask."""

    def __init__(self, sampler: NvmlSampler):
        self.s = sampler
        lib, h = sampler._lib, sampler._handle
        self._h = h
        lib.nvmlDeviceGetTemperature.argtypes = [
            ctypes.c_void_p, ctypes.c_uint, ctypes.POINTER(ctypes.c_uint)]
        self._reasons = getattr(lib, "nvmlDeviceGetCurrentClocksEventReasons",
                                None) or \
            lib.nvmlDeviceGetCurrentClocksThrottleReasons
        self._reasons.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_ulonglong)]
        self._lib = lib

    def read(self) -> dict:
        out = self.s.read_state()
        mem, temp = ctypes.c_uint(), ctypes.c_uint()
        bits = ctypes.c_ulonglong()
        lib = self._lib
        out["mem_clock_mhz"] = mem.value if lib.nvmlDeviceGetClockInfo(
            self._h, ctypes.c_uint(NVML_CLOCK_MEM), ctypes.byref(mem)) == 0 \
            else None
        out["temp_c"] = temp.value if lib.nvmlDeviceGetTemperature(
            self._h, ctypes.c_uint(NVML_TEMPERATURE_GPU),
            ctypes.byref(temp)) == 0 else None
        out["reasons"] = hex(bits.value) if self._reasons(
            self._h, ctypes.byref(bits)) == 0 else None
        return out


def _graph_ns(burner, n: int, budget_s: float = 0.1) -> float:
    burner(n)                                     # capture
    reps = max(1, round(budget_s * 1e9 / (n * 12e3)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        burner(n)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e9 / (reps * n)


def _timed(fn, state: _CardState, half_s: float) -> tuple:
    """Host seconds of ``fn()`` fenced, the energy it took and the card's
    state read halfway through."""
    torch.cuda.synchronize()
    e0 = state.s.read_joules()
    t0 = time.perf_counter()
    fn()
    time.sleep(max(0.0, half_s - (time.perf_counter() - t0)))
    mid = state.read()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    return host, state.s.read_joules() - e0, mid


def probe_calibration(form: str, burner, emit) -> list[float]:
    """The ``calibration`` and ``graph`` lines of ``burner``; returns the
    calibrations."""
    kind = burnlib.device_kind(burner.device)
    cals = [burnlib._measure(burner, kind).ns_per_iter
            for _ in range(CAL_REPS)]
    emit({"form": form, "what": "calibration", "ns_per_iter": cals})
    emit({"form": form, "what": "graph", "ns_per_iter": {
        n: round(_graph_ns(burner, n), 1)
        for n in (64, 256, burnlib.CHUNK)}})
    return cals


def profiler_session(device) -> None:
    """One torch.profiler session (CPU and CUDA) over a 4096-iteration
    burn on a burner of its own."""
    from torch.profiler import ProfilerActivity, profile
    burner = burnlib.Burner(device)
    burner(4096)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        burner(4096)
        torch.cuda.synchronize()


def probe(form: str, make, device, state: _CardState, stats, chains: int,
          emit) -> None:
    leg_us = (stats.fwd_us + stats.bwd_us) * TIME_SCALE
    burner = make(device)
    ns = statistics.median(probe_calibration(form, burner, emit))
    # the leg whole, or in DP's pieces: the forward and 8 buckets
    fwd = max(1, round(stats.fwd_us * TIME_SCALE * 1e3 / ns))
    bwd = max(1, round(stats.bwd_us * TIME_SCALE * 1e3 / (8 * ns)))
    pieces = [fwd] + [bwd] * 8

    def run(split):
        for n in (pieces if split else [sum(pieces)]):
            burner(n)

    run(False)                                    # capture the graphs
    run(True)
    for i in range(chains):
        split, gap = bool(i % 2), GAP_S if i % 4 >= 2 else 0.0
        time.sleep(gap)
        host, joules, mid = _timed(lambda: run(split), state,
                                   leg_us * 0.5e-6)
        emit({"form": form, "what": "chain", "chain": i, "split": split,
              "gap_s": gap, "host_ms": round(host * 1e3, 3),
              "ratio": round(host * 1e6 / leg_us, 4),
              "ratio_to_calibration": round(
                  host * 1e9 / (sum(pieces) * ns), 4),
              "mean_power_w": round(joules / host, 1), **mid})
    # the energy counter's update period: polled through one leg
    done = torch.cuda.Event()
    run(False)
    done.record()
    seen = [(time.perf_counter(), state.s.read_joules())]
    while not done.query():
        j = state.s.read_joules()
        if j != seen[-1][1]:
            seen.append((time.perf_counter(), j))
        time.sleep(1e-4)
    gaps = [round((b[0] - a[0]) * 1e3, 2) for a, b in zip(seen[1:],
                                                         seen[2:])]
    emit({"form": form, "what": "energy_counter", "updates": len(seen) - 1,
          "period_ms": statistics.median(gaps) if gaps else None,
          "periods_ms": gaps})
    # fresh burners
    for b in range(6):
        other = make(device)
        other(sum(pieces))
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            other(sum(pieces))
            torch.cuda.synchronize()
            times.append(round((time.perf_counter() - t0) * 1e6 / leg_us,
                               4))
        emit({"form": form, "what": "burner", "burner": b,
              "state_ptr": hex(other.state.data_ptr()), "ratio": times})
        del other


def probe_proxies(form: str, make, state: _CardState, stats, reps: int,
                  emit) -> None:
    from dlnetbench_tpu_torch.parallel import multihost
    from dlnetbench_tpu_torch.parallel.mesh import make_flat_mesh
    from dlnetbench_tpu_torch.proxies import dp, fsdp
    from dlnetbench_tpu_torch.proxies.base import ProxyConfig
    device = multihost.initialize("cuda")
    want_us = (stats.fwd_us + stats.bwd_us) * TIME_SCALE
    cfg = ProxyConfig(time_scale=TIME_SCALE)
    # both forms share the calibration's cache key: measure each afresh
    burnlib._CAL_CACHE.clear()
    shipped, burnlib.Burner = burnlib.Burner, make
    try:
        for proxy in ("dp", "fsdp"):
            bundle = (dp.build(stats, 8, cfg, make_flat_mesh(device),
                               dtype=torch.bfloat16) if proxy == "dp" else
                      fsdp.build(stats, 8, cfg, device,
                                 dtype=torch.bfloat16))
            for i in range(reps):
                for leg, fn in (("full", bundle.full),
                                ("compute", bundle.compute)):
                    host, joules, mid = _timed(fn, state, want_us * 0.5e-6)
                    emit({"form": form, "what": "proxy", "proxy": proxy,
                          "leg": leg, "rep": i,
                          "ns_per_iter": bundle.global_meta[
                              "burn_ns_per_iter"],
                          "host_ms": round(host * 1e3, 3),
                          "ratio": round(host * 1e6 / want_us, 4),
                          "mean_power_w": round(joules / host, 1), **mid})
            del bundle
            torch.cuda.empty_cache()
    finally:
        burnlib.Burner = shipped
        burnlib._CAL_CACHE.clear()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dlnetbench_tpu_torch.burn_probe")
    p.add_argument("--chains", type=int, default=16)
    p.add_argument("--proxies", type=int, default=0, metavar="REPS",
                   help="also time DP and FSDP steps, REPS turns each")
    p.add_argument("--after-profiler", action="store_true",
                   help="then measure the proxies' form again after one "
                        "torch.profiler session")
    p.add_argument("--out", default=None, help="also append the lines here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("needs a CUDA card")
    stats = load_model_stats(MODEL)
    leg_us = (stats.fwd_us + stats.bwd_us) * TIME_SCALE
    device = torch.device("cuda", 0)
    sampler = NvmlSampler(0)
    if not sampler.available:
        p.error("NVML cannot read this card")
    state = _CardState(sampler)
    out = Path(args.out) if args.out else None
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            with out.open("a") as f:
                f.write(text + "\n")

    emit({"what": "card", "name": torch.cuda.get_device_name(device),
          "leg_us": leg_us, "model": MODEL, "time_scale": TIME_SCALE,
          **state.read()})
    for form, make in (("cuda_cores", burnlib.Burner),
                       ("tensor", _TensorCoreBurner)):
        probe(form, make, device, state, stats, args.chains, emit)
    if args.proxies:
        for form, make in (("cuda_cores", burnlib.Burner),
                           ("tensor", _TensorCoreBurner)):
            probe_proxies(form, make, state, stats, args.proxies, emit)
    if args.after_profiler:
        profiler_session(device)

        def emit_after(line):
            emit({**line, "after_profiler": True})
        probe_calibration("cuda_cores", burnlib.Burner(device), emit_after)
        if args.proxies:
            probe_proxies("cuda_cores", burnlib.Burner, state, stats,
                          args.proxies, emit_after)
    if args.proxies:
        from dlnetbench_tpu_torch.parallel import multihost
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
