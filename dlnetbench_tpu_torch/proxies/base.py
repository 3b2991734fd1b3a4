"""Proxy harness: warmup, run estimation, timed runs, loop mode (the JAX
package's ``proxies/base.py``; reference cpp/data_parallel/dp.cpp
:234-264):

  barrier -> warmup (default 3) -> [runs estimated from the warmup
  times, skipping the first 2, when min_exectime is set] -> timed runs
  (default 5) -> emit.

Each proxy builds up to three variants of its step:

  full      the real schedule (compute overlapped with collectives)
  compute   the collectives stripped (burns only)
  comm      the compute stripped (collectives only)

timed whole, fenced on the rank's device.  Then

  runtime        = t(full)
  exposed comm   = max(0, t(full) - t(compute))   the reference's
                   "barrier" timer (dp.cpp:191), from a compute sample
                   taken right after its full sample
  wire comm      = t(comm)
  overlap        = (t(compute) + t(comm) - t(full)) / min(...)
                   (metrics/stats.overlap_fraction)

Besides its timers each rank keeps its bundle's ``rank_meta``: the
proxy's burn calibration and plan (``burn``: ns an iteration and the µs
a compute-only step should take) and, where the energy sampler reads
the card's state (NVML), the card's SM clock and power draw read after
each full and each compute chain (``card_state``), so a compute leg
that drifts from its plan can be told apart from a clock that moved.
Its values are dicts, from which the JAX package's parser makes no
column.

On a traced run (``metrics/spans.py``) the phases are spans —
``warmup``, ``calibrate`` (the energy sampler) and ``timed`` (one per
variant: ``full+compute``, ``comm``, each named variant) — and with
the flight recorder on (``metrics/telemetry.py``) every warmup sample
and every fenced full chain is a ring sample (``phase``,
``step_wall_us``, ``chain_k``, ``compute_us``, ``energy_j``, and the
card's ``sm_clock_mhz`` / ``power_w`` where the sampler reads them),
indexed by harness step (warmup included), and each chain's wall
feeds the step-time change detector.

A fault plan (``ProxyConfig.fault_injector``, ``faults/inject.py``)
wraps the FULL step, so its sleeps land inside every timed window,
warmup included, and its triggers count every harness step; the
compute and comm legs stay clean.  The injected delay of each chain,
per iteration, is the ``fault_delay_us`` timer and the ring's
``fault_delay_us`` field: at world > 1 the largest over the ranks,
since the step's collectives wait for the slowest.  A
``ProxyConfig.watchdog`` (``utils/watchdog.py``) is armed around every
fenced full chain, beats ``warmup`` and ``chain_<i>``, and stamps the
heartbeat ages into the record (``watchdog_heartbeat_age_s``).

Every rank runs this loop on its own device and keeps its own timers
(the reference's per-rank arrays); the run count is agreed across ranks,
since every step holds collectives.  Loop mode (reference
``-DPROXY_LOOP``, dp.cpp:251-256) runs the full step forever.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable

from dlnetbench_tpu_torch.metrics import energy, spans, telemetry
from dlnetbench_tpu_torch.metrics.stats import overlap_fraction
from dlnetbench_tpu_torch.parallel import multihost
from dlnetbench_tpu_torch.utils import timing

DEFAULT_WARMUP = 3   # reference dp.cpp:65
DEFAULT_RUNS = 5     # reference dp.cpp:66


@dataclasses.dataclass
class ProxyConfig:
    warmup: int = DEFAULT_WARMUP
    runs: int = DEFAULT_RUNS
    min_exectime_s: float = 0.0    # reference -m flag -> estimate_runs
    loop: bool = False             # reference PROXY_LOOP
    size_scale: float = 1.0        # shrink buffers for small runs
    time_scale: float = 1.0        # shrink burn durations for small runs
    # K step calls per fence: the fence's host cost is paid once per K
    # iterations (utils/timing.time_chain); 1 = the reference's
    reps_per_fence: int = 1
    # faults.inject.FaultInjector (or None): step-boundary injection
    # around the FULL step only (the compute/comm legs are the clean
    # decomposition baseline)
    fault_injector: object | None = None
    # utils.watchdog.StepWatchdog (or None): armed around every fenced
    # full chain; its heartbeat ages are stamped into the record
    watchdog: object | None = None


@dataclasses.dataclass
class StepBundle:
    """What a proxy's ``build()`` returns."""
    full: Callable          # () -> None, issues one step on the device
    compute: Callable | None
    comm: Callable | None
    global_meta: dict       # model/grid/message-size metadata
    device: object = None   # the rank's torch.device
    # comm-only sub-schedules timed into "<name>_time" (reference
    # fsdp.cpp:61-66 allgather / reduce_scatter timers)
    variants: dict | None = None
    # this rank's own facts, beside its timers in the record
    rank_meta: dict = dataclasses.field(default_factory=dict)
    # the proxy's buffers as a pytree, for the checkpoint path
    # (faults/policy.py + utils/checkpoint.SnapshotCheckpointer): the
    # bytes a training state of this proxy's size moves.  None: the
    # proxy declares none, and checkpointing it is refused.
    state: object | None = None


@dataclasses.dataclass
class ProxyResult:
    name: str
    global_meta: dict
    timers_us: dict          # timer name -> list of per-iteration values
    warmup_times_us: list
    num_runs: int


def estimate_runs(warmup_times_s: list[float], min_exectime_s: float,
                  skip: int = 2) -> int:
    """Runs needed for the measured time to reach ``min_exectime_s``,
    from the mean warmup iteration past the first ``skip`` (reference
    cpp/utils.hpp:121-135, its intent rather than its
    divide-by-the-wrong-count)."""
    usable = warmup_times_s[skip:] or warmup_times_s[-1:]
    mean = sum(usable) / len(usable)
    if mean <= 0:
        return 1
    return max(1, math.ceil(min_exectime_s / mean))


def _chain_sizes(runs: int, k: int) -> list[int]:
    """Partition ``runs`` iterations into fence chains of at most ``k``."""
    if k <= 1:
        return [1] * runs
    sizes = [k] * (runs // k)
    if runs % k:
        sizes.append(runs % k)
    return sizes


def _sample_chain(step: int, k: int, full_s: float, comp_s: list,
                  energy_j: list, states: list, fault_us: list) -> None:
    """One flight-ring sample for the fenced full chain just timed:
    its per-iteration wall beside the matched compute leg, the energy
    and the card's state read after it; then the step-time detector."""
    fields = {"phase": "timed", "step_wall_us": round(full_s * 1e6, 1),
              "chain_k": k}
    if comp_s:
        fields["compute_us"] = round(comp_s[-1] * 1e6, 1)
    if energy_j:
        fields["energy_j"] = round(energy_j[-1], 6)
    if states:
        fields["sm_clock_mhz"] = states[-1]["sm_clock_mhz"]
        fields["power_w"] = states[-1]["power_w"]
    if fault_us:
        fields["fault_delay_us"] = round(fault_us[-1], 1)
    telemetry.record_step("proxy", step=step, **fields)
    telemetry.observe_step_wall("proxy", full_s * 1e6, step=step)


def _full_step(bundle: StepBundle, injector):
    """The full step, after the injector's step faults when there is
    one: its sleeps land inside the timed window."""
    if injector is None:
        return bundle.full
    base_full = bundle.full

    def full_step():
        injector.before_step()
        return base_full()
    return full_step


def run_proxy(name: str, bundle: StepBundle, cfg: ProxyConfig,
              energy_sampler=None) -> ProxyResult:
    dev = bundle.device
    injector, wd = cfg.fault_injector, cfg.watchdog
    full_step = _full_step(bundle, injector)
    multihost.barrier(dev)                        # reference dp.cpp:234
    warmup = max(cfg.warmup, 1)
    with spans.span("warmup", proxy=name, reps=warmup):
        warmup_s = timing.time_callable(full_step, reps=warmup,
                                        device=dev)
    if wd is not None:
        wd.beat("warmup")
    if telemetry.is_enabled():
        # a fresh run over a live recorder re-baselines the step-time
        # detector (an in-process sweep's next point is not an anomaly
        # against the previous point's walls)
        telemetry.current().reset_walls("proxy")
        for w, t in enumerate(warmup_s):
            telemetry.record_step("proxy", step=w, phase="warmup",
                                  step_wall_us=round(t * 1e6, 1))
    runs = cfg.runs
    if cfg.min_exectime_s > 0:
        # every step holds collectives: all ranks run the same count
        runs = max(multihost.all_ranks(
            estimate_runs(warmup_s, cfg.min_exectime_s)))

    if cfg.loop:                                  # reference PROXY_LOOP
        while True:
            full_step()

    if energy_sampler is None:            # reference PROXY_ENERGY_PROFILING
        with spans.span("calibrate", what="energy_sampler"):
            energy_sampler = energy.detect_sampler(dev)
    if energy_sampler is not None:
        bundle.global_meta["energy_source"] = getattr(
            energy_sampler, "source", type(energy_sampler).__name__)

    # Interleaved A/B: each full chain is followed by a compute-only
    # chain, so barrier_time[i] = full[i] - compute[i] subtracts a
    # matched sample and run-to-run drift cannot leak into it.
    measure_compute = bundle.compute is not None
    if measure_compute:
        with spans.span("warmup", proxy=name, variant="compute"):
            timing.time_callable(bundle.compute, reps=1, device=dev)
    k_max = max(cfg.reps_per_fence, 1)
    chains = _chain_sizes(runs, k_max)
    bundle.global_meta["reps_per_fence"] = k_max
    bundle.global_meta["host_rtt_us"] = round(
        timing.fence_rtt_s(dev) * 1e6, 1)

    timers: dict[str, list] = {}
    full_s, comp_s, energy_j, fault_us = [], [], [], []
    read_state = getattr(energy_sampler, "read_state", None)
    states: dict[str, list] = {"": [], "compute_": []}
    with spans.span("timed", proxy=name, variant="full+compute",
                    runs=runs, chains=len(chains)):
        for ci, k in enumerate(chains):
            # energy brackets the fenced full chain only, per iteration
            if energy_sampler is not None:
                e0 = energy_sampler.read_joules()
            inj0 = injector.injected_delay_us if injector is not None else 0.0
            if wd is not None:
                with wd:
                    full_s.append(timing.time_chain(full_step, k=k,
                                                    device=dev))
                wd.beat(f"chain_{ci}")
            else:
                full_s.append(timing.time_chain(full_step, k=k,
                                                device=dev))
            if injector is not None:
                fault_us.append((injector.injected_delay_us - inj0) / k)
            if energy_sampler is not None:
                energy_j.append(
                    max(0.0, energy_sampler.read_joules() - e0) / k)
            if read_state is not None:
                states[""].append(read_state())
            if measure_compute:
                comp_s.append(timing.time_chain(bundle.compute, k=k,
                                                device=dev))
                if read_state is not None:
                    states["compute_"].append(read_state())
            if telemetry.is_enabled():
                _sample_chain(warmup + sum(chains[:ci]) + k - 1, k,
                              full_s[-1], comp_s, energy_j, states[""],
                              fault_us)
    timers["runtimes"] = [t * 1e6 for t in full_s]
    if injector is not None:
        # the step waits for its slowest rank: each chain's injected
        # delay is the largest any rank slept
        per_rank = multihost.all_ranks(fault_us)
        timers["fault_delay_us"] = [round(max(v), 1)
                                    for v in zip(*per_rank)]
    if energy_sampler is not None:
        timers["energy_consumed"] = energy_j
        energy.close_sampler(energy_sampler)
    if read_state is not None:
        bundle.rank_meta["card_state"] = {
            prefix + key: [st[key] for st in seen]
            for prefix, seen in states.items() if seen
            for key in ("sm_clock_mhz", "power_w")}
    if measure_compute:
        timers["compute_time"] = [t * 1e6 for t in comp_s]
        timers["barrier_time"] = [max(0.0, f - c) * 1e6
                                  for f, c in zip(full_s, comp_s)]

    if bundle.comm is not None:
        with spans.span("timed", proxy=name, variant="comm"):
            timing.time_callable(bundle.comm, reps=1, device=dev)
            comm_s = [timing.time_chain(bundle.comm, k=k, device=dev)
                      for k in chains]
        timers["comm_time"] = [t * 1e6 for t in comm_s]
        if measure_compute:
            timers["overlap_fraction"] = [
                round(v, 4) for v in overlap_fraction(full_s, comp_s,
                                                      comm_s)]

    if bundle.variants:
        for vname, vfn in bundle.variants.items():
            with spans.span("timed", proxy=name, variant=vname):
                timing.time_callable(vfn, reps=1, device=dev)
                v_s = [timing.time_chain(vfn, k=k, device=dev)
                       for k in chains]
            timers[f"{vname}_time"] = [t * 1e6 for t in v_s]

    if wd is not None:
        wd.stamp(bundle.global_meta)
    return ProxyResult(
        name=name,
        global_meta=bundle.global_meta,
        timers_us=timers,
        warmup_times_us=[t * 1e6 for t in warmup_s],
        num_runs=runs,
    )
