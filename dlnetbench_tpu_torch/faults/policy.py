"""Degradation policies around ``run_proxy`` (the JAX package's
``faults/policy.py``): the harness that survives a scripted fault and
prices the recovery.

``run_faulted`` drives a proxy bundle under a FaultPlan:

  * fail_fast — delay/jitter inflate the measured steps (the
    ``fault_delay_us`` timer says by how much); a crash propagates as
    RankFailure.
  * retry     — the failure is transient: after a bounded exponential
    backoff the run resumes on the SAME world; ``fault_retries``
    counts the re-issues.
  * shrink    — the run is segmented around the death: the steps
    before it run on the full world, the RankFailure is caught, the
    caller's ``rebuild(survivors)`` builds a bundle over the survivors
    and the remaining steps finish degraded.  ``detection_ms``,
    ``recovery_ms`` (rebuild + restore + the first survivor step) and
    ``degraded_world`` are stamped into the record's globals.
  * checkpoint — ``checkpoint=CheckpointPolicy(dir, every, mode)``
    snapshots ``bundle.state`` every K harness steps
    (``utils/checkpoint.SnapshotCheckpointer``): the save cost is
    measured, and restore-from-latest is priced into ``recovery_ms``.
  * preempt / rejoin — a scripted grace-window eviction: a drain save
    when the measured cost fits the grace window, restore from the
    latest save (``restore_ms``), the redone work (``lost_steps``), a
    degraded segment, and at the plan's ``rejoin`` a rebuild over the
    full world (``rejoin_ms``, ``fault_rejoin_step``) — with
    ``goodput``, useful steps per wall second, as the bottom line.

One process per rank: every rank calls ``run_faulted`` with the same
plan and sees every crash, preempt and partition trigger at the same
step (``faults/inject.py``).  At a shrink the survivors make a group
of their own (``multihost.local_group``: the dead ranks take no part);
they rebuild and run inside it as their world
(``parallel/multihost.subworld``), and each dead rank's process stays a
bystander — it runs no step — until the ranks meet again: at a rejoin,
which rebuilds over the full world, or at the end.  At world > 1 the
record's globals (its measured recovery times, checkpoint counts,
goodput and meta) are those of the lowest rank that ran to the end,
``fault_injected_delay_us`` is the largest any rank slept, and a
rejoined rank's row carries, for the steps it was out, the timers of
the lowest survivor (``rank_meta["fault"]`` says which steps and
whose).

The plan's step counter covers warmup too, so crash triggers must land
in the measured region for the segmented policies
(``FaultPlan.check_config``).
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

from dlnetbench_tpu_torch.faults.inject import (FaultInjector, RankFailure,
                                                RankPreempted)
from dlnetbench_tpu_torch.faults.plan import FaultPlan
from dlnetbench_tpu_torch.metrics import telemetry
from dlnetbench_tpu_torch.parallel import multihost
from dlnetbench_tpu_torch.proxies.base import (ProxyConfig, ProxyResult,
                                               run_proxy)

# bounded backoff for the retry policy (base doubles per attempt)
RETRY_BACKOFF_S = 0.05
MAX_RETRIES = 3


@dataclasses.dataclass
class CheckpointPolicy:
    """How a faulted run checkpoints (utils/checkpoint.py backends)."""
    dir: str | Path
    every: int = 4              # harness steps between saves (plan units)
    mode: str = "async"         # "stall" | "async" (SnapshotCheckpointer)
    backend: str = "auto"       # "dcp" | "npz" | "auto"
    keep: int = 3


def _make_checkpointer(ckpt: CheckpointPolicy, bundle, cfg: ProxyConfig):
    """SnapshotCheckpointer over the bundle's state.  A bundle without
    a declared ``state`` cannot honestly price checkpointing — refused,
    never silently priced at zero bytes."""
    from dlnetbench_tpu_torch.utils.checkpoint import SnapshotCheckpointer
    if bundle.state is None:
        raise ValueError(
            "checkpoint policy: this proxy bundle declares no "
            "checkpointable state (StepBundle.state) — the save cost "
            "would be a lie; wire the proxy's buffers first (see "
            "proxies/dp.py)")
    return SnapshotCheckpointer(
        ckpt.dir, bundle.state, every=ckpt.every, mode=ckpt.mode,
        backend=ckpt.backend, keep=ckpt.keep,
        watchdog=getattr(cfg, "watchdog", None))


def _with_checkpoint_hook(bundle, ckpt_sc, injector: FaultInjector):
    """Wrap the bundle's FULL step so every completed call may trigger
    a periodic save; run_proxy puts the injector around it, so the
    order per call is before_step -> step -> on_step.  Saves land
    inside the timed window on purpose: a stall-mode save inflates the
    step it rode, which is the cost the A/B measures."""
    base_full = bundle.full

    def full_with_save():
        out = base_full()
        # the injector already advanced: the step just run is
        # iteration - 1 (plan units, warmup included)
        ckpt_sc.on_step(injector.iteration - 1)
        return out

    return dataclasses.replace(bundle, full=full_with_save)


def _concat_results(name: str, segments: list[ProxyResult]) -> ProxyResult:
    """Per-iteration timers concatenated across run segments (the keys
    every live segment recorded)."""
    live = [s for s in segments if s.num_runs > 0] or segments[:1]
    keys = set(live[0].timers_us)
    for s in live[1:]:
        keys &= set(s.timers_us)
    timers = {k: [v for s in segments for v in s.timers_us.get(k, [])]
              for k in sorted(keys)}
    return ProxyResult(
        name=name,
        global_meta=segments[-1].global_meta,
        timers_us=timers,
        warmup_times_us=segments[0].warmup_times_us,
        num_runs=sum(s.num_runs for s in segments),
    )


class _Run:
    """This process's view of a faulted run: the world, its rank and
    the ranks that ran to the end."""

    def __init__(self, world: int):
        import torch.distributed as dist
        self.world = world
        self.multi = world > 1 and dist.is_initialized()
        self.rank = dist.get_rank() if self.multi else 0
        self.final = list(range(world or 1))

    def groups(self, ranks: list, with_ckpt: bool):
        """A group over ``ranks`` and, for a checkpointed run, a gloo
        group over them — made by those ranks alone (None on the
        others)."""
        if not self.multi or self.rank not in ranks:
            return None, None
        group = multihost.local_group(ranks)
        ckpt = multihost.local_group(ranks, "gloo") if with_ckpt else None
        return group, ckpt

    def degraded(self, ranks: list, group):
        """A context in which ``ranks`` are the world."""
        import contextlib
        if not self.multi:
            return contextlib.nullcontext()
        return multihost.subworld(ranks, group)

    def adopt(self, result: ProxyResult) -> ProxyResult:
        """Give this rank the globals, run count and warmup of the
        lowest rank that ran to the end (the record's source)."""
        if self.multi:
            src = min(self.final)
            g, n, warm = multihost.all_ranks(
                (result.global_meta, result.num_runs,
                 result.warmup_times_us))[src]
            result.global_meta.clear()
            result.global_meta.update(g)
            result.num_runs, result.warmup_times_us = n, warm
        return result


def _caught(e, injector: FaultInjector, kind: str) -> float:
    """detection_ms of a caught scripted failure; fires the flight
    recorder's ``fault`` trigger (the ring dumps as flight_fault.json)."""
    detection_ms = (time.monotonic() - injector.crash_raised_at) * 1e3
    detail = {"kind": kind, "rank": e.rank, "iteration": e.iteration}
    if kind == "RankPreempted":
        detail["grace_us"] = e.grace_us
    detail["detection_ms"] = round(detection_ms, 3)
    telemetry.trigger("fault", step=e.iteration, detail=detail)
    return detection_ms


def run_faulted(name: str, bundle, cfg: ProxyConfig, plan: FaultPlan, *,
                rebuild=None, world: int | None = None,
                checkpoint: CheckpointPolicy | None = None) -> ProxyResult:
    """Run ``bundle`` under ``plan`` with the plan's policy; returns a
    ProxyResult whose global_meta carries the fault provenance.

    ``rebuild(ranks) -> StepBundle`` is required for the shrink policy
    and the preempt/rejoin arc; it is called inside the survivors'
    sub-world (``rebuild(survivors)``) and over the full world
    (``rebuild(range(world))``).  ``world`` defaults to the bundle's
    ``world_size`` global.  ``checkpoint`` enables the periodic-save /
    restore-from-latest / lost-work pathway.
    """
    plan.validate()
    world = world or int(bundle.global_meta.get("world_size", 0))
    run = _Run(world)
    injector = FaultInjector(plan, world=world or None,
                             rank=run.rank if run.multi else None)
    cfg_i = dataclasses.replace(cfg, fault_injector=injector)
    ckpt_sc = None
    if checkpoint is not None:
        ckpt_sc = _make_checkpointer(checkpoint, bundle, cfg)
        bundle = _with_checkpoint_hook(bundle, ckpt_sc, injector)

    def stamp(result: ProxyResult, **extra) -> ProxyResult:
        g = result.global_meta
        g["fault_plan"] = plan.to_dict()
        g["fault_policy"] = plan.policy
        # ranks sleep in parallel: the world's injected delay is the
        # largest any rank slept
        g["fault_injected_delay_us"] = round(
            max(multihost.all_ranks(injector.injected_delay_us)), 1)
        if ckpt_sc is not None:
            ckpt_sc.wait()  # async writes must complete before stats
            g.update(ckpt_sc.stats())
            if ckpt_sc.checkpoint_ms:
                g["checkpoint_ms_samples"] = [
                    round(v, 3) for v in ckpt_sc.checkpoint_ms]
        g.update(extra)
        return run.adopt(result)

    if plan.first_preempt_iteration() is not None:
        return _run_preempt(name, bundle, cfg, cfg_i, plan, injector,
                            stamp, run, rebuild=rebuild, ckpt_sc=ckpt_sc)

    crash_at = plan.first_crash_iteration()
    if crash_at is None or plan.policy == "fail_fast":
        # nothing to survive: delays ride the samples, crashes propagate
        return stamp(run_proxy(name, bundle, cfg_i))

    warm = max(cfg.warmup, 1)
    plan.check_config(cfg)  # reps_per_fence/min_exectime/warmup guards

    pre = min(cfg.runs, crash_at - warm)
    if pre >= cfg.runs:  # trigger beyond the run: nothing ever fires
        return stamp(run_proxy(name, bundle, cfg_i))

    seg1 = run_proxy(name, bundle,
                     dataclasses.replace(cfg_i, runs=pre, min_exectime_s=0))

    # the scripted death, caught at the policy layer
    try:
        injector.before_step()
        raise RuntimeError("fault plan: crash trigger did not fire at "
                           f"iteration {crash_at}")
    except RankFailure as e:
        failure = e  # survive the except-block name cleanup
        detection_ms = _caught(e, injector, "RankFailure")

    remaining = cfg.runs - pre
    if plan.policy == "retry":
        # transient-failure semantics: bounded backoff, same world
        retries = 0
        t0 = time.monotonic()
        while True:
            retries += 1
            time.sleep(RETRY_BACKOFF_S * (2 ** (retries - 1)))
            try:
                seg2 = run_proxy(name, bundle,
                                 dataclasses.replace(cfg_i, runs=remaining,
                                                     warmup=1,
                                                     min_exectime_s=0))
                break
            except RankFailure:
                if retries >= MAX_RETRIES:
                    raise
        recovery_ms = (time.monotonic() - t0) * 1e3
        return stamp(_concat_results(name, [seg1, seg2]),
                     detection_ms=round(detection_ms, 3),
                     recovery_ms=round(recovery_ms, 3),
                     fault_retries=retries,
                     fault_iteration=failure.iteration)

    # shrink: rebuild over the survivors and finish degraded
    if rebuild is None:
        raise ValueError("fault plan: the shrink policy needs a "
                         "rebuild(survivor_ranks) callback")
    if not world:
        raise ValueError("fault plan: shrink needs the world size "
                         "(bundle.global_meta['world_size'] or world=)")
    survivors = plan.survivors(world)
    if not survivors:
        raise ValueError(f"fault plan: no rank of a world of {world} "
                         f"survives the plan")
    run.final = survivors
    t0 = time.monotonic()
    group, ckpt_group = run.groups(survivors, ckpt_sc is not None)
    segments = [seg1]
    ckpt_extra, recovery_ms = {}, 0.0
    if run.rank in survivors:
        if ckpt_sc is not None:
            # restore-from-latest is part of what the crash costs
            restore_ms, lost = _restore_latest(ckpt_sc, bundle,
                                               failure.iteration, warm,
                                               ckpt_group)
            ckpt_extra = {"restore_ms": round(restore_ms, 3),
                          "lost_steps": lost}
        with run.degraded(survivors, group):
            bundle2 = rebuild(survivors)
            if ckpt_sc is not None:
                bundle2 = _with_checkpoint_hook(bundle2, ckpt_sc, injector)
            rebuild_ms = (time.monotonic() - t0) * 1e3
            seg2 = run_proxy(name, bundle2,
                             dataclasses.replace(cfg_i, runs=remaining,
                                                 warmup=1,
                                                 min_exectime_s=0))
        # recovery ends at the first successful survivor step
        recovery_ms = rebuild_ms + (seg2.warmup_times_us[0] / 1e3
                                    if seg2.warmup_times_us else 0.0)
        segments.append(seg2)
    merged = _concat_results(name, segments)
    # the survivors' globals describe the survivor mesh; the record
    # still declares the ORIGINAL world, with degraded_world naming who
    # is left (emit relabels rank ids); keys stamped onto the original
    # bundle after build (buffer_dtype, sweep tags) carry over
    for k, v in bundle.global_meta.items():
        merged.global_meta.setdefault(k, v)
    merged.global_meta["world_size"] = world
    return stamp(merged,
                 detection_ms=round(detection_ms, 3),
                 recovery_ms=round(recovery_ms, 3),
                 degraded_world=survivors,
                 fault_iteration=failure.iteration,
                 **ckpt_extra)


def _restore_latest(ckpt_sc, bundle, failure_iteration: int,
                    warmup_steps: int = 0, group=None):
    """Restore-from-latest against the bundle's state template, over
    ``group`` (the survivors' gloo group; None: the checkpointer's
    own); returns (restore_ms, lost_steps).  Draining an in-flight
    async write is part of the measured restore cost.  ``lost_steps``
    counts measured steps: the redone window [last_save+1, failure)
    clipped to the timed steps."""
    t0 = time.monotonic()
    ckpt_sc.wait()
    if group is not None:
        ckpt_sc.set_group(group)
    last = ckpt_sc.last_saved_step
    redo_from = warmup_steps if last is None \
        else max(warmup_steps, last + 1)
    lost = max(0, failure_iteration - redo_from)
    if last is not None:
        ckpt_sc.restore(bundle.state, step=last)
    return (time.monotonic() - t0) * 1e3, lost


def _run_preempt(name: str, bundle, cfg: ProxyConfig, cfg_i: ProxyConfig,
                 plan: FaultPlan, injector: FaultInjector, stamp,
                 run: _Run, *, rebuild, ckpt_sc) -> ProxyResult:
    """The preempt -> (drain save) -> restore -> shrink -> rejoin arc.

    Segments in plan step units (P = preempt trigger, R = rejoin
    trigger, W = warmup):

        seg1  indices 0 .. P-1        full world   (W warmup + pre runs)
        P     the eviction            RankPreempted caught here
        seg2  indices P+1 .. R-1      degraded     (1 warmup + runs2)
        seg3  indices R ..            full world   (1 warmup + runs3;
                                      the rebuild and that warmup are
                                      rejoin_ms)

    The first ``lost_steps`` measured steps of seg2 re-cover ground the
    eviction destroyed: useful steps = total measured - lost_steps,
    goodput = useful / wall, the wall holding every stall, rebuild,
    restore and warmup from seg1's first step to seg3's last."""
    world = run.world
    if rebuild is None:
        raise ValueError("fault plan: preempt/rejoin need a "
                         "rebuild(ranks) callback (shrink + grow)")
    if not world:
        raise ValueError("fault plan: preempt needs the world size "
                         "(bundle.global_meta['world_size'] or world=)")
    warm = max(cfg.warmup, 1)
    plan.check_config(cfg)
    preempt_at = plan.first_preempt_iteration()
    rejoin_at = plan.rejoin_iteration()

    pre = min(cfg.runs, preempt_at - warm)
    if pre >= cfg.runs:  # trigger beyond the run: nothing ever fires
        return stamp(run_proxy(name, bundle, cfg_i))

    wall0 = time.monotonic()
    seg1 = run_proxy(name, bundle,
                     dataclasses.replace(cfg_i, runs=pre, min_exectime_s=0))

    # the announced eviction
    try:
        injector.before_step()
        raise RuntimeError("fault plan: preempt trigger did not fire at "
                           f"iteration {preempt_at}")
    except RankPreempted as e:
        eviction = e
        detection_ms = _caught(e, injector, "RankPreempted")

    # grace-window drain by the whole world, the evicted ranks included:
    # a final save unless the measured cost says the budget cannot fit
    drained = False
    if ckpt_sc is not None:
        drained = ckpt_sc.save_now(eviction.iteration - 1,
                                   budget_us=eviction.grace_us)

    survivors = [r for r in range(world)
                 if r not in plan.preempt_victims()
                 and r not in plan.crash_victims(world)]
    if not survivors:
        raise ValueError(f"fault plan: no rank of a world of {world} "
                         f"survives the preempt")
    remaining = cfg.runs - pre
    # degraded measured steps until the rejoin trigger (seg2's single
    # warmup step consumes P+1); a rejoin beyond the measured budget
    # never fires and the run stays degraded
    runs2 = remaining if rejoin_at is None \
        else min(remaining, rejoin_at - preempt_at - 2)
    rejoins = rejoin_at is not None and runs2 < remaining
    full_ckpt_group = ckpt_sc.group if ckpt_sc is not None else None

    t0 = time.monotonic()
    group, ckpt_group = run.groups(survivors, ckpt_sc is not None)
    alive = run.rank in survivors
    ckpt_extra, lost, recovery_ms, seg2 = {}, 0, 0.0, None
    if alive:
        if ckpt_sc is not None:
            restore_ms, lost = _restore_latest(ckpt_sc, bundle,
                                               eviction.iteration, warm,
                                               ckpt_group)
            ckpt_extra = {"restore_ms": round(restore_ms, 3),
                          "lost_steps": lost,
                          "checkpoint_drain_saved": drained}
        with run.degraded(survivors, group):
            bundle2 = rebuild(survivors)
            if ckpt_sc is not None:
                bundle2 = _with_checkpoint_hook(bundle2, ckpt_sc, injector)
            rebuild_ms = (time.monotonic() - t0) * 1e3
            seg2 = run_proxy(name, bundle2,
                             dataclasses.replace(cfg_i, runs=runs2,
                                                 warmup=1,
                                                 min_exectime_s=0))
        recovery_ms = rebuild_ms + (seg2.warmup_times_us[0] / 1e3
                                    if seg2.warmup_times_us else 0.0)

    extra = {}
    if run.multi and rejoins:
        # an evicted rank's row carries, for the steps it was out,
        # the lowest survivor's timers (the record holds one sample
        # per step on every row)
        src = min(survivors)
        timers = multihost.all_ranks(
            seg2.timers_us if alive else None)[src]
        if not alive:
            seg2 = ProxyResult(name=name, global_meta={},
                               timers_us=timers, warmup_times_us=[],
                               num_runs=runs2)
            bundle.rank_meta["fault"] = {
                "absent_runs": [pre, pre + runs2],
                "runs_from_rank": src}
        # the evicted ranks' step counter catches up with the
        # survivors' (their seg2 warmup and runs)
        injector.iteration = max(multihost.all_ranks(
            injector.iteration))
    segments = [seg1] + ([seg2] if seg2 is not None else [])
    if rejoins:
        # grow back: rebuild over the FULL world; the rebuild and the
        # first full-world step are the measured rejoin cost
        if ckpt_sc is not None and full_ckpt_group is not None:
            ckpt_sc.set_group(full_ckpt_group)
        t1 = time.monotonic()
        bundle3 = rebuild(list(range(world)))
        if ckpt_sc is not None:
            bundle3 = _with_checkpoint_hook(bundle3, ckpt_sc, injector)
        regrow_ms = (time.monotonic() - t1) * 1e3
        seg3 = run_proxy(name, bundle3,
                         dataclasses.replace(cfg_i, runs=remaining - runs2,
                                             warmup=1, min_exectime_s=0))
        segments.append(seg3)
        extra["rejoin_ms"] = round(
            regrow_ms + (seg3.warmup_times_us[0] / 1e3
                         if seg3.warmup_times_us else 0.0), 3)
        extra["fault_rejoin_step"] = rejoin_at
    else:
        extra["degraded_world"] = survivors
        run.final = survivors

    wall_s = time.monotonic() - wall0
    useful = max(0, cfg.runs - lost)
    merged = _concat_results(name, segments)
    # rejoined runs end on the full world; degraded-to-the-end runs keep
    # the survivor rows.  Either way the original bundle's post-build
    # globals carry over.
    for k, v in bundle.global_meta.items():
        merged.global_meta.setdefault(k, v)
    merged.global_meta["world_size"] = world
    return stamp(merged,
                 detection_ms=round(detection_ms, 3),
                 recovery_ms=round(recovery_ms, 3),
                 fault_iteration=eviction.iteration,
                 goodput=round(useful / wall_s, 4) if wall_s > 0 else 0.0,
                 goodput_useful_steps=useful,
                 goodput_wall_s=round(wall_s, 4),
                 **ckpt_extra, **extra)
