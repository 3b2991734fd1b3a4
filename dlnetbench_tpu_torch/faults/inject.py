"""Fault injection at step boundaries: delay and jitter sleeps and
scripted crashes (the JAX package's ``faults/inject.py``).

The port runs one process per rank, so each process holds its own
``FaultInjector(plan, world, rank=its_rank)``:

* a ``delay`` or ``jitter`` event sleeps only on the ranks it targets —
  the rank-scoped view the JAX package defines for a multi-controller
  run.  The next collective of the step then holds every other rank
  back until the straggler arrives, which is what a straggler is;
* ``crash``, ``preempt`` and ``partition`` triggers fire on EVERY rank
  at the same step, whichever ranks they name: a rank that went on
  alone would wait forever in a collective with the dead one.  The
  raised ``RankFailure`` / ``RankPreempted`` names the plan's victim,
  as the JAX package's single controller does.

The harness (``proxies/base.run_proxy``) calls ``before_step`` ahead of
every full step, warmup included; ``faults/policy.run_faulted`` catches
the failures and applies the plan's policy.

``parallel/collectives.set_fault_hook`` installs a hook that runs at
every collective wrapper call.  The port's collectives are eager
calls, so the hook fires per execution, where the JAX package's fires
once per trace.
"""
from __future__ import annotations

import random
import time

from dlnetbench_tpu_torch.faults.plan import FaultPlan

# ``time.sleep`` wakes late: by 0.5-0.8 ms in the median and up to
# 1.5 ms for a 20 ms sleep on an H100 machine's virtualised host
# (``host_probe``, PERF.md §6).  A delay's last SPIN_S spins on the
# clock, so the step idles for the plan's delay to within
# microseconds, as it records.
SPIN_S = 2e-3


def wait(seconds: float) -> None:
    """Block for ``seconds``: ``time.sleep`` until ``SPIN_S`` before
    the deadline, then spin on ``time.perf_counter`` up to it."""
    end = time.perf_counter() + seconds
    if seconds > SPIN_S:
        time.sleep(seconds - SPIN_S)
    while time.perf_counter() < end:
        pass


class RankFailure(RuntimeError):
    """A fault-plan scripted rank death."""

    def __init__(self, rank: int, iteration: int):
        super().__init__(f"rank {rank} crashed by fault plan "
                         f"(iteration {iteration})")
        self.rank = rank
        self.iteration = iteration


class RankPreempted(RuntimeError):
    """A fault-plan scripted grace-window eviction: unlike RankFailure
    the departure is announced, and ``grace_us`` is the drain budget
    the policy layer may spend on a final checkpoint save
    (faults/policy.py run_faulted)."""

    def __init__(self, rank: int, iteration: int, grace_us: float = 0.0):
        super().__init__(f"rank {rank} preempted by fault plan "
                         f"(iteration {iteration}, grace "
                         f"{grace_us / 1e3:.1f} ms)")
        self.rank = rank
        self.iteration = iteration
        self.grace_us = grace_us


class FaultInjector:
    """Applies a plan's step-boundary events; one per measured run and
    process.

    ``rank=None`` plays every rank (a world-1 run, or a test's view of
    the whole plan): a delay targeting ANY rank sleeps here.
    ``rank=r`` is rank r's process: only the delay and jitter events
    that target r sleep, while the crash, preempt and partition
    triggers fire as in the whole-plan view.  ``iteration`` counts
    every harness step, warmup included.
    """

    def __init__(self, plan: FaultPlan, world: int | None = None,
                 rank: int | None = None):
        self.plan = plan
        self.world = world  # needed to name a partition's far side
        self.rank = rank    # None = this process plays every rank
        self.iteration = 0
        self.injected_delay_us = 0.0
        self.crash_raised_at = 0.0  # monotonic stamp for detection_ms
        # one stream per event, seeded by (seed, index): adding an
        # unrelated event must not change another event's delays
        self._rng = [random.Random((e.seed << 20) ^ (i + 1))
                     for i, e in enumerate(plan.events)]

    def before_step(self) -> float:
        """Apply one step's faults; returns the injected sleep in
        microseconds (already slept).  Raises RankFailure at a crash
        or partition trigger and RankPreempted at a preempt trigger."""
        it = self.iteration
        self.iteration += 1
        sleep_us = 0.0
        for ei, e in enumerate(self.plan.events):
            if not e.live_at(it):
                continue
            if e.kind in ("delay", "jitter") and self.rank is not None \
                    and not e.targets(self.rank):
                continue    # another rank's straggler event
            if e.kind == "delay" and e.where == "step":
                sleep_us += e.magnitude_us
            elif e.kind == "jitter" and e.where == "step":
                sleep_us += self._rng[ei].uniform(0, e.magnitude_us)
            elif e.kind == "crash" and it == e.iteration:
                self._sleep(sleep_us)
                self.crash_raised_at = time.monotonic()
                raise RankFailure(min(e.ranks) if e.ranks else 0, it)
            elif e.kind == "preempt" and it == e.iteration:
                # 'rejoin' events never raise: they mark the step at
                # which the policy layer grows the world back
                self._sleep(sleep_us)
                self.crash_raised_at = time.monotonic()
                raise RankPreempted(min(e.ranks), it,
                                    grace_us=e.magnitude_us)
            elif e.kind == "partition" and it == e.iteration and e.group:
                # the side WITHOUT rank 0 is lost; when rank 0 sits in
                # the group the lost side is the complement
                if 0 not in e.group:
                    far = sorted(e.group)
                elif self.world is None:
                    raise ValueError(
                        "fault plan: a partition whose group contains "
                        "rank 0 loses the complement side — construct "
                        "FaultInjector(plan, world=N) to enumerate it")
                else:
                    far = [r for r in range(self.world)
                           if r not in e.group]
                if far:
                    self._sleep(sleep_us)
                    self.crash_raised_at = time.monotonic()
                    raise RankFailure(far[0], it)
        self._sleep(sleep_us)
        return sleep_us

    def before_chain(self, reps: int) -> float:
        """One fence chain = ``reps`` back-to-back step calls; apply
        each rep's step faults."""
        total = 0.0
        for _ in range(max(reps, 1)):
            total += self.before_step()
        return total

    def _sleep(self, us: float) -> None:
        if us > 0:
            wait(us / 1e6)
            self.injected_delay_us += us
