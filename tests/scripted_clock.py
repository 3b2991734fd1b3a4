"""A scripted engine clock for the serving tests that compare two engines'
streams (the port's and the JAX package's, or two of the port's).

Both schedulers run open loop on their module's ``time``: admission reads
``time.monotonic``, an idle engine ``time.sleep``s to the next arrival, and
the fused loop sizes its trips from a step-time average taken with
``time.perf_counter``.  On the wall clock the admission schedule therefore
follows the host's speed, and two engines under load can admit a request
at different steps.  ``run`` drives one engine on a clock that reads never
advance: an idle sleep jumps it to the wake-up time and each engine step
adds ``step_s``.  The schedule is then a function of the plan alone, the
same for every engine that admits by the same rule, on any host.
``scripted`` does the same for a whole package's serving-at-scale
runners (the disaggregated server, the fleet, the faulted runs).
"""
from __future__ import annotations

import contextlib
import importlib
import math
import sys
import time

# about one CPU step of the tests' tiny engines: arrivals at the test plans'
# rates then overlap running requests, as they do on the wall clock
STEP_S = 0.01


class ScriptedClock:
    """``monotonic``, ``perf_counter`` and ``sleep`` on one scripted
    timeline; every other name of the ``time`` module passes through."""

    def __init__(self, step_s: float = STEP_S):
        self.t = 0.0
        self.step_s = step_s

    def monotonic(self) -> float:
        return self.t

    perf_counter = monotonic

    def sleep(self, dt: float) -> None:
        # a wake-up a rounding error short of a deadline (an engine's
        # clock origin is not 0 on a shared clock) still moves the clock
        t = self.t + max(float(dt), 0.0)
        self.t = math.nextafter(self.t, math.inf) if dt > 0 and t <= self.t \
            else t

    def __getattr__(self, name):
        return getattr(time, name)


def run(eng, requests, step_s: float = STEP_S):
    """``eng.run(requests)`` with the engine's scheduler module reading a
    fresh ``ScriptedClock`` that each ``eng._step()`` advances by
    ``step_s``; the module's clock and the engine are restored after."""
    mod = sys.modules[type(eng).__module__]
    clock = ScriptedClock(step_s)
    step = eng._step

    def scripted_step():
        step()
        clock.t += step_s

    real = mod.time
    mod.time = clock
    eng._step = scripted_step
    try:
        return eng.run(requests)
    finally:
        mod.time = real
        del eng._step


# the serving tier's modules that read the clock, in either package
SCALE_MODULES = ("serving.scheduler", "serving.disagg", "serving.fleet",
                 "serving.requeue", "ops.page_migration", "faults.inject")


@contextlib.contextmanager
def scripted(package: str, step_s: float = STEP_S):
    """Every serving-at-scale runner of ``package`` (``dlnetbench_tpu``
    or ``dlnetbench_tpu_torch``) on one ``ScriptedClock``: the clock
    modules of ``SCALE_MODULES`` read it, an idle sleep (and a fault
    plan's delay) jumps it, and each loop step — ``Engine._step``,
    ``DisaggServer._decode_step``, ``FleetServer._step_all`` — adds
    ``step_s``.  Every engine, server and runner built inside the block
    runs on it, so two packages' runs of one plan admit, hand off, route
    and fault at the same steps.  Yields the clock; everything is
    restored after."""
    clock = ScriptedClock(step_s)
    mods = [importlib.import_module(f"{package}.{m}")
            for m in SCALE_MODULES]
    saved = [(m, "time", m.time) for m in mods]
    inject = mods[-1]
    if hasattr(inject, "wait"):
        saved.append((inject, "wait", inject.wait))
    steps = [(mods[0].Engine, "_step"),
             (mods[1].DisaggServer, "_decode_step"),
             (mods[2].FleetServer, "_step_all")]
    for cls, name in steps:
        saved.append((cls, name, cls.__dict__[name]))

        def advancing(self, *a, _f=cls.__dict__[name], **kw):
            out = _f(self, *a, **kw)
            clock.t += clock.step_s
            return out

        setattr(cls, name, advancing)
    for m in mods:
        m.time = clock
    if hasattr(inject, "wait"):
        inject.wait = clock.sleep
    try:
        yield clock
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
