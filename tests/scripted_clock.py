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
"""
from __future__ import annotations

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
        self.t += max(float(dt), 0.0)

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
