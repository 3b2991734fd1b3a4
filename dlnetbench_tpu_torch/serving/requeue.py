"""The crash-shrink arc every serving runner shares (the JAX package's
``serving/requeue.py``): ``run_serving``'s rank crash, ``run_disagg``'s
prefill-rank crash, and the fleet's replica crash and autoscaler drain
all spell it through these three functions.

* ``detect_shrink`` — the catch-side head: re-raise unless the fault is
  a ``RankFailure`` / ``RankPreempted`` under policy ``shrink``, stamp
  the detection latency at the catch, fire the flight recorder's
  ``fault`` trigger, and hand back the surviving ranks
  (``FaultPlan.shrink_survivors``).
* ``requeue_unfinished`` — drain a source (an engine or a server) and
  hand its unfinished requests back ordered by ``(arrival_s, rid)``,
  their original arrival stamps kept, so the disruption lands in their
  measured latency.
* ``run_requeued`` — finish on the rebuilt target over the leftovers,
  anchored at the first segment's clock origin, so every stamp lives on
  one timeline.
"""
from __future__ import annotations

import time

from dlnetbench_tpu_torch.metrics import telemetry
from dlnetbench_tpu_torch.serving.arrivals import Request


def detect_shrink(e: BaseException, *, injector, fault_plan, world: int,
                  step: int, detail: dict | None = None
                  ) -> tuple[float, list[int]]:
    """Classify a caught fault for a crash-shrink segmentation.

    Re-raises ``e`` unless it is a ``RankFailure`` / ``RankPreempted``
    under policy ``shrink``.  Otherwise returns ``(detection_ms,
    survivors)``: the wall time from the injector's raise to here, and
    the ranks left standing — an empty list is returned, not raised
    (each runner has its own liveness rule).  The ``fault`` trigger
    carries the fault's kind, rank and iteration and ``detail``."""
    from dlnetbench_tpu_torch.faults.inject import (RankFailure,
                                                    RankPreempted)
    if not isinstance(e, (RankFailure, RankPreempted)) \
            or fault_plan is None or fault_plan.policy != "shrink":
        raise e
    detection_ms = (time.monotonic() - injector.crash_raised_at) * 1e3
    telemetry.trigger("fault", step=step, detail={
        "kind": type(e).__name__,
        "rank": getattr(e, "rank", None),
        "iteration": getattr(e, "iteration", None),
        "detection_ms": round(detection_ms, 3),
        **(detail or {})})
    return detection_ms, fault_plan.shrink_survivors(world)


def requeue_unfinished(source) -> list[Request]:
    """Drain ``source`` (anything with ``drain_unfinished()``) and return
    its unfinished requests ordered by ``(arrival_s, rid)``, original
    arrival stamps kept.  In-flight requests lose their decode progress
    (their cache dies with the drained capacity) and are redone."""
    return sorted(source.drain_unfinished(),
                  key=lambda r: (r.arrival_s, r.rid))


def run_requeued(target, leftovers: list[Request], *, injector,
                 t_origin: float):
    """Drive the rebuilt ``target`` over ``leftovers`` on the first
    segment's clock origin; later scripted events still land through
    ``injector``."""
    return target.run(leftovers, injector=injector, t_origin=t_origin)
