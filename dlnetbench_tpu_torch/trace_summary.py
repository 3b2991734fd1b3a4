"""Where a profiled proxy step's device time went, per rank, from the
merged trace ``cli --trace-out`` writes.

    python -m dlnetbench_tpu_torch.trace_summary TRACE.json [...]

For each rank's device track (``rank r (cuda:i)``) prints one JSON line
over the profiled step: its span (first device event's start to the
last one's end, µs); per collective kind (``args.kind``; the burn's
graph launches and other device work are ``other``) the event count,
total, mean and max µs, the streams it ran on, the share of its time
that overlaps ``other`` work on another stream (``overlap_other``),
and, for at most 32 events, each one's start (from the step's start)
and duration; ``comm_tail_us``, how long the last collective ends after
the last ``other`` work; ``comm_concurrent_us``, the time collectives
run on two or more streams at once.
"""
from __future__ import annotations

import json
import sys

_TIMELINE_MAX = 32


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _intersection_us(xs: list[tuple[float, float]],
                     ys: list[tuple[float, float]]) -> float:
    """Total length of the intersection of two disjoint, sorted interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def summarize_rank(label: str, events: list[dict]) -> dict:
    """The summary line of one rank's device events."""
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    by_kind: dict[str, list[dict]] = {}
    for e in events:
        by_kind.setdefault((e.get("args") or {}).get("kind") or "other",
                           []).append(e)

    def spans(evs, tid=None):
        return _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in evs if tid is None or e.get("tid") == tid])

    other = by_kind.get("other", [])
    out: dict = {"rank": label, "span_us": round(t1 - t0, 1), "kinds": {}}
    for kind, evs in sorted(by_kind.items()):
        durs = [float(e["dur"]) for e in evs]
        row = {"count": len(evs), "total_us": round(sum(durs), 1),
               "mean_us": round(sum(durs) / len(durs), 1),
               "max_us": round(max(durs), 1),
               "streams": sorted({str(e.get("tid")) for e in evs})}
        if kind != "other":
            # overlap with other work on a different stream
            shared = 0.0
            for tid in {e.get("tid") for e in evs}:
                mine = spans(evs, tid)
                rest = spans([o for o in other if o.get("tid") != tid])
                shared += _intersection_us(mine, rest)
            row["overlap_other"] = round(shared / sum(durs), 4) \
                if sum(durs) else 0.0
            if len(evs) <= _TIMELINE_MAX:
                row["timeline_us"] = [
                    [round(float(e["ts"]) - t0, 1), round(float(e["dur"]), 1),
                     str(e.get("tid"))]
                    for e in sorted(evs, key=lambda e: float(e["ts"]))]
        out["kinds"][kind] = row
    comm = [e for k, evs in by_kind.items() if k != "other" for e in evs]
    if comm and other:
        out["comm_tail_us"] = round(
            max(float(e["ts"]) + float(e["dur"]) for e in comm)
            - max(float(e["ts"]) + float(e["dur"]) for e in other), 1)
    streams = sorted({e.get("tid") for e in comm}, key=str)
    concurrent = 0.0
    for i, a in enumerate(streams):
        for b in streams[i + 1:]:
            concurrent += _intersection_us(spans(comm, a), spans(comm, b))
    out["comm_concurrent_us"] = round(concurrent, 1)
    return out


def summarize_trace(trace: dict) -> list[dict]:
    """One summary line per rank track of a merged trace."""
    events = trace.get("traceEvents", [])
    labels = {e["pid"]: e["args"]["name"] for e in events
              if e.get("ph") == "M" and e.get("name") == "process_name"
              and str(e["args"].get("name", "")).startswith("rank ")}
    out = []
    for pid, label in sorted(labels.items()):
        evs = [e for e in events if e.get("pid") == pid
               and e.get("ph") == "X"]
        if evs:
            out.append(summarize_rank(label, evs))
    return out


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    for path in paths:
        with open(path) as f:
            trace = json.load(f)
        for line in summarize_trace(trace):
            print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
