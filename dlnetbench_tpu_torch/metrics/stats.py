"""Sample summaries (the JAX package's ``metrics/stats.py``
``summarize``): every timer array ships as

    {"value": median, "best": min, "band": [lo, hi], "n": N}

``overlap_fraction`` reads the proxies' A/B decomposition as the
measured communication-compute overlap.  ``flag_low_mode`` stamps a ``note`` on a line whose best sample sits
far below its median: the samples straddle two modes and the median is
a mixture, not a central tendency.  ``bands_overlap`` says whether two
such bands can be told apart.
"""
from __future__ import annotations

import statistics

# best/value ratio below which the samples are declared bimodal: the
# fastest observation is >30% under the median, which unimodal
# wall-clock noise (inflation-only) does not produce
LOW_MODE_RATIO = 0.7


def summarize(samples: list[float], ndigits: int | None = None) -> dict:
    """Median, minimum, observed range and count of same-unit samples;
    empty input summarizes to zeros with n=0."""
    if not samples:
        return {"value": 0.0, "best": 0.0, "band": [0.0, 0.0], "n": 0}
    vals = [float(v) for v in samples]
    out = {
        "value": statistics.median(vals),
        "best": min(vals),
        "band": [min(vals), max(vals)],
        "n": len(vals),
    }
    if ndigits is not None:
        out["value"] = round(out["value"], ndigits)
        out["best"] = round(out["best"], ndigits)
        out["band"] = [round(v, ndigits) for v in out["band"]]
    return out


def overlap_fraction(full, compute, comm) -> list[float]:
    """Measured communication-compute overlap per matched sample of the
    full / compute-only / comm-only legs (``proxies/base.run_proxy``):

        overlap_i = (Tc_i + Tm_i - T_both_i) / min(Tc_i, Tm_i)

    1.0 = the shorter leg fully hidden behind the longer, 0.0 = fully
    serialized, negative = running together is slower than back to back
    (contention).  Not clamped.  A sample whose shorter leg is ~0 (below
    0.1 % of the largest leg) yields 0.0: nothing to hide, and an
    unbounded ratio from a degenerate denominator must never dominate a
    summary."""
    out = []
    for f, c, m in zip(full, compute, comm):
        denom = min(c, m)
        if denom <= 0 or denom <= 1e-3 * max(f, c, m):
            out.append(0.0)
        else:
            out.append((c + m - f) / denom)
    return out


def bands_overlap(a, b) -> bool | None:
    """Do two ``[lo, hi]`` bands overlap?  ``None`` when either side is
    missing or malformed.  Bands that merely touch do overlap: with n=3
    samples the edges are observations, and sharing one is the
    indistinguishable-from-noise case."""
    try:
        alo, ahi = float(a[0]), float(a[1])
        blo, bhi = float(b[0]), float(b[1])
    except (TypeError, ValueError, IndexError):
        return None
    return blo <= ahi and alo <= bhi


def flag_low_mode(line: dict, ratio: float = LOW_MODE_RATIO) -> dict:
    """Annotate a summary-carrying dict (a ``summarize`` result or a
    bench JSON line, any unit) whose samples straddle two modes;
    appends to an existing ``note`` instead of replacing it."""
    value = line.get("value") or 0.0
    best = line.get("best")
    n = line.get("n", 0)
    if best is None or n < 2 or value <= 0:
        return line
    if best < ratio * value:
        note = (f"bimodal samples: best {best:g} is "
                f"{100 * (1 - best / value):.0f}% below the median over "
                f"n={n} — the median mixes two modes (host throughput "
                f"states); read [band] not value")
        line["note"] = (f"{line['note']}; {note}" if line.get("note")
                        else note)
    return line
