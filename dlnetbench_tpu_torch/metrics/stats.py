"""Sample summaries (the JAX package's ``metrics/stats.py``
``summarize``): every timer array ships as

    {"value": median, "best": min, "band": [lo, hi], "n": N}
"""
from __future__ import annotations

import statistics


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
