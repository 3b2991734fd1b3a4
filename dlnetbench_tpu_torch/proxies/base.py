"""``ProxyResult`` — what a measured run hands to ``metrics.emit`` (the
JAX package's ``proxies/base.py`` dataclass; the proxy runner itself is
not ported yet)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ProxyResult:
    name: str
    global_meta: dict
    timers_us: dict          # timer name -> list of per-iteration values
    warmup_times_us: list
    num_runs: int
