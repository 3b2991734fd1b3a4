"""Metrics package: sample summaries, overlap, energy sampling, span
tracing, the flight recorder, profiler traces and schema-v2 record
emission.

Re-exports are resolved lazily (PEP 562): ``emit`` imports the proxy
harness, which imports ``utils.timing``, which imports
``metrics.spans`` — an eager ``from .emit import ...`` here would close
that loop into a circular import the moment anything imports the
timing module first.
"""
from __future__ import annotations

__all__ = ["emit_result", "result_to_record"]

_HOMES = {"emit_result": "emit", "result_to_record": "emit"}


def __getattr__(name: str):
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{home}"), name)
