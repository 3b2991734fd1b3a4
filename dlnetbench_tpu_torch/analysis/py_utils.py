"""Plot utilities: byte formatting, stable style maps, zoom insets.

Counterpart of the reference's ``plots/py_utils.py`` (format_bytes /
parse_bytes at plots/py_utils.py:135-209, color/marker/linestyle maps at
:123-132, zoom insets at :15-120) — re-derived, with binary units and a
round-trip-tested parser.
"""
from __future__ import annotations

import itertools
import re

_UNITS = ["B", "KiB", "MiB", "GiB", "TiB", "PiB"]
# accept both binary and the loose decimal spellings ("KB" == KiB here,
# matching how HPC msg sizes are usually quoted)
_PARSE_UNITS = {"": 1}
for _i, _u in enumerate(_UNITS):
    _PARSE_UNITS[_u.lower()] = 1024 ** _i
    _PARSE_UNITS[_u.lower().replace("i", "")] = 1024 ** _i


def format_bytes(n: float, precision: int = 1) -> str:
    """1536 -> '1.5 KiB'; exact small values stay integral ('512 B')."""
    n = float(n)
    for i, unit in enumerate(_UNITS):
        scaled = n / (1024 ** i)
        if scaled < 1024 or i == len(_UNITS) - 1:
            if scaled == int(scaled):
                return f"{int(scaled)} {unit}"
            return f"{scaled:.{precision}f} {unit}"
    raise AssertionError  # pragma: no cover


def parse_bytes(s: str) -> int:
    """'1.5 KiB' / '1.5KB' / '512' -> bytes (int)."""
    m = re.fullmatch(r"\s*([0-9]*\.?[0-9]+)\s*([A-Za-z]*)\s*", s)
    if not m:
        raise ValueError(f"cannot parse byte size {s!r}")
    value, unit = float(m.group(1)), m.group(2).lower()
    if unit not in _PARSE_UNITS:
        raise ValueError(f"unknown byte unit {unit!r} in {s!r}")
    return int(round(value * _PARSE_UNITS[unit]))


# --- stable style maps ------------------------------------------------------
# Deterministic assignment: the same key always gets the same style within a
# StyleMap instance, so series keep their identity across subplots.

_PALETTE = ["#4053d3", "#ddb310", "#b51d14", "#00beff", "#fb49b0",
            "#00b25d", "#cacaca"]
_MARKERS = ["o", "s", "^", "D", "v", "P", "X", "*"]
_LINESTYLES = ["-", "--", "-.", ":"]


class StyleMap:
    """Lazily assigns a stable (color, marker, linestyle) per key."""

    def __init__(self, palette=_PALETTE, markers=_MARKERS,
                 linestyles=_LINESTYLES):
        self._colors = itertools.cycle(palette)
        self._markers = itertools.cycle(markers)
        self._linestyles = itertools.cycle(linestyles)
        self._assigned: dict = {}

    def __getitem__(self, key) -> dict:
        if key not in self._assigned:
            self._assigned[key] = {
                "color": next(self._colors),
                "marker": next(self._markers),
                "linestyle": next(self._linestyles),
            }
        return self._assigned[key]

    def line_kwargs(self, key) -> dict:
        return dict(self[key])

    def scatter_kwargs(self, key) -> dict:
        s = self[key]
        return {"color": s["color"], "marker": s["marker"]}


def add_zoom_inset(ax, bounds, xlim, ylim, *, loc="upper right"):
    """Add a zoomed inset copying the parent's line artists.

    ``bounds`` is (x0, y0, w, h) in axes fraction; ``xlim``/``ylim`` is the
    data window the inset magnifies (reference plots/py_utils.py:15-120).
    """
    axins = ax.inset_axes(bounds)
    for line in ax.get_lines():
        axins.plot(line.get_xdata(), line.get_ydata(),
                   color=line.get_color(), marker=line.get_marker(),
                   linestyle=line.get_linestyle(), lw=line.get_linewidth())
    axins.set_xlim(*xlim)
    axins.set_ylim(*ylim)
    axins.tick_params(labelsize=7)
    ax.indicate_inset_zoom(axins, edgecolor="gray")
    return axins
