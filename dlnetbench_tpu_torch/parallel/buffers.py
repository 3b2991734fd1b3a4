"""Collective buffers on the rank's device — the reference's
zero-initialized ``Tensor<_FLOAT, device>`` (cpp/proxy_classes.hpp
:381-444), made on the device, never on the host, since a proxy at
full size asks for tens of GB."""
from __future__ import annotations

import torch


def zeros(elems: int, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    return torch.zeros(elems, dtype=dtype, device=device)


def scaled_elems(elems: int, scale: float, minimum: int = 128) -> int:
    """A schedule-derived buffer size scaled for small runs: ``scale=1``
    keeps the schedule's true message sizes, and a smaller scale never
    goes under ``minimum`` elements."""
    if scale >= 1.0:
        return elems
    return max(minimum, int(elems * scale))
