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


class Carry:
    """A buffer that collectives replace rather than update — a hop's
    activations, a ring's KV block, an all-to-all's tokens: the value
    and a second buffer of its size.  ``hop`` issues ``fn(out=second,
    x=value)`` on a comm stream and swaps the two, as the JAX package's
    ``ppermute`` and ``all_to_all`` return a new array: a receive cannot
    land in the buffer being sent."""

    def __init__(self, elems: int, dtype: torch.dtype,
                 device: torch.device):
        self.bufs = [zeros(elems, dtype, device), zeros(elems, dtype, device)]

    @property
    def value(self) -> torch.Tensor:
        return self.bufs[0]

    def hop(self, stream, fn, group, **kw):
        """Issue ``fn`` on ``stream``; returns its token."""
        token = stream.issue(fn, self.bufs[1], self.bufs[0], group=group,
                             **kw)
        self.bufs.reverse()
        return token
