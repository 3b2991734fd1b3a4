"""Collectives over ``torch.distributed`` — the port's
``ProxyCommunicator`` (reference cpp/proxy_classes.hpp:30-51; the JAX
package's ``parallel/collectives.py``).

``allreduce`` (SUM), ``allgather`` (concatenating, into one tensor) and
``reduce_scatter`` (SUM, one block per rank) have the semantics of the
JAX package's ``psum``, ``all_gather(tiled=True)`` and
``psum_scatter(tiled=True)``.  Each counts its calls in ``COUNTS``
(``counts`` / ``reset_counts``), which the tests and ``chip_smoke.py``
read to see how many collectives a step issued.

``CommStream`` gives the reference's issue order, which the JAX package
writes as ``tie`` and ``fence``: a collective issued after a burn starts
after that burn (the comm stream waits on the compute stream), runs
beside the compute issued after it, and the compute waits on it only
where the schedule says ``Wait`` (one collective) or ``WaitAll`` (all of
them).  On the card the comm stream is a CUDA stream; every collective
is issued on it, so they run one after another in issue order, as the
reference's nonblocking calls on one communicator do.  On the CPU the
comm stream is the chain of gloo ``async_op`` handles: each collective
starts once the previous one has finished.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

COUNTS = {"allreduce": 0, "allgather": 0, "reduce_scatter": 0}


def counts() -> dict:
    return dict(COUNTS)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def allreduce(x: torch.Tensor, group=None, async_op: bool = False):
    """Sum ``x`` over the group's ranks, in place (reference Allreduce,
    MPI_SUM, proxy_classes.hpp:36-37)."""
    COUNTS["allreduce"] += 1
    return dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group,
                           async_op=async_op)


def allgather(out: torch.Tensor, x: torch.Tensor, group=None,
              async_op: bool = False):
    """``out`` = every rank's ``x`` concatenated in rank order
    (reference Allgather, fsdp.cpp:86-100)."""
    COUNTS["allgather"] += 1
    return dist.all_gather_into_tensor(out, x, group=group,
                                       async_op=async_op)


def reduce_scatter(out: torch.Tensor, x: torch.Tensor, group=None,
                   async_op: bool = False):
    """``out`` = this rank's block of the sum of every rank's ``x``
    (reference Reduce_Scatter_block, fsdp.cpp:123-127); ``x`` divides
    evenly by the group's size."""
    COUNTS["reduce_scatter"] += 1
    return dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                      group=group, async_op=async_op)


class CommStream:
    """Issue order between the compute (the current stream) and the
    collectives of one step; see the module docstring."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._handles = []

    def issue(self, op, *args, group=None):
        """Start ``op(*args, group=group)`` after the compute issued so
        far; returns a token for ``wait``."""
        if self.cuda:
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                op(*args, group=group)
            done = torch.cuda.Event()
            done.record(self.stream)
            return done
        if self._handles:
            self._handles[-1].wait()
        handle = op(*args, group=group, async_op=True)
        self._handles.append(handle)
        return handle

    def wait(self, token) -> None:
        """The compute from here on waits for one collective."""
        if self.cuda:
            torch.cuda.current_stream().wait_event(token)
        else:
            token.wait()

    def wait_all(self) -> None:
        """WaitAll: the compute from here on waits for every collective
        issued so far."""
        if self.cuda:
            torch.cuda.current_stream().wait_stream(self.stream)
            return
        for h in self._handles:
            h.wait()
        self._handles.clear()
