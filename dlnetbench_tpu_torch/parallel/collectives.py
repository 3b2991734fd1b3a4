"""Collectives over ``torch.distributed`` — the port's
``ProxyCommunicator`` (reference cpp/proxy_classes.hpp:30-51; the JAX
package's ``parallel/collectives.py``).

``allreduce`` (SUM), ``allgather`` (concatenating, into one tensor),
``reduce_scatter`` (SUM, one block per rank) and ``alltoall`` (block j
of every rank's input to rank j, in rank order) have the semantics of
the JAX package's ``psum``, ``all_gather(tiled=True)``,
``psum_scatter(tiled=True)`` and ``all_to_all(tiled=True)`` over
axis 0.  ``ring_shift``, ``shift_up`` and ``shift_down`` are its
``ppermute`` hops: each rank sends to at most one peer and receives
from at most one, in one ``batch_isend_irecv``, and a rank that
receives nothing in a hop gets zeros, as ``ppermute`` gives it.  A
rank in neither the hop's senders nor its receivers issues no call.
Each counts its calls in ``COUNTS`` (``counts`` / ``reset_counts``) —
a hop its ``send`` and its ``recv`` apart — which the tests and
``chip_smoke.py`` read to see how many collectives a step issued.
Each first calls the fault hook (``set_fault_hook``) with its name and
group.  While a profile is active each also opens a ``record_function``
annotation ``dlnb:<kind>`` (``allreduce``, ``allgather``,
``reduce_scatter``, ``alltoall``, ``permute`` for a hop), through which
``metrics/profiling.py`` gives the device work it launched its kind.

The byte-moving ops (``alltoall`` and the hops) move float8 tensors as
their ``uint8`` view: they move bits, and the view is the same bits in
a type every backend carries.

``CommStream`` gives the reference's issue order, which the JAX package
writes as ``tie`` and ``fence``: a collective issued after a burn starts
after that burn (the comm stream waits on the compute stream), runs
beside the compute issued after it, and the compute waits on it only
where the schedule says ``Wait`` (one collective) or ``WaitAll`` (all of
them).  On the card the comm stream is a CUDA stream; every collective
is issued on it, so they run one after another in issue order, as the
reference's nonblocking calls on one communicator do.  On the CPU the
comm stream is the chain of gloo ``async_op`` handles: each collective
starts once the previous one has finished.  A step may run several comm
streams side by side (the pipeline's two hop directions); an ``Order``
shared by them records what each collective was ordered after.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from dlnetbench_tpu_torch.metrics.profiling import ANNOTATION_PREFIX

COUNTS = {"allreduce": 0, "allgather": 0, "reduce_scatter": 0,
          "alltoall": 0, "send": 0, "recv": 0}
_FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)


# the pre-collective fault hook (faults/inject.py): called with
# (op_name, group) at every wrapper call.  The wrappers are eager, so it
# fires per execution (the JAX package's fires once per trace).
_FAULT_HOOK = None


def set_fault_hook(fn) -> None:
    """Install ``fn(op_name, group)`` as the pre-collective fault hook
    (None clears it)."""
    global _FAULT_HOOK
    _FAULT_HOOK = fn


def _maybe_fault(op: str, group) -> None:
    if _FAULT_HOOK is not None:
        _FAULT_HOOK(op, group)


def counts() -> dict:
    return dict(COUNTS)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


_UNANNOTATED = contextlib.nullcontext()


def _annotate(kind: str):
    """``record_function("dlnb:<kind>")`` while a profile is active, a
    shared no-op otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(ANNOTATION_PREFIX + kind)
    return _UNANNOTATED


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype in _FLOAT8 else t


def allreduce(x: torch.Tensor, group=None, async_op: bool = False):
    """Sum ``x`` over the group's ranks, in place (reference Allreduce,
    MPI_SUM, proxy_classes.hpp:36-37)."""
    _maybe_fault("allreduce", group)
    COUNTS["allreduce"] += 1
    with _annotate("allreduce"):
        return dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group,
                               async_op=async_op)


def allgather(out: torch.Tensor, x: torch.Tensor, group=None,
              async_op: bool = False):
    """``out`` = every rank's ``x`` concatenated in rank order
    (reference Allgather, fsdp.cpp:86-100)."""
    _maybe_fault("allgather", group)
    COUNTS["allgather"] += 1
    with _annotate("allgather"):
        return dist.all_gather_into_tensor(out, x, group=group,
                                           async_op=async_op)


def reduce_scatter(out: torch.Tensor, x: torch.Tensor, group=None,
                   async_op: bool = False):
    """``out`` = this rank's block of the sum of every rank's ``x``
    (reference Reduce_Scatter_block, fsdp.cpp:123-127); ``x`` divides
    evenly by the group's size."""
    _maybe_fault("reduce_scatter", group)
    COUNTS["reduce_scatter"] += 1
    with _annotate("reduce_scatter"):
        return dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                          group=group, async_op=async_op)


def alltoall(out: torch.Tensor, x: torch.Tensor, group=None,
             async_op: bool = False):
    """Block j of ``x`` to group rank j; ``out``'s block i from group rank
    i (reference Alltoall, proxy_classes.hpp:41; the MoE dispatch and
    combine, hybrid_3d_moe.cpp:161-165).  ``x`` divides evenly by the
    group's size; ``out`` is another buffer of its size."""
    _maybe_fault("alltoall", group)
    COUNTS["alltoall"] += 1
    with _annotate("alltoall"):
        return dist.all_to_all_single(_bits(out), _bits(x), group=group,
                                      async_op=async_op)


class _Handles:
    """The works of one hop, waited together (``async_op`` handle).
    Waiting twice waits once: a second ``wait`` on a gloo send or
    receive waits for another message."""

    def __init__(self, works):
        self.works = works

    def wait(self):
        works, self.works = self.works, []
        for w in works:
            w.wait()
        return True


def _hop(out: torch.Tensor, x: torch.Tensor, group, dst, src,
         async_op: bool):
    """Send ``x`` to group rank ``dst`` and receive ``out`` from group
    rank ``src`` (``None``: no such edge) in one ``batch_isend_irecv``;
    ``out`` is zeroed when nothing arrives."""
    if dst is not None:
        COUNTS["send"] += 1
    if src is not None:
        COUNTS["recv"] += 1
    else:
        out.zero_()
    me = dist.get_rank(group)
    with _annotate("permute"):
        if dst == me and src == me and dist.get_backend(group) == "gloo":
            out.copy_(x)         # gloo has no pair to its own rank
            dst = src = None
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, _bits(x),
                                  _global(group, dst), group))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, _bits(out),
                                  _global(group, src), group))
        handle = _Handles(dist.batch_isend_irecv(ops) if ops else [])
    if async_op:
        return handle
    handle.wait()
    return None


def _global(group, group_rank: int) -> int:
    return group_rank if group is None else dist.get_global_rank(
        group, group_rank)


def ring_shift(out: torch.Tensor, x: torch.Tensor, group=None,
               shift: int = 1, async_op: bool = False):
    """Send ``x`` to the rank ``shift`` places on along the group's ring
    and receive ``out`` from the rank ``shift`` places back (JAX
    ``ring_shift``: the ring-attention KV rotation)."""
    _maybe_fault("ring_shift", group)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return _hop(out, x, group, (i + shift) % n, (i - shift) % n, async_op)


def shift_up(out: torch.Tensor, x: torch.Tensor, group=None,
             senders=None, async_op: bool = False):
    """Stage s -> s+1 (the forward activation hop, reference
    hybrid_2d.cpp:109-132): the last stage sends nothing and the first
    receives zeros; ``senders`` (group ranks) restricts the edges
    further, as the JAX package's per-tick sender sets do."""
    _maybe_fault("shift_up", group)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    allowed = set(range(n - 1)) if senders is None else set(senders)
    dst = i + 1 if i in allowed and i + 1 < n else None
    src = i - 1 if i - 1 in allowed and i >= 1 else None
    return _hop(out, x, group, dst, src, async_op)


def shift_down(out: torch.Tensor, x: torch.Tensor, group=None,
               senders=None, async_op: bool = False):
    """Stage s -> s-1 (the backward gradient hop); see ``shift_up``."""
    _maybe_fault("shift_down", group)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    allowed = set(range(1, n)) if senders is None else set(senders)
    dst = i - 1 if i in allowed and i >= 1 else None
    src = i + 1 if i + 1 in allowed and i + 1 < n else None
    return _hop(out, x, group, dst, src, async_op)


class Order:
    """What the collectives of one step were ordered after: for each,
    in issue order, its name and the earlier collectives it follows
    directly — the previous one on its comm stream and every one the
    compute waited on since that stream last issued.  The transitive
    closure (``after_all``) is the step's dependence relation, the
    counterpart of the dataflow the JAX package builds with ``tie``."""

    def __init__(self):
        self.ops: list[tuple[str, tuple]] = []
        self.waited: list[int] = []

    def after_all(self) -> list[set]:
        """For each collective, every earlier one it is ordered after."""
        out: list[set] = []
        for _, after in self.ops:
            s = set(after)
            for j in after:
                s |= out[j]
            out.append(s)
        return out


class CommStream:
    """Issue order between the compute (the current stream) and the
    collectives of one step; see the module docstring."""

    def __init__(self, device: torch.device, order: Order | None = None):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.order = order if order is not None else Order()
        self._handles = []
        self._last = None     # this stream's last collective in order
        self._seen = 0        # order.waited when it was issued

    def issue(self, op, *args, group=None, **kw):
        """Start ``op(*args, group=group, **kw)`` after the compute issued
        so far; returns a token for ``wait``."""
        o = self.order
        after = ([] if self._last is None else [self._last]) \
            + o.waited[self._seen:]
        self._last, self._seen = len(o.ops), len(o.waited)
        o.ops.append((op.__name__, tuple(after)))
        if self.cuda:
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                op(*args, group=group, **kw)
            done = torch.cuda.Event()
            done.record(self.stream)
            return self._last, done
        if self._handles:
            self._handles[-1].wait()
        handle = op(*args, group=group, async_op=True, **kw)
        self._handles.append(handle)
        return self._last, handle

    def wait(self, token) -> None:
        """The compute from here on waits for one collective."""
        op_id, done = token
        self.order.waited.append(op_id)
        if self.cuda:
            torch.cuda.current_stream().wait_event(done)
        else:
            done.wait()

    def wait_all(self) -> None:
        """WaitAll: the compute from here on waits for every collective
        issued so far."""
        if self._last is not None:
            self.order.waited.append(self._last)
        if self.cuda:
            torch.cuda.current_stream().wait_stream(self.stream)
            return
        for h in self._handles:
            h.wait()
        self._handles.clear()
