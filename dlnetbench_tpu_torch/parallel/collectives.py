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

``permute`` sends several cyclic hops in one batch (the collective
matmuls' two ring directions).  The differentiable forms at the end
(``all_gather``, ``psum_scatter``, ``psum``, ``all_to_all``,
``ppermute``, and ``pmax`` without a backward) carry the SPMD step's
collectives through autograd with the transposes the JAX package
applies.

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


def allreduce(x: torch.Tensor, group=None, async_op: bool = False,
              op: str = "sum"):
    """Sum ``x`` over the group's ranks, in place (reference Allreduce,
    MPI_SUM, proxy_classes.hpp:36-37); ``op="max"`` takes the largest
    instead (the JAX package's ``pmax``)."""
    _maybe_fault("allreduce", group)
    COUNTS["allreduce"] += 1
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    with _annotate("allreduce"):
        return dist.all_reduce(x, op=red, group=group, async_op=async_op)


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
    return _hops([(out, x, dst, src)], group, async_op)


def _hops(edges: list, group, async_op: bool):
    """Several hops ``(out, x, dst, src)`` in one ``batch_isend_irecv``
    (see ``_hop``); the k-th hop's messages carry tag k, so two hops
    between the same pair of ranks cannot cross."""
    me = dist.get_rank(group)
    gloo = dist.get_backend(group) == "gloo"
    ops = []
    with _annotate("permute"):
        for tag, (out, x, dst, src) in enumerate(edges):
            if dst is not None:
                COUNTS["send"] += 1
            if src is not None:
                COUNTS["recv"] += 1
            else:
                out.zero_()
            if dst == me and src == me and gloo:
                out.copy_(x)     # gloo has no pair to its own rank
                continue
            if dst is not None:
                ops.append(dist.P2POp(dist.isend, _bits(x),
                                      _global(group, dst), group, tag))
            if src is not None:
                ops.append(dist.P2POp(dist.irecv, _bits(out),
                                      _global(group, src), group, tag))
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


def permute(outs: list, xs: list, group=None, offsets=(),
            async_op: bool = False):
    """Ring hops at several offsets in one ``batch_isend_irecv``: ``xs[j]``
    to the group rank ``offsets[j]`` places on, ``outs[j]`` from the rank
    ``offsets[j]`` places back (the JAX package's cyclic ``ppermute``;
    the collective matmuls' two ring directions travel in one batch)."""
    _maybe_fault("permute", group)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return _hops([(o, x, (i + k) % n, (i - k) % n)
                  for o, x, k in zip(outs, xs, offsets)], group, async_op)


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


# ------------------------------------------------ differentiable forms
# The SPMD step (models/spmd.py) differentiates through its collectives,
# as the JAX package's ``jax.grad`` does through ``lax`` collectives
# under ``shard_map(check_vma=False)``.  Each op below is the JAX op on
# this rank's shard, with the transpose JAX applies as its backward:
#
#   all_gather (tiled)        <-> psum_scatter (sum)
#   psum                       -> psum of the cotangent
#   all_to_all(split, concat)  -> all_to_all(concat, split)
#   ppermute(perm)             -> ppermute(inverse perm)
#
# Every rank's loss is seeded with 1, so a psum's backward sums the
# cotangents of every rank's copy: the gradient of the sum of the
# ranks' losses, which is what the vocab-parallel loss's 1/tp seeds
# rely on.  ``pmax`` has no backward (the JAX package only takes it of a
# ``stop_gradient`` value).  Every call goes through the counted,
# fault-hooked wrappers above.


def group_size(group) -> int:
    return dist.get_world_size(group)


def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((group_size(group) * xt.shape[0], *xt.shape[1:]))
    allgather(out, xt, group=group)
    return out.movedim(0, dim)


def _scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // group_size(group), *xt.shape[1:]))
    reduce_scatter(out, xt, group=group)
    return out.movedim(0, dim)


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    allreduce(out, group=group)
    return out


def _a2a(x: torch.Tensor, group, split: int, concat: int) -> torch.Tensor:
    parts = torch.stack(x.chunk(group_size(group), dim=split)).contiguous()
    out = torch.empty_like(parts, memory_format=torch.contiguous_format)
    alltoall(out, parts, group=group)
    return torch.cat(out.unbind(0), dim=concat)


def _edges(perm, me: int) -> tuple:
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    return dst, src


def _permute_pairs(x: torch.Tensor, group, perm) -> torch.Tensor:
    _maybe_fault("ppermute", group)
    x = x.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dst, src = _edges(perm, dist.get_rank(group))
    _hop(out, x, group, dst, src, async_op=False)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.group, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.group, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _a2a(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group, ctx.concat, ctx.split), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute_pairs(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _permute_pairs(g, ctx.group, inverse), None, None


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (``lax.all_gather(tiled=True)``); backward: ``psum_scatter``."""
    return _AllGather.apply(x, group, dim)


def psum_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``x``
    (``lax.psum_scatter(tiled=True)``); backward: ``all_gather``."""
    return _PsumScatter.apply(x, group, dim)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (``lax.psum``); backward: the psum
    of the cotangent."""
    return _Psum.apply(x, group)


def all_to_all(x: torch.Tensor, group, split: int,
               concat: int) -> torch.Tensor:
    """``x``'s n blocks along ``split`` to the n ranks, the blocks
    received concatenated along ``concat`` in rank order
    (``lax.all_to_all(tiled=True)``); backward: the reverse."""
    return _AllToAll.apply(x, group, split, concat)


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` holds (source, destination) group
    ranks; a rank no pair sends to receives zeros.  Backward: the
    inverse permutation."""
    return _PPermute.apply(x, group, tuple(perm))


def ring_perm(n: int, offset: int) -> tuple:
    """The cyclic permutation sending rank i to rank i + offset."""
    return tuple((i, (i + offset) % n) for i in range(n))


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise largest of every rank's ``x`` (``lax.pmax``);
    no backward: take it of a value that carries no gradient."""
    if x.requires_grad:
        raise ValueError("pmax has no backward: pass a detached value")
    out = x.contiguous().clone()
    allreduce(out, group=group, op="max")
    return out
