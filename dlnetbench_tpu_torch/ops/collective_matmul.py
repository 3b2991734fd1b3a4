"""Decomposed collective matmuls (the JAX package's
``ops/collective_matmul.py``): the tensor-parallel collective broken
into ring hops interleaved with the matmul it feeds or is fed by (Wang
et al., ASPLOS'23).

* ``all_gather_matmul(x, w, group)`` == ``all_gather(x, dim) @ w``: this
  rank's own block is multiplied first, then peer blocks arrive over a
  bidirectional ring (half the peers over the +1 direction, half over
  -1) and each is multiplied as it lands.  Per-row math is the
  gather-then-matmul's.
* ``matmul_reduce_scatter(a, w, group)`` == ``psum_scatter(a @ w, dim)``:
  a ring reduce-scatter whose hops overlap the next block's partial
  matmul, bidirectional by splitting the output columns in half (one
  ring direction a half; a one-column ``w`` runs one ring).  The sums
  run in ring order, so the result matches the fused path to f32
  reduction tolerance.

``chunks`` splits every block matmul along its row axis.  Both ops are
``torch.autograd.Function``s whose backward is the other decomposed op
(the transposes of a tiled all-gather and a reduce-scatter are each
other) plus a bidirectional ring accumulation of ``dw`` in f32.  The
products with an f32 result are ``layers.dot_f32``'s, and on the card
an f32 cotangent of a bf16 product (the vocab head's f32 logits) is
rounded to bf16 first by its rule (``layers.f32_cotangent``), so every
gradient product runs on the tensor cores.

The hops of a round travel in one ``batch_isend_irecv`` (both
directions together, so neither gloo nor NCCL can deadlock on their
order) on a ``collectives.CommStream``: round t + 1's hops are issued
before round t's block matmuls, and the compute waits on a round's
blocks only just before their matmul, so on the card each hop runs
beside the previous round's matmuls and on the CPU beside them on
gloo's thread.

``fake_compute`` keeps every hop and replaces each block matmul with
``comm_stub`` (the comm-only leg of the SPMD step's A/B decomposition);
``fake_comm`` makes every hop the identity (each "received" block is
the local one again: the compute-only leg with the full schedule's
FLOPs).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from dlnetbench_tpu_torch.models import layers as Lyr
from dlnetbench_tpu_torch.parallel import collectives as col

_F32 = torch.float32


def comm_stub(shape, dtype, *deps) -> torch.Tensor:
    """Shape-correct stand-in whose value depends (cheaply) on every
    ``dep``: the dataflow edges of the real compute stay, so the comm
    variant's collectives are issued as the full program's are."""
    s = sum(d.reshape(-1)[0].to(_F32) for d in deps)
    return s.expand(tuple(shape)).to(dtype)


def _bidir_sources(n: int) -> tuple[int, int]:
    """Hop schedule of a bidirectional ring gather: at hop t this rank
    receives the block of rank ``me - t`` over the +1 direction and (for
    the first ``floor((n-1)/2)`` hops) rank ``me + t`` over -1."""
    down = (n - 1 + 1) // 2   # blocks arriving from below (me-1, me-2, ..)
    up = (n - 1) // 2         # blocks arriving from above (me+1, me+2, ..)
    return down, up


def _out_dtype(a, w, pet):
    return pet if pet is not None else torch.promote_types(a.dtype, w.dtype)


def dot(a: torch.Tensor, w: torch.Tensor, pet=None) -> torch.Tensor:
    """``a @ w`` (w 2-D) in ``pet`` or the promoted dtype: an f32 result
    through ``layers.dot_f32`` (two bf16 operands on the card in one
    product with an f32 output), every other pair cast to the result
    dtype first."""
    dt = _out_dtype(a, w, pet)
    if dt == _F32:
        out = Lyr.dot_f32(a.reshape(-1, a.shape[-1]), w)
        return out.reshape(*a.shape[:-1], w.shape[-1])
    return a.to(dt) @ w.to(dt)


def _block_mm(xblk, w, chunks: int, row_axis: int, pet, fake: bool):
    """One ring block's matmul, split into ``chunks`` row slices."""
    if fake:
        return comm_stub(xblk.shape[:-1] + (w.shape[-1],),
                         _out_dtype(xblk, w, pet), xblk, w)
    size = xblk.shape[row_axis]
    if chunks <= 1 or size < 2:
        return dot(xblk, w, pet)
    bounds = [round(i * size / chunks) for i in range(chunks + 1)]
    parts = [dot(xblk.narrow(row_axis, lo, hi - lo), w, pet)
             for lo, hi in zip(bounds, bounds[1:]) if hi > lo]
    return torch.cat(parts, dim=row_axis)


def _contract_dw(ablk, dblk, fake: bool):
    """dw of one block pair: every dim but the last contracted
    (``[..., s, d] x [..., s, k] -> [d, k]``), summed in f32 (the ring
    adds the blocks' terms in f32; the caller casts once)."""
    if fake:
        return comm_stub((ablk.shape[-1], dblk.shape[-1]), _F32, ablk,
                         dblk)
    a2 = ablk.reshape(-1, ablk.shape[-1])
    d2 = dblk.reshape(-1, dblk.shape[-1])
    return dot(a2.t(), d2, _F32)


class _Ring:
    """The hops of one decomposed op: ``start`` issues a round's hops
    (``(tensor, offset)`` pairs, one batch) on a comm stream and returns
    a token; ``wait`` hands back the received tensors.  With
    ``fake_comm`` every hop is the identity."""

    def __init__(self, group, device, fake_comm: bool):
        self.group, self.fake = group, fake_comm
        self.stream = None if fake_comm else col.CommStream(device)

    def start(self, sends: list):
        if self.fake:
            return None, [x for x, _ in sends]
        xs = [x.contiguous() for x, _ in sends]
        outs = [torch.empty_like(x, memory_format=torch.contiguous_format)
                for x in xs]
        tok = self.stream.issue(col.permute, outs, xs, group=self.group,
                                offsets=[k for _, k in sends])
        return tok, outs

    def wait(self, pending) -> list:
        tok, outs = pending
        if tok is not None:
            self.stream.wait(tok)
        return outs


def _rotations(x_like, group, ring: _Ring, use) -> None:
    """The bidirectional ring over ``x_like``'s blocks: ``use(blk, src)``
    for this rank's block, then for every peer block as it lands (src =
    the rank it came from); round t + 1's hops are issued before round
    t's ``use`` calls."""
    n = col.group_size(group)
    me = dist.get_rank(group)
    down, up = _bidir_sources(n)
    rounds = max(down, up)

    def sends(below, above, t):
        out = []
        if t <= down:
            out.append((below, +1))
        if t <= up:
            out.append((above, -1))
        return out

    pending = ring.start(sends(x_like, x_like, 1)) if rounds else None
    use(x_like, me)
    below = above = x_like
    for t in range(1, rounds + 1):
        got = ring.wait(pending)
        if t <= down:
            below = got[0]
        if t <= up:
            above = got[-1]
        if t < rounds:
            pending = ring.start(sends(below, above, t + 1))
        if t <= down:
            use(below, (me - t) % n)
        if t <= up:
            use(above, (me + t) % n)


def _ag_impl(x, w, group, gather_axis, chunks, fk_compute, fk_comm, pet):
    n = col.group_size(group)
    if n == 1:
        return _block_mm(x, w, chunks, gather_axis, pet, fk_compute)
    s_loc = x.shape[gather_axis]
    out_shape = (x.shape[:gather_axis] + (n * s_loc,)
                 + x.shape[gather_axis + 1:-1] + (w.shape[-1],))
    out = x.new_empty(out_shape, dtype=_out_dtype(x, w, pet))

    def use(blk, src):
        out.narrow(gather_axis, src * s_loc, s_loc).copy_(
            _block_mm(blk, w, chunks, gather_axis, pet, fk_compute))

    _rotations(x, group, _Ring(group, x.device, fk_comm), use)
    return out


def _ring_dw(x_like, other, group, gather_axis, fk_compute, fk_comm,
             rotate_first: bool):
    """Bidirectional-ring dw accumulation: ``x_like``'s blocks rotate
    around the ring and each is contracted against the matching slice of
    ``other`` (``rotate_first``: all_gather_matmul's dw, x rotates and
    dout is full), or the roles flip (matmul_reduce_scatter's dw: dout
    rotates, a is full)."""
    s_loc = x_like.shape[gather_axis]
    acc = []

    def use(blk, src):
        sel = other.narrow(gather_axis, src * s_loc, s_loc)
        c = (_contract_dw(blk, sel, fk_compute) if rotate_first
             else _contract_dw(sel, blk, fk_compute))
        acc.append(c if not acc else acc.pop() + c)

    if col.group_size(group) == 1:
        use(x_like, 0)
        return acc[0]
    _rotations(x_like, group, _Ring(group, x_like.device, fk_comm), use)
    return acc[0]


def _rs_impl(a, w, group, scatter_axis, chunks, fk_compute, fk_comm, pet):
    n = col.group_size(group)
    if n == 1:
        return _block_mm(a, w, chunks, scatter_axis, pet, fk_compute)
    me = dist.get_rank(group)
    s_loc = a.shape[scatter_axis] // n

    def blk(b, wpart):
        ab = a.narrow(scatter_axis, b * s_loc, s_loc)
        return _block_mm(ab, wpart, chunks, scatter_axis, pet, fk_compute)

    kh = w.shape[-1] // 2
    halves = ([(w, +1)] if kh == 0
              else [(w[:, :kh], +1), (w[:, kh:], -1)])
    ring = _Ring(group, a.device, fk_comm)
    # ring reduce-scatter: block b starts at rank b + direction and
    # picks up each rank's partial on its way to rank b; at hop t this
    # rank's partial is for block me - direction * (1 + t)
    accs = [blk((me - d) % n, wp) for wp, d in halves]
    for t in range(1, n):
        pending = ring.start([(acc, d) for acc, (_, d) in zip(accs, halves)])
        parts = [blk((me - d * (1 + t)) % n, wp) for wp, d in halves]
        got = ring.wait(pending)
        accs = [g + p for g, p in zip(got, parts)]
    return accs[0] if len(accs) == 1 else torch.cat(accs, dim=-1)


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, gather_axis, chunks, fk_compute,
                fk_comm, pet):
        ctx.save_for_backward(x, w)
        ctx.args = (group, gather_axis, chunks, fk_compute, fk_comm)
        return _ag_impl(x, w, group, gather_axis, chunks, fk_compute,
                        fk_comm, pet)

    @staticmethod
    def backward(ctx, dout):
        x, w = ctx.saved_tensors
        group, axis, chunks, fkc, fkm = ctx.args
        dout = Lyr.f32_cotangent(dout, x, w)
        # the transpose of a tiled all-gather is a reduce-scatter: dx is
        # the sibling decomposed op, so the backward overlaps the same way
        dx = _rs_impl(dout, w.t(), group, axis, chunks, fkc, fkm, None)
        dw = _ring_dw(x, dout, group, axis, fkc, fkm, rotate_first=True)
        return (dx.to(x.dtype), dw.to(w.dtype), None, None, None, None,
                None, None)


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, group, scatter_axis, chunks, fk_compute,
                fk_comm, pet):
        ctx.save_for_backward(a, w)
        ctx.args = (group, scatter_axis, chunks, fk_compute, fk_comm)
        return _rs_impl(a, w, group, scatter_axis, chunks, fk_compute,
                        fk_comm, pet)

    @staticmethod
    def backward(ctx, dout):
        a, w = ctx.saved_tensors
        group, axis, chunks, fkc, fkm = ctx.args
        dout = Lyr.f32_cotangent(dout, a, w)
        # the transpose of a tiled reduce-scatter is an all-gather
        da = _ag_impl(dout, w.t(), group, axis, chunks, fkc, fkm, None)
        dw = _ring_dw(dout, a, group, axis, fkc, fkm, rotate_first=False)
        return (da.to(a.dtype), dw.to(w.dtype), None, None, None, None,
                None, None)


def all_gather_matmul(x, w, group, *, gather_axis: int = 1,
                      chunks: int = 1, fake_compute: bool = False,
                      fake_comm: bool = False, out_dtype=None):
    """``all_gather(x, gather_axis) @ w`` as a bidirectional ring of
    hops interleaved with the block matmuls; ``w`` 2-D, contracted with
    x's last dim; ``out_dtype`` the JAX ``preferred_element_type``."""
    if w.dim() != 2:
        raise ValueError(f"w must be 2-D, got {tuple(w.shape)}")
    return _AllGatherMatmul.apply(x, w, group, int(gather_axis),
                                  int(chunks), bool(fake_compute),
                                  bool(fake_comm), out_dtype)


def matmul_reduce_scatter(a, w, group, *, scatter_axis: int = 1,
                          chunks: int = 1, fake_compute: bool = False,
                          fake_comm: bool = False, out_dtype=None):
    """``psum_scatter(a @ w, scatter_axis)`` as a bidirectional ring
    reduce-scatter whose hops overlap the next block's partial matmul;
    sums in ring order (f32 reduction tolerance against the fused
    path)."""
    if w.dim() != 2:
        raise ValueError(f"w must be 2-D, got {tuple(w.shape)}")
    return _MatmulReduceScatter.apply(a, w, group, int(scatter_axis),
                                      int(chunks), bool(fake_compute),
                                      bool(fake_comm), out_dtype)
