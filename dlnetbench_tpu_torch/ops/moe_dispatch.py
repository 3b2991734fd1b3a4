"""Decomposed MoE all-to-alls (the JAX package's ``ops/moe_dispatch.py``):
the dispatch and combine all-to-alls of the SPMD step's expert-parallel
block as per-peer hops interleaved with the expert FFN.

    own block first (my experts' share of my tokens: no wire), then
    for each offset t (bidirectional: half the peers over each
    direction):
      dispatch hop   send my tokens for rank me+t, receive rank me-t's
      expert FFN     my experts over the block that landed
      combine hop    the results go back; my tokens' results from rank
                     me+t arrive

The dispatch hop of the next offset depends only on the input, so it is
issued before this offset's FFN; ``chunks`` splits each block's FFN
along the capacity axis.  Per-rank wire volume is the monolithic
pair's.  ``a2a_expert_ffn`` is a ``torch.autograd.Function``: its
backward runs the transposed loop (the result cotangents travel to the
rank that computed them, each block's FFN is recomputed from the saved
received block and differentiated as it lands, and the input
cotangents travel home).  ``ffn_impl`` ("einsum" or "grouped", kernel
K12 on the card), ``quant`` and ``mlp_int8`` follow
``models/moe.expert_ffn``; ``fake_compute`` / ``fake_comm`` are the A/B
legs of ``collective_matmul``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from dlnetbench_tpu_torch.ops.collective_matmul import (_bidir_sources,
                                                        _Ring, comm_stub)
from dlnetbench_tpu_torch.parallel import collectives as col

_F32 = torch.float32


def _ffn_block(xblk, wg, wu, wd, chunks: int, ffn_impl: str, quant,
               mlp_int8: bool, fake: bool):
    """One peer block's expert FFN (``[eloc, C, d] -> [eloc, C, d]``
    f32), ``chunks`` slices along the capacity axis."""
    if fake:
        return comm_stub(xblk.shape, _F32, xblk, wg, wu, wd)
    from dlnetbench_tpu_torch.models.moe import expert_ffn

    def ffn(b):
        return expert_ffn(b, wg, wu, wd, impl=ffn_impl, quant=quant,
                          mlp_int8=mlp_int8)

    c = xblk.shape[1]
    if chunks <= 1 or c < 2:
        return ffn(xblk)
    bounds = [round(i * c / chunks) for i in range(chunks + 1)]
    parts = [ffn(xblk[:, lo:hi]) for lo, hi in zip(bounds, bounds[1:])
             if hi > lo]
    return torch.cat(parts, dim=1)


def _offsets(n: int) -> list:
    """(offset, direction) pairs: the first ``down`` peers arrive over
    the +1 direction, the rest over -1."""
    down, up = _bidir_sources(n)
    out = []
    for t in range(1, max(down, up) + 1):
        if t <= down:
            out.append((t, +1))
        if t <= up:
            out.append((t, -1))
    return out


def _blk(buf, idx: int, eloc: int):
    return buf[idx * eloc:(idx + 1) * eloc]


def _loop(ein, group, fk_comm: bool, compute):
    """The fused loop over peer blocks.  ``compute(block, src)`` maps the
    block that landed from ``src`` to this rank's result for it; returns
    the per-destination results that came back, keyed by block index
    (this rank's own first)."""
    n = col.group_size(group)
    me = dist.get_rank(group)
    eloc = ein.shape[0] // n
    ring = _Ring(group, ein.device, fk_comm)
    back = {me: compute(_blk(ein, me, eloc), me)}
    offs = _offsets(n)

    def dispatch(i):
        t, direction = offs[i]
        dst = (me + direction * t) % n
        return ring.start([(_blk(ein, dst, eloc), direction * t)])

    pending = dispatch(0) if offs else None
    combines = []
    for i, (t, direction) in enumerate(offs):
        src = (me - direction * t) % n
        dst = (me + direction * t) % n
        landed = ring.wait(pending)[0]
        if i + 1 < len(offs):
            pending = dispatch(i + 1)
        res = compute(landed, src)
        combines.append((dst, ring.start([(res, -direction * t)])))
    for dst, tok in combines:
        back[dst] = ring.wait(tok)[0]
    return back


def _assemble(back: dict, like_shape, dtype, device, eloc: int):
    out = torch.zeros(like_shape, dtype=dtype, device=device)
    for idx, val in back.items():
        out[idx * eloc:(idx + 1) * eloc] = val
    return out


class _A2AExpertFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ein, wg, wu, wd, group, chunks, fk_compute, fk_comm,
                ffn_impl, quant, mlp_int8):
        n = col.group_size(group)
        eloc = ein.shape[0] // n
        args = (chunks, ffn_impl, quant, mlp_int8, fk_compute)
        recv = {}

        def compute(blk, src):
            recv[src] = blk
            return _ffn_block(blk, wg, wu, wd, *args)

        back = _loop(ein, group, fk_comm, compute)
        ctx.save_for_backward(
            _assemble(recv, ein.shape, ein.dtype, ein.device, eloc),
            wg, wu, wd)
        ctx.args = (group, fk_comm, args)
        return _assemble(back, ein.shape, _F32, ein.device, eloc)

    @staticmethod
    def backward(ctx, dout):
        recv, wg, wu, wd = ctx.saved_tensors
        group, fk_comm, args = ctx.args
        fk_compute = args[-1]
        n = col.group_size(group)
        eloc = recv.shape[0] // n
        dws = []

        def block_vjp(dblk, src):
            xblk = _blk(recv, src, eloc)
            if fk_compute:
                gs = [comm_stub(xblk.shape, xblk.dtype, xblk, dblk)] + [
                    comm_stub(w.shape, w.dtype, xblk, dblk)
                    for w in (wg, wu, wd)]
            else:
                with torch.enable_grad():
                    leaves = [t.detach().requires_grad_(True)
                              for t in (xblk, wg, wu, wd)]
                    y = _ffn_block(*leaves, *args)
                    gs = torch.autograd.grad(y, leaves, dblk.to(_F32))
            dws.append(gs[1:] if not dws else
                       [a + b for a, b in zip(dws.pop(), gs[1:])])
            return gs[0].to(recv.dtype)

        # combine^T: my cotangent for rank dst's results travels out (the
        # dispatch loop over dout); dispatch^T brings each dx home
        back = _loop(dout, group, fk_comm, block_vjp)
        d_ein = _assemble(back, recv.shape, recv.dtype, recv.device, eloc)
        dwg, dwu, dwd = dws[0]
        return (d_ein, dwg.to(wg.dtype), dwu.to(wu.dtype),
                dwd.to(wd.dtype), None, None, None, None, None, None, None)


def a2a_expert_ffn(ein, w_gate, w_up, w_down, group, *, chunks: int = 1,
                   fake_compute: bool = False, fake_comm: bool = False,
                   ffn_impl: str = "einsum", quant: str | None = None,
                   mlp_int8: bool = False):
    """``combine_a2a(expert_ffn(dispatch_a2a(ein)))`` as one fused loop of
    per-peer hops over ``group``.

    ``ein`` ``[E, C, d]``: this rank's dispatch buffers over the global
    expert set, experts sharded over the group (E divides by its size),
    the local expert weights ``[E/n, ...]``.  Returns the combined ``[E,
    C, d]`` f32 buffer in the monolithic layout (block r: rank r's
    experts' results for my tokens)."""
    if w_gate.dim() != 3:
        raise ValueError(f"a2a_expert_ffn: expert weights must be "
                         f"[E_local, d, h], got {tuple(w_gate.shape)}")
    return _A2AExpertFFN.apply(ein, w_gate, w_up, w_down, group,
                               int(chunks), bool(fake_compute),
                               bool(fake_comm), str(ffn_impl), quant,
                               bool(mlp_int8))
