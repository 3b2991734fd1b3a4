"""Sequence-parallel attention for the SPMD step (the JAX package's
``ops/sequence_parallel.py``): ring and Ulysses, on a group that shards
the sequence.

* ``ring_attention`` — blockwise online-softmax attention: the KV shards
  rotate around the ring (one ``collectives.ppermute`` a hop, K and V
  packed into one tensor) while f32 accumulators (running max, sum,
  output) merge one KV block per hop.  A hop whose whole (my queries x
  remote keys) tile the mask kills — strictly-future shards under
  causality, keys beyond a window, foreign segments — skips its
  compute (the host-side verdict table
  ``attention_mask.ring_hop_work``); its rotation always runs, so every
  rank issues the same hops.  Like the JAX package it rotates n - 1
  times: the n-th hop would only feed a discarded carry.  Plain torch
  math (the JAX package's is plain XLA), differentiated by autograd
  through the ``ppermute``s, whose backward is the inverse rotation (a
  skipped hop keeps its received block in the graph through an exact
  zero, so every rank runs every inverse hop).
  The hops are issued synchronously: a hop does not overlap the merge
  beside it.
* ``ulysses_attention`` — ``all_to_all`` from sequence-sharded to
  head-sharded, full-sequence local attention through ``ops.attention``
  (kernels K3/K4/K5 on the card, K6/K7/K8 under a mask), and back.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from dlnetbench_tpu_torch.parallel import collectives as col

_F32 = torch.float32
_NEG_INF = -1e30


def _block_scores(q, k, scale):
    """Grouped (GQA) scores: q ``[B, Sq, Hq, Dh]``, k ``[B, Sk, Hkv, Dh]``
    -> ``[B, Hkv, G, Sq, Sk]`` f32 (q scaled in its own dtype, then f32
    products, as the JAX package's ``preferred_element_type``)."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = (q.reshape(b, sq, hkv, hq // hkv, dh) * scale).to(_F32)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(_F32))


def ring_attention(q, k, v, group, causal: bool = True, spec=None):
    """Ring attention over ``group``; every input sequence-sharded.

    q ``[B, S/n, Hq, Dh]``, k/v ``[B, S/n, Hkv, Dh]`` (this rank's shard
    of the sequence, all heads) -> ``[B, S/n, Hq, Dh]``.  ``spec`` (a
    ``MaskSpec``) turns on the mask and its hop skipping; plain causal
    skips the strictly-future hops.  A skipped merge is the f32
    identity (the first, diagonal hop leaves every row a finite max, so
    a masked score's probability is exactly 0)."""
    from dlnetbench_tpu_torch.ops import attention_mask as amask

    b, s_loc, hq, dh = q.shape
    hkv = k.shape[2]
    n = col.group_size(group)
    me = dist.get_rank(group)
    scale = 1.0 / (dh ** 0.5)
    s_full = n * s_loc
    dev = q.device
    q_pos = me * s_loc + torch.arange(s_loc, device=dev)

    if spec is not None and spec.causal != causal:
        raise ValueError(
            f"ring_attention: mask spec {spec.label()!r} has "
            f"causal={spec.causal} but the call says causal={causal}")
    masked = spec is not None and not spec.is_plain_causal
    work = None
    if spec is not None or causal:
        work = amask.ring_hop_work(spec if masked else None, s_full, n)
    seg_ids = None
    if masked and spec.seg_avg:
        seg_ids = torch.as_tensor(
            amask.segment_ids(spec.seg_seed, spec.seg_avg, s_full),
            device=dev)

    g = hq // hkv
    m = torch.full((b, hkv, g, s_loc), _NEG_INF, dtype=_F32, device=dev)
    l = torch.zeros((b, hkv, g, s_loc), dtype=_F32, device=dev)
    acc = torch.zeros((b, hkv, g, s_loc, dh), dtype=_F32, device=dev)

    def merge(k_cur, v_cur, m, l, acc, src):
        s = _block_scores(q, k_cur, scale)
        k_pos = src * s_loc + torch.arange(s_loc, device=dev)
        if masked:
            mask = amask.allowed(spec, q_pos[:, None], k_pos[None, :],
                                 seg_ids=seg_ids)
            s = torch.where(mask, s, _NEG_INF)
        elif causal:
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_cur.dtype).to(_F32),
                          v_cur.to(_F32))
        return m_new, l, acc * alpha[..., None] + pv

    kv = torch.stack([k, v])
    perm = col.ring_perm(n, 1)
    for t in range(n):
        src = (me - t) % n
        if work is None or work[me, src]:
            m, l, acc = merge(kv[0], kv[1], m, l, acc, src)
        else:
            # a skipped hop adds an exact zero that depends on the block
            # it received: every rank's rotations then stay in its graph,
            # so every rank runs the inverse hops in backward (a rank
            # whose received blocks fed nothing would skip them and
            # leave its peers waiting)
            acc = acc + kv.reshape(-1)[0].to(_F32) * 0.0
        if t < n - 1:
            kv = col.ppermute(kv, group, perm)
    out = acc / l[..., None]                          # [B, Hkv, G, Sq, Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s_loc, hq, dh).to(q.dtype)


def ulysses_attention(q, k, v, group, causal: bool = True,
                      impl: str = "auto", spec=None):
    """Ulysses over ``group``: q ``[B, S/n, Hq, Dh]`` -> the same, through
    a head-sharded full-sequence local attention (``ops.attention`` with
    ``impl`` and ``spec``); both head counts divide by the group's
    size."""
    from dlnetbench_tpu_torch import ops

    def seq_to_heads(x):
        return col.all_to_all(x, group, split=2, concat=1)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    out = ops.attention(qh, kh, vh, causal=causal, impl=impl, mask=spec)
    return col.all_to_all(out, group, split=1, concat=2)
