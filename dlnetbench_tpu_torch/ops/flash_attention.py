"""Kernels K3, K4, K5: flash attention forward, dq and dk/dv (the port of
the JAX package's ``ops/flash_attention.py`` ``_fwd_kernel`` (:126),
``_dq_kernel`` (:242) and ``_dkv_kernel`` (:279)); and K6, K7, K8, the
same three under a block-sparse mask (``_splash_fwd_kernel`` (:648),
``_splash_dq_kernel`` (:761), ``_splash_dkv_kernel`` (:802)).

``flash_attention(q, k, v, causal)`` is the op: a
``torch.autograd.Function`` whose forward saves q, k, v, O and lse and
whose backward computes dq, dk, dv.  On CUDA tensors it launches the
hand-written Hopper kernels of ``csrc/flash_attention.cu`` (counted in
``fwd_launches``, ``dq_launches`` and ``dkv_launches``); on CPU tensors
it runs ``plain_forward`` and ``plain_backward``, the plain PyTorch
versions, which hold the kernels' algorithm: the base-2 softmax with
q * scale * log2(e) rounded to the input type, the natural-log lse, and
the backward's recomputation p = exp(s - lse), D = rowsum(dO * O),
ds = p * (dp - D) * scale with q * scale rounded — not autograd through
a forward.  There is no fall back from the card to the plain versions.

Shapes (the JAX package's layout): q ``[B, S, Hq, Dh]``, k/v ``[B, S,
Hkv, Dh]``, ``Hq % Hkv == 0``; lse ``[B, Hq, S]`` f32.  The kernels take
Dh 64 or 128 and S a multiple of 128, in bfloat16 (tensor cores) or
float32 (CUDA cores, for small reference models).

``splash_attention(q, k, v, spec)`` is the masked op, with the same
tensor contract and a ``MaskSpec`` (``ops/attention_mask.py``) in place of
the ``causal`` flag.  On CUDA tensors it launches K6/K7/K8 (counted in
``splash_fwd_launches``, ``splash_dq_launches``, ``splash_dkv_launches``),
each reading the BlockMask built at its own tiles (``FWD_TILES``,
``DQ_TILES``, ``DKV_TILES``; the CUDA source's constants), copied to the
card once per (spec, S, tiles, device) and cached (``splash_arrays``).
On CPU tensors it runs ``plain_splash_forward`` / ``plain_splash_backward``:
K3-K5's formulas and rounding points with the row intervals in place of
the causal mask, walked in q chunks of ``SPLASH_CHUNK`` rows over each
chunk's key range, so memory is O(chunk x range) and never S x S.  Under
the plain-causal spec the plain splash versions are the plain flash
versions (as K6/K7/K8 are then bitwise K3/K4/K5).

The four ops consult the tuning DB (``consult_tiles``: ops ``flash_fwd``,
``flash_bwd``, ``splash_fwd``, ``splash_bwd`` under the JAX package's keys
and field names).  Each card kernel is compiled for one tile, so the
only config a DB may name is that tile (``FWD_CONFIG``, ``BWD_CONFIG``):
a hit naming another is refused, and tile variants are kernel work.

Bound on the H100 at the training shape: operations (each kernel does
0.6-1.2e12 FLOP on ~0.3 GB); the design notes are in the CUDA source.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from dlnetbench_tpu_torch.ops import _build
from dlnetbench_tpu_torch.ops import attention_mask as amask
from dlnetbench_tpu_torch.ops.common import on_card

_F32 = torch.float32
NEG_INF = -1e30                 # finite mask: masked rows never give NaN
LOG2E = 1.4426950408889634
LONG_SEQ = 64 * 1024            # the JAX package's dense-fallback limit
SEQ_MULTIPLE = 128              # the kernels' (and the JAX blocks') unit
HEAD_DIMS = (64, 128)

# the C entries' dtype codes (csrc/flash_attention.cu, enum Dtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the kernels' tiles (q rows, keys) in csrc/flash_attention.cu: the
# forward kBQ x kBKf, dq kBQ x kBK, dk/dv kBQ x kBKd; each splash kernel
# reads the BlockMask built at its own
FWD_TILES = (64, 128)
DQ_TILES = (64, 64)
DKV_TILES = (64, 128)
SPLASH_CHUNK = 512              # q rows a plain-splash chunk takes

# kernel launches made by the ops (reset by the caller)
fwd_launches = 0
dq_launches = 0
dkv_launches = 0
splash_fwd_launches = 0
splash_dq_launches = 0
splash_dkv_launches = 0
# calls ops.attention took on the card off the kernels: the dense einsum
# route, for a sequence no 128-row tile divides (ViT's 197 and 257)
dense_attention_calls = 0


def flash_supported(q, k, v) -> bool:
    """Shape gate: the sequence divides into 128-row tiles, the head dim
    is one the kernels take, and the q heads group over the KV heads."""
    del v
    s, hq, dh = q.shape[1], q.shape[2], q.shape[3]
    return s % SEQ_MULTIPLE == 0 and dh in HEAD_DIMS and hq % k.shape[2] == 0


def check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention: q {tuple(q.shape)} must be "
                         f"[B, S, Hq, Dh] and k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} [B, S, Hkv, Dh]")
    b, s, hq, dh = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, dh):
        raise ValueError(f"flash attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if not flash_supported(q, k, v):
        raise ValueError(
            f"flash attention: unsupported shape (seq_len {s} must be a "
            f"multiple of {SEQ_MULTIPLE}, head_dim {dh} one of "
            f"{HEAD_DIMS}, Hq={hq} a multiple of Hkv={k.shape[2]}); use "
            f"ops.attention(..., impl='auto')")


def check_operands(*tensors) -> None:
    """What the kernels take on the card; anything else raises before a
    launch."""
    q = tensors[0]
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash attention: dtype {q.dtype} (float32 or "
                         f"bfloat16)")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"flash attention: operands on {t.device} "
                             f"and {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash attention: mixed dtypes {t.dtype} "
                             f"and {q.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash attention: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("flash attention: operands must be 16-byte "
                             "aligned")


# --------------------------------------------------------- plain versions

def _heads(b: int, hkv: int, group: int):
    """(batch, kv head, q-head slice) for the per-group loops that bound
    the plain versions' memory to one [G, S, S] score block."""
    for bi in range(b):
        for h in range(hkv):
            yield bi, h, slice(h * group, (h + 1) * group)


def _causal_mask(s: int, device) -> torch.Tensor:
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def plain_forward(q, k, v, causal: bool):
    """``(O, lse)`` by the forward kernel's formulas over the whole row
    at once: base-2 softmax of (q * scale * log2 e rounded) . k with the
    finite mask, f32 sums, p rounded to v's dtype before p . v, lse back
    in natural log."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qs = (q.to(_F32) * (dh ** -0.5 * LOG2E)).to(q.dtype).to(_F32)
    mask = _causal_mask(s, q.device) if causal else None
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=_F32, device=q.device)
    for bi, h, sl in _heads(b, hkv, g):
        sc = qs[bi, :, sl].transpose(0, 1) @ k[bi, :, h].to(_F32).T
        if mask is not None:
            sc = sc.masked_fill(~mask, NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp2(sc - m)
        l = p.sum(dim=-1, keepdim=True)
        o = (p.to(v.dtype).to(_F32) @ v[bi, :, h].to(_F32)) / l
        out[bi, :, sl] = o.transpose(0, 1).to(q.dtype)
        lse[bi, sl] = (m[..., 0] + torch.log2(l[..., 0])) / LOG2E
    return out, lse


def _recompute(q, k, v, dout, lse, dcap, causal: bool):
    """Per (batch, KV head, q-head slice): K, dO, p and ds by the
    backward kernels' formulas — s from q * scale rounded to the input
    type, p = exp(s - lse), ds = p * (dp - D) * scale rounded to the
    input type; ``[G, S, S]`` f32 blocks."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    scale = dh ** -0.5
    qs = (q.to(_F32) * scale).to(q.dtype).to(_F32)
    mask = _causal_mask(s, q.device) if causal else None
    for bi, h, sl in _heads(b, hkv, hq // hkv):
        kh, vh = k[bi, :, h].to(_F32), v[bi, :, h].to(_F32)
        doh = dout[bi, :, sl].transpose(0, 1).to(_F32)           # [G, S, D]
        sc = qs[bi, :, sl].transpose(0, 1) @ kh.T
        if mask is not None:
            sc = sc.masked_fill(~mask, NEG_INF)
        p = torch.exp(sc - lse[bi, sl][..., None])
        ds = p * (doh @ vh.T - dcap[bi, sl][..., None]) * scale
        yield bi, h, sl, kh, doh, p, ds.to(q.dtype).to(_F32)


def plain_dq(q, k, v, out, lse, dout, causal: bool):
    """``(dq, D)``: D = rowsum(dO * O) in f32 as ``[B, Hq, S]`` and
    dq = ds . K (the dq kernel's work)."""
    dcap = (dout.to(_F32) * out.to(_F32)).sum(dim=-1).transpose(1, 2) \
        .contiguous()
    dq = torch.empty_like(q)
    for bi, _, sl, kh, _, _, ds in _recompute(q, k, v, dout, lse, dcap,
                                              causal):
        dq[bi, :, sl] = (ds @ kh).transpose(0, 1).to(q.dtype)
    return dq, dcap


def plain_dkv(q, k, v, dout, lse, dcap, causal: bool):
    """``(dk, dv)``: dk = ds^T . q and dv = p^T . dO (p rounded to the
    input type), summed over each KV head's q-head group in f32 (the
    dk/dv kernel's work)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for bi, h, sl, _, doh, p, ds in _recompute(q, k, v, dout, lse, dcap,
                                               causal):
        qh = q[bi, :, sl].transpose(0, 1).to(_F32)
        dk[bi, :, h] = (ds.transpose(1, 2) @ qh).sum(dim=0).to(k.dtype)
        pr = p.to(dout.dtype).to(_F32)
        dv[bi, :, h] = (pr.transpose(1, 2) @ doh).sum(dim=0).to(v.dtype)
    return dk, dv


def plain_backward(q, k, v, out, lse, dout, causal: bool):
    """``(dq, dk, dv)`` by the backward kernels' recomputation (not
    autograd through a forward)."""
    dq, dcap = plain_dq(q, k, v, out, lse, dout, causal)
    return (dq, *plain_dkv(q, k, v, dout, lse, dcap, causal))


# ---------------------------------------------------------------- kernels

def _fn(name: str, n_ptr: int):
    fn = getattr(_build.library("flash_attention"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * 6 + [ctypes.c_float,
                                               ctypes.c_void_p])
    return fn


def _call(name: str, n_ptr: int, q, k, ptrs, causal: bool) -> None:
    b, s, hq, dh = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _fn(name, n_ptr)(DTYPE_CODES[q.dtype], *ptrs, b, s, hq,
                              k.shape[2], dh, int(causal), dh ** -0.5,
                              stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel {name}: cudaError_t "
                           f"{rc} (q {tuple(q.shape)} {q.dtype}, k "
                           f"{tuple(k.shape)})")


def kernel_forward(q, k, v, causal: bool):
    """K3 on the card: ``(O, lse)``."""
    global fwd_launches
    check_shapes(q, k, v)
    check_operands(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=_F32,
                      device=q.device)
    _call("dlnb_flash_fwd", 5, q, k, [q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), out.data_ptr(),
                                      lse.data_ptr()], causal)
    fwd_launches += 1
    return out, lse


def _check_rows(q, *rows) -> None:
    want = (q.shape[0], q.shape[2], q.shape[1])
    for r in rows:
        if r.dtype != _F32 or r.shape != want or not r.is_contiguous() \
                or r.device != q.device:
            raise ValueError(f"flash attention: lse and D must be "
                             f"contiguous f32 {list(want)} on {q.device}, "
                             f"got {r.dtype} {tuple(r.shape)} on "
                             f"{r.device}")
        if r.data_ptr() % 16:
            # K5 and K8 load 64-row runs of them by 16-byte bulk copies
            raise ValueError("flash attention: lse and D must be 16-byte "
                             "aligned")


def kernel_dq(q, k, v, out, lse, dout, causal: bool):
    """K4 on the card: ``(dq, D)``, D = rowsum(dO * O) ``[B, Hq, S]``."""
    global dq_launches
    check_shapes(q, k, v)
    check_operands(q, k, v, out, dout)
    _check_rows(q, lse)
    dcap = torch.empty_like(lse)
    dq = torch.empty_like(q)
    _call("dlnb_flash_dq", 8, q, k,
          [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           dout.data_ptr(), lse.data_ptr(), dcap.data_ptr(),
           dq.data_ptr()], causal)
    dq_launches += 1
    return dq, dcap


def kernel_dkv(q, k, v, dout, lse, dcap, causal: bool):
    """K5 on the card: ``(dk, dv)``, reading the D that K4 wrote."""
    global dkv_launches
    check_shapes(q, k, v)
    check_operands(q, k, v, dout)
    _check_rows(q, lse, dcap)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("dlnb_flash_dkv", 8, q, k,
          [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           lse.data_ptr(), dcap.data_ptr(), dk.data_ptr(), dv.data_ptr()],
          causal)
    dkv_launches += 1
    return dk, dv


def kernel_backward(q, k, v, out, lse, dout, causal: bool):
    """K4 then K5 on the card: ``(dq, dk, dv)``."""
    dq, dcap = kernel_dq(q, k, v, out, lse, dout, causal)
    return (dq, *kernel_dkv(q, k, v, dout, lse, dcap, causal))


def forward(q, k, v, causal: bool):
    """``(O, lse)``: K3 on a CUDA tensor, ``plain_forward`` on a CPU one."""
    if on_card(q):
        return kernel_forward(q, k, v, causal)
    check_shapes(q, k, v)
    return plain_forward(q, k, v, causal)


def backward(q, k, v, out, lse, dout, causal: bool):
    """``(dq, dk, dv)``: K4 + K5 on a CUDA tensor, ``plain_backward`` on
    a CPU one."""
    if on_card(q):
        return kernel_backward(q, k, v, out, lse, dout, causal)
    return plain_backward(q, k, v, out, lse, dout, causal)


# the tuning DB's configs of the four attention ops (the JAX package's
# field names) at the one tile each card kernel is compiled for
FWD_CONFIG = {"block_q": FWD_TILES[0], "block_k": FWD_TILES[1]}
BWD_CONFIG = {"bq_dq": DQ_TILES[0], "bk_dq": DQ_TILES[1],
              "bq_dkv": DKV_TILES[0], "bk_dkv": DKV_TILES[1]}


def consult_tiles(op: str, q, k, label, default: dict) -> dict:
    """The tuning DB's config for attention op ``op`` ("flash_fwd",
    "flash_bwd", "splash_fwd" or "splash_bwd") at q/k's shape (the JAX
    package's keys: ``label`` is ``causal`` for the flash ops, the
    ``MaskSpec.label()`` for the splash ones), or ``default``.  The card's
    kernels have one compiled tile each, so ``default`` is the only config
    they can take: a hit naming another tile is refused (with the JAX
    package's message shape), never run on another one."""
    from dlnetbench_tpu_torch import tuning
    if not tuning.enabled():
        return dict(default)
    b, s, hq, dh = q.shape
    if op.startswith("flash"):
        key = tuning.params.flash_fwd_key(b, s, hq, k.shape[2], dh, label,
                                          q.dtype)
    else:
        key = tuning.params.splash_key(b, s, hq, k.shape[2], dh, label,
                                       q.dtype)

    def check(cfg: dict) -> None:
        got = {name: cfg.get(name) for name in default}
        if got != default:
            raise ValueError(f"{op}: tuned blocks {got} are not the card "
                             f"kernel's one compiled tile {default}")
    return tuning.consult(op, key, default, validate=check, device=q.device)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal):
        consult_tiles("flash_fwd", q, k, bool(causal), FWD_CONFIG)
        out, lse = forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        consult_tiles("flash_bwd", q, k, bool(ctx.causal), BWD_CONFIG)
        dq, dk, dv = backward(q, k, v, out, lse, dout.contiguous(),
                              ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """Blockwise attention with the same contract as
    ``models.layers.attention``; differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal)


# ------------------------------------------------- splash (block-sparse)

def _check_spec(spec) -> None:
    if not isinstance(spec, amask.MaskSpec):
        raise ValueError(f"splash attention: spec must be a MaskSpec, got "
                         f"{spec!r}")


def _chunks(spec, s: int):
    """``(c0, c1, k0, k1, keep)`` per q chunk of ``SPLASH_CHUNK`` rows:
    rows [c0, c1), the keys [k0, k1) any of them sees (the intervals are
    monotone, so their union is one range) and the ``[C, k1 - k0]`` bool
    of the allowed pairs."""
    lo, hi = amask.row_intervals(spec, s)
    for c0 in range(0, s, SPLASH_CHUNK):
        c1 = min(s, c0 + SPLASH_CHUNK)
        yield (c0, c1, *_chunk_keys(lo, hi, c0, c1))


def _chunk_keys(lo, hi, c0: int, c1: int):
    k0, k1 = int(lo[c0:c1].min()), int(hi[c0:c1].max()) + 1
    kk = np.arange(k0, k1)
    keep = ((kk[None, :] >= lo[c0:c1, None])
            & (kk[None, :] <= hi[c0:c1, None]))
    return k0, k1, torch.from_numpy(keep)


def plain_splash_rows(q, k, v, spec, c0: int, c1: int):
    """``(O, lse)`` of query rows [c0, c1) only, ``[B, c1 - c0, Hq, Dh]``
    and ``[B, Hq, c1 - c0]``: the forward kernel's formulas (base-2
    softmax of q * scale * log2 e rounded to the input type, the finite
    mask, p rounded to v's dtype before p . v) over the keys the rows'
    intervals span.  Memory O(rows x range): it holds K6 at S=64k on
    sampled q tiles."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    lo, hi = amask.row_intervals(spec, s)
    k0, k1, keep = _chunk_keys(lo, hi, c0, c1)
    keep = keep.to(q.device)
    qs = (q[:, c0:c1].to(_F32) * (dh ** -0.5 * LOG2E)).to(q.dtype).to(_F32)
    out = torch.empty((b, c1 - c0, hq, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, c1 - c0), dtype=_F32, device=q.device)
    for bi, h, sl in _heads(b, hkv, hq // hkv):
        sc = qs[bi, :, sl].transpose(0, 1) @ k[bi, k0:k1, h].to(_F32).T
        sc = sc.masked_fill(~keep, NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp2(sc - m)
        l = p.sum(dim=-1, keepdim=True)
        o = (p.to(v.dtype).to(_F32) @ v[bi, k0:k1, h].to(_F32)) / l
        out[bi, :, sl] = o.transpose(0, 1).to(q.dtype)
        lse[bi, sl] = (m[..., 0] + torch.log2(l[..., 0])) / LOG2E
    return out, lse


def plain_splash_forward(q, k, v, spec):
    """``(O, lse)`` of masked attention, q chunk by q chunk
    (``plain_splash_rows``); the plain-causal spec is ``plain_forward``."""
    if spec.is_plain_causal:
        return plain_forward(q, k, v, True)
    s = q.shape[1]
    parts = [plain_splash_rows(q, k, v, spec, c0, min(s, c0 + SPLASH_CHUNK))
             for c0 in range(0, s, SPLASH_CHUNK)]
    return (torch.cat([o for o, _ in parts], dim=1),
            torch.cat([l for _, l in parts], dim=2))


def _splash_recompute(q, k, v, dout, lse, dcap, spec):
    """``_recompute`` chunk by chunk: per (q chunk, batch, KV head,
    q-head slice) the rows [c0, c1), keys [k0, k1) and their K, dO, p and
    ds ``[G, C, k1 - k0]`` by the backward kernels' formulas, with the
    interval mask."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    scale = dh ** -0.5
    for c0, c1, k0, k1, keep in _chunks(spec, s):
        keep = keep.to(q.device)
        qs = (q[:, c0:c1].to(_F32) * scale).to(q.dtype).to(_F32)
        for bi, h, sl in _heads(b, hkv, hq // hkv):
            kh, vh = k[bi, k0:k1, h].to(_F32), v[bi, k0:k1, h].to(_F32)
            doh = dout[bi, c0:c1, sl].transpose(0, 1).to(_F32)
            sc = qs[bi, :, sl].transpose(0, 1) @ kh.T
            sc = sc.masked_fill(~keep, NEG_INF)
            p = torch.exp(sc - lse[bi, sl, c0:c1][..., None])
            ds = p * (doh @ vh.T - dcap[bi, sl, c0:c1][..., None]) * scale
            yield (c0, c1, k0, k1, bi, h, sl, kh, doh, p,
                   ds.to(q.dtype).to(_F32))


def plain_splash_dq(q, k, v, out, lse, dout, spec):
    """``(dq, D)`` under the mask (K7's work); the plain-causal spec is
    ``plain_dq``."""
    if spec.is_plain_causal:
        return plain_dq(q, k, v, out, lse, dout, True)
    dcap = (dout.to(_F32) * out.to(_F32)).sum(dim=-1).transpose(1, 2) \
        .contiguous()
    dq = torch.empty_like(q)
    for c0, c1, _, _, bi, _, sl, kh, _, _, ds in _splash_recompute(
            q, k, v, dout, lse, dcap, spec):
        dq[bi, c0:c1, sl] = (ds @ kh).transpose(0, 1).to(q.dtype)
    return dq, dcap


def plain_splash_dkv(q, k, v, dout, lse, dcap, spec):
    """``(dk, dv)`` under the mask, summed over each KV head's q-head
    group and the q chunks in f32 (K8's work); the plain-causal spec is
    ``plain_dkv``."""
    if spec.is_plain_causal:
        return plain_dkv(q, k, v, dout, lse, dcap, True)
    dk = torch.zeros(k.shape, dtype=_F32, device=k.device)
    dv = torch.zeros(v.shape, dtype=_F32, device=v.device)
    for c0, c1, k0, k1, bi, h, sl, _, doh, p, ds in _splash_recompute(
            q, k, v, dout, lse, dcap, spec):
        qh = q[bi, c0:c1, sl].transpose(0, 1).to(_F32)
        dk[bi, k0:k1, h] += (ds.transpose(1, 2) @ qh).sum(dim=0)
        pr = p.to(dout.dtype).to(_F32)
        dv[bi, k0:k1, h] += (pr.transpose(1, 2) @ doh).sum(dim=0)
    return dk.to(k.dtype), dv.to(v.dtype)


def plain_splash_backward(q, k, v, out, lse, dout, spec):
    """``(dq, dk, dv)`` by K7/K8's recomputation under the mask."""
    dq, dcap = plain_splash_dq(q, k, v, out, lse, dout, spec)
    return (dq, *plain_splash_dkv(q, k, v, dout, lse, dcap, spec))


@dataclasses.dataclass(frozen=True)
class SplashArrays:
    """A BlockMask's int32 arrays on the card, packed as the kernels read
    them (csrc/flash_attention.cu, ``MaskView``): ``[first | last |
    blk_lo_max | blk_hi_min | lo | hi]``, each of the first four zero-
    padded to a multiple of 4 entries.  ``first``/``last`` are the
    per-q-tile visit ranges (forward, dq) or the transposed per-kv-tile
    ones (dk/dv)."""
    packed: torch.Tensor
    seq_len: int
    tiles: tuple
    transposed: bool


def _pad4(a: np.ndarray) -> np.ndarray:
    out = np.zeros(-(-len(a) // 4) * 4, np.int32)
    out[:len(a)] = a
    return out


def pack_block_mask(bm, transposed: bool, device) -> SplashArrays:
    """One H2D copy of a BlockMask's arrays (``splash_arrays`` caches
    it; chip_smoke.py packs deliberately broken masks with it)."""
    first, last = ((bm.kv_first_q, bm.kv_last_q) if transposed
                   else (bm.q_first_k, bm.q_last_k))
    host = np.concatenate([_pad4(first), _pad4(last), _pad4(bm.blk_lo_max),
                           _pad4(bm.blk_hi_min), bm.lo, bm.hi])
    return SplashArrays(torch.from_numpy(host.astype(np.int32)).to(device),
                        bm.seq_len, (bm.block_q, bm.block_k), transposed)


_KIND_TILES = {"fwd": FWD_TILES, "dq": DQ_TILES, "dkv": DKV_TILES}


@functools.lru_cache(maxsize=64)
def splash_arrays(spec, s: int, kind: str, device) -> SplashArrays:
    """The device copy of the BlockMask kernel ``kind`` ("fwd", "dq",
    "dkv") reads, built at its tiles and cached per (spec, S, kind,
    device): the host arrays cross to the card once, not per layer and
    pass."""
    bm = amask.block_mask(spec, s, *_KIND_TILES[kind])
    return pack_block_mask(bm, kind == "dkv", device)


def _arrays_for(q, spec, kind: str, arrays):
    _check_spec(spec)
    if arrays is None:
        return splash_arrays(spec, q.shape[1], kind, q.device)
    if (arrays.packed.device != q.device or arrays.seq_len != q.shape[1]
            or arrays.tiles != _KIND_TILES[kind]
            or arrays.transposed != (kind == "dkv")
            or arrays.packed.dtype != torch.int32
            or arrays.packed.data_ptr() % 16):
        raise ValueError(f"splash attention: mask arrays for S="
                         f"{arrays.seq_len} tiles {arrays.tiles} on "
                         f"{arrays.packed.device} do not fit the {kind} "
                         f"kernel at S={q.shape[1]} on {q.device} (or are "
                         f"not 16-byte aligned)")
    return arrays


def _splash_call(name: str, q, k, ptrs) -> None:
    b, s, hq, dh = q.shape
    fn = getattr(_build.library("flash_attention"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * len(ptrs)
                       + [ctypes.c_int] * 5 + [ctypes.c_float,
                                               ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(DTYPE_CODES[q.dtype], *ptrs, b, s, hq, k.shape[2], dh,
                dh ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"splash attention kernel {name}: cudaError_t "
                           f"{rc} (q {tuple(q.shape)} {q.dtype}, k "
                           f"{tuple(k.shape)})")


def kernel_splash_forward(q, k, v, spec, arrays=None):
    """K6 on the card: ``(O, lse)`` under ``spec`` (``arrays``: the
    packed BlockMask, by default the cached one at K6's tiles)."""
    global splash_fwd_launches
    check_shapes(q, k, v)
    check_operands(q, k, v)
    arr = _arrays_for(q, spec, "fwd", arrays)
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=_F32,
                      device=q.device)
    _splash_call("dlnb_splash_fwd", q, k,
                 [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), arr.packed.data_ptr()])
    splash_fwd_launches += 1
    return out, lse


def kernel_splash_dq(q, k, v, out, lse, dout, spec, arrays=None):
    """K7 on the card: ``(dq, D)`` under ``spec``."""
    global splash_dq_launches
    check_shapes(q, k, v)
    check_operands(q, k, v, out, dout)
    _check_rows(q, lse)
    arr = _arrays_for(q, spec, "dq", arrays)
    dcap = torch.empty_like(lse)
    dq = torch.empty_like(q)
    _splash_call("dlnb_splash_dq", q, k,
                 [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), dcap.data_ptr(),
                  dq.data_ptr(), arr.packed.data_ptr()])
    splash_dq_launches += 1
    return dq, dcap


def kernel_splash_dkv(q, k, v, dout, lse, dcap, spec, arrays=None):
    """K8 on the card: ``(dk, dv)`` under ``spec``, reading K7's D."""
    global splash_dkv_launches
    check_shapes(q, k, v)
    check_operands(q, k, v, dout)
    _check_rows(q, lse, dcap)
    arr = _arrays_for(q, spec, "dkv", arrays)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _splash_call("dlnb_splash_dkv", q, k,
                 [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), dcap.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), arr.packed.data_ptr()])
    splash_dkv_launches += 1
    return dk, dv


def kernel_splash_backward(q, k, v, out, lse, dout, spec):
    """K7 then K8 on the card: ``(dq, dk, dv)``."""
    dq, dcap = kernel_splash_dq(q, k, v, out, lse, dout, spec)
    return (dq, *kernel_splash_dkv(q, k, v, dout, lse, dcap, spec))


def splash_forward(q, k, v, spec):
    """``(O, lse)``: K6 on a CUDA tensor, ``plain_splash_forward`` on a
    CPU one."""
    if on_card(q):
        return kernel_splash_forward(q, k, v, spec)
    check_shapes(q, k, v)
    return plain_splash_forward(q, k, v, spec)


def splash_backward(q, k, v, out, lse, dout, spec):
    """``(dq, dk, dv)``: K7 + K8 on a CUDA tensor,
    ``plain_splash_backward`` on a CPU one."""
    if on_card(q):
        return kernel_splash_backward(q, k, v, out, lse, dout, spec)
    return plain_splash_backward(q, k, v, out, lse, dout, spec)


class _SplashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, spec):
        consult_tiles("splash_fwd", q, k, spec.label(), FWD_CONFIG)
        out, lse = splash_forward(q, k, v, spec)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.spec = spec
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        consult_tiles("splash_bwd", q, k, ctx.spec.label(), BWD_CONFIG)
        dq, dk, dv = splash_backward(q, k, v, out, lse, dout.contiguous(),
                                     ctx.spec)
        return dq, dk, dv, None


def splash_attention(q, k, v, spec):
    """Block-sparse masked attention with ``flash_attention``'s tensor
    contract and a ``MaskSpec`` in place of ``causal``; differentiable in
    q, k and v.  Under the plain-causal spec K6/K7/K8 give K3/K4/K5's
    results bitwise."""
    _check_spec(spec)
    return _SplashAttention.apply(q, k, v, spec)
