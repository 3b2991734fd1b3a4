"""Kernels K3, K4, K5: flash attention forward, dq and dk/dv (the port of
the JAX package's ``ops/flash_attention.py`` ``_fwd_kernel`` (:126),
``_dq_kernel`` (:242) and ``_dkv_kernel`` (:279)).

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

Bound on the H100 at the training shape: operations (each kernel does
0.6-1.2e12 FLOP on ~0.3 GB); the design notes are in the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from dlnetbench_tpu_torch.ops import _build
from dlnetbench_tpu_torch.ops.common import on_card

_F32 = torch.float32
NEG_INF = -1e30                 # finite mask: masked rows never give NaN
LOG2E = 1.4426950408889634
LONG_SEQ = 64 * 1024            # the JAX package's dense-fallback limit
SEQ_MULTIPLE = 128              # the kernels' (and the JAX blocks') unit
HEAD_DIMS = (64, 128)

# the C entries' dtype codes (csrc/flash_attention.cu, enum Dtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by the op (reset by the caller)
fwd_launches = 0
dq_launches = 0
dkv_launches = 0


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


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, out, lse, dout.contiguous(),
                              ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """Blockwise attention with the same contract as
    ``models.layers.attention``; differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal)
