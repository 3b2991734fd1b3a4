"""Kernels K9 and K10: the fused SwiGLU backward (the port of the JAX
package's ``ops/mlp_backward.py``, ``_dgdu_kernel`` (:50) and
``_dwd_kernel`` (:103)).

* ``dgdu(dy, wd, g, u)`` — dg, du ``[T, F]`` from dy ``[T, D]``, Wd
  ``[F, D]`` and the saved g, u: ``dh = dy . Wd^T`` stays in the
  kernel's f32 registers and the silu-gradient epilogue consumes it (dh
  never reaches device memory);
* ``dwd(g, u, dy)`` — dWd ``[F, D]`` f32 ``= h^T . dy`` with
  ``h = bf16(silu(g) * u)`` recomputed per tile (h never reaches device
  memory);
* ``swiglu_pallas_bwd`` — the SwiGLU whose backward runs both (the name
  is the JAX package's), plus three plain products (dx, dWg, dWu);
* ``swiglu_split_bwd`` — the same backward with the plain versions in
  the kernels' place on every device (the JAX package's
  ``models/layers.swiglu_split_bwd``: six plain products around one
  silu-gradient pass; its optimization barriers have no eager
  counterpart, every op here is its own pass already).

On CUDA tensors (bf16, the bench dtype) the wrappers launch the
hand-written Hopper kernels of ``csrc/mlp_matmul.cu`` (counted in
``dgdu_launches`` and ``dwd_launches``); on CPU tensors they run
``plain_dgdu`` and ``plain_dwd``, with the same formulas (the JAX
``_silu_parts``).  There is no fall back from the card to the plain
versions; a shape or dtype the kernels cannot take raises there.
"""
from __future__ import annotations

import ctypes

import torch

from dlnetbench_tpu_torch.models.layers import dot_f32, swiglu_fwd_res
from dlnetbench_tpu_torch.ops import _build
from dlnetbench_tpu_torch.ops.common import on_card

_F32 = torch.float32
_BF16 = torch.bfloat16
# the kernels' tiles (csrc/mlp_matmul.cu): K9 takes T, F and D multiples
# of 128, 256 and 64; K10 takes F, D and T multiples of 128, 256 and 32
K9_TILE = (128, 256, 64)
K10_TILE = (128, 256, 32)

# kernel launches made by the wrappers on the card (reset by the caller)
dgdu_launches = 0
dwd_launches = 0


def silu_parts(g_f32: torch.Tensor):
    """``(silu(g), silu'(g))`` in f32: silu' = sig + silu * (1 - sig)."""
    sig = torch.sigmoid(g_f32)
    silu = g_f32 * sig
    return silu, sig + silu * (1.0 - sig)


# --------------------------------------------------------- plain versions

def plain_dgdu(dy, wd, g, u):
    """K9's function: dh = dy . Wd^T in f32, dg = (dh * u) * silu'(g),
    du = dh * silu(g), rounded to g's and u's dtypes."""
    dh = dot_f32(dy, wd.t())
    silu, dsilu = silu_parts(g.to(_F32))
    dg = (dh * u.to(_F32) * dsilu).to(g.dtype)
    du = (dh * silu).to(u.dtype)
    return dg, du


def plain_dwd(g, u, dy):
    """K10's function: h = silu(g) * u rounded to g's dtype, then
    dWd = h^T . dy with an f32 result."""
    silu, _ = silu_parts(g.to(_F32))
    h = (silu * u.to(_F32)).to(g.dtype)
    return dot_f32(h.t(), dy)


# ---------------------------------------------------------------- kernels

def _fn(name: str, n_ptr: int):
    fn = getattr(_build.library("mlp_matmul"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    return fn


def _check(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != _BF16:
            raise ValueError(f"{name}: the kernel takes bfloat16 operands, "
                             f"got {t.dtype}, and a CUDA tensor has no "
                             f"other path")
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _launch(name: str, n_ptr: int, ptrs, t, f, d, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = _fn(name, n_ptr)(*ptrs, t, f, d, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel: cudaError_t {rc} (T={t} F={f} "
                           f"D={d})")


def kernel_dgdu(dy, wd, g, u):
    """K9 on the card: ``(dg, du)``."""
    global dgdu_launches
    _check("dgdu", dy, wd, g, u)
    t, d = dy.shape
    f = wd.shape[0]
    if wd.shape != (f, d) or g.shape != (t, f) or u.shape != (t, f):
        raise ValueError(f"dgdu: dy {tuple(dy.shape)}, wd "
                         f"{tuple(wd.shape)}, g {tuple(g.shape)}, u "
                         f"{tuple(u.shape)} do not fit")
    if t % K9_TILE[0] or f % K9_TILE[1] or d % K9_TILE[2]:
        raise ValueError(f"dgdu: the kernel takes T, F and D multiples of "
                         f"{K9_TILE}; got T={t} F={f} D={d}")
    dg, du = torch.empty_like(g), torch.empty_like(u)
    _launch("dlnb_dgdu", 6, [dy.data_ptr(), wd.data_ptr(), g.data_ptr(),
                             u.data_ptr(), dg.data_ptr(), du.data_ptr()],
            t, f, d, dy.device)
    dgdu_launches += 1
    return dg, du


def kernel_dwd(g, u, dy):
    """K10 on the card: dWd ``[F, D]`` f32."""
    global dwd_launches
    _check("dwd", g, u, dy)
    t, f = g.shape
    d = dy.shape[1]
    if u.shape != (t, f) or dy.shape != (t, d):
        raise ValueError(f"dwd: g {tuple(g.shape)}, u {tuple(u.shape)}, dy "
                         f"{tuple(dy.shape)} do not fit")
    if f % K10_TILE[0] or d % K10_TILE[1] or t % K10_TILE[2]:
        raise ValueError(f"dwd: the kernel takes F, D and T multiples of "
                         f"{K10_TILE}; got T={t} F={f} D={d}")
    out = torch.empty((f, d), dtype=_F32, device=g.device)
    _launch("dlnb_dwd", 4, [g.data_ptr(), u.data_ptr(), dy.data_ptr(),
                            out.data_ptr()], t, f, d, g.device)
    dwd_launches += 1
    return out


def dgdu(dy, wd, g, u):
    """dg, du ``[T, F]`` from dy ``[T, D]``, Wd ``[F, D]``, saved g, u
    ``[T, F]``: K9 on a CUDA tensor, ``plain_dgdu`` on a CPU one."""
    if on_card(dy):
        return kernel_dgdu(dy, wd, g, u)
    return plain_dgdu(dy, wd, g, u)


def dwd(g, u, dy):
    """dWd ``[F, D]`` f32 = h^T . dy, h = silu(g) * u recomputed: K10 on a
    CUDA tensor, ``plain_dwd`` on a CPU one."""
    if on_card(g):
        return kernel_dwd(g, u, dy)
    return plain_dwd(g, u, dy)


# ------------------------------------------------- fused-backward SwiGLU

class _SwigluBwd(torch.autograd.Function):
    """SwiGLU over x ``[T, D]``: the shared three-product forward
    (``models.layers.swiglu_fwd_res``; x, g, u saved), and a backward of
    dg/du and dWd (K9 and K10 when ``kernels``, else their plain
    versions) plus three plain products (dx, dWg, dWu)."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, kernels):
        y, (_, g, u, *_w) = swiglu_fwd_res(x, w_gate, w_up, w_down)
        ctx.save_for_backward(x, g, u, w_gate, w_up, w_down)
        ctx.kernels = kernels
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, u, w_gate, w_up, w_down = ctx.saved_tensors
        dgdu_fn, dwd_fn = ((dgdu, dwd) if ctx.kernels
                           else (plain_dgdu, plain_dwd))
        dy = dy.contiguous()
        dg, du = dgdu_fn(dy, w_down, g, u)
        dx = (dot_f32(dg, w_gate.t())
              + dot_f32(du, w_up.t())).to(x.dtype)
        dwg = dot_f32(x.t(), dg).to(w_gate.dtype)
        dwu = dot_f32(x.t(), du).to(w_up.dtype)
        return (dx, dwg, dwu, dwd_fn(g, u, dy).to(w_down.dtype), None)


def swiglu_pallas_bwd(x, w_gate, w_up, w_down):
    """SwiGLU over x ``[T, D]`` whose backward runs K9 and K10 (dh and h
    never reach device memory) plus three plain products."""
    return _SwigluBwd.apply(x, w_gate, w_up, w_down, True)


def swiglu_split_bwd(x, w_gate, w_up, w_down):
    """SwiGLU over x ``[T, D]`` with the hand-structured backward of
    plain products (``mlp_backward="split"``)."""
    return _SwigluBwd.apply(x, w_gate, w_up, w_down, False)
