"""Kernel K12, the grouped (per-expert) matmul of the MoE expert FFN (the
port of the JAX package's ``ops/grouped_matmul.py``).

* ``grouped_matmul(x, w, counts=..., sx=..., sw=..., fmt=...)`` —
  ``[E, C, K] @ [E, K, N] -> [E, C, N]``, one product per expert over its
  dispatch buffer of C slots.  ``counts`` ([E] int32, on x's device) is
  each expert's valid rows: rows at or past it are zeros in the result
  and cost no work.  With ``fmt`` ("int8" | "float8") ``w`` is quantized
  per expert (``quantize_experts``) and each x tile is quantized against
  the per-expert scale ``sx[e]`` inside the kernel, with int32 (int8) or
  f32 (e4m3) sums and ``sx[e] * sw[e]`` applied to the result.  On a
  CUDA tensor it launches the hand-written Hopper kernel of
  ``csrc/mlp_matmul.cu`` (counted in ``grouped_launches``); on a CPU
  tensor it runs ``plain_grouped_matmul``.
* ``grouped_ffn`` — three grouped matmuls as the expert SwiGLU, with the
  JAX package's straight-through backward as a
  ``torch.autograd.Function`` (batched library products, h recomputed).
* ``quantize_experts``, ``expert_amax`` — per-expert scales in the one
  spelling of ``ops/quantized_matmul.py``.

The TPU kernel zeroes whole token BLOCKS past a count; the port zeroes
every row at or past it, so its result does not depend on a tile size.
The two agree wherever the dispatch buffers keep their contract (rows
past the count are zero), and everywhere on the live rows and on the
rows the TPU kernel zeroes.  The TPU kernel's grid blocks are validated
as the JAX package validates them; the port's kernel runs its one frozen
tile (the tuning DB is not ported).  There is no fall back from the
card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from dlnetbench_tpu_torch.models.layers import dot_f32
from dlnetbench_tpu_torch.ops import _build
from dlnetbench_tpu_torch.ops import quantized_matmul as Q
from dlnetbench_tpu_torch.ops.common import on_card

_F32 = torch.float32

# the JAX package's frozen default grid blocks (validated, not used: the
# card's kernel has one tile)
DEFAULT_BLOCKS = {"block_c": 512, "block_n": 1024, "block_k": 1024}
# the C entry's format codes (csrc/mlp_matmul.cu): -1 is no quantization
FMT_CODES = {None: -1, **Q.FMT_CODES}
# what the tensor-core kernels take: N a multiple of 256 and K of 64 (C
# is free: rows past it are never read); the f32 kernel takes any shape
TILE_N, TILE_K = Q.TILE_N, Q.TILE_K

# kernel launches made by grouped_matmul on the card (reset by the caller)
grouped_launches = 0


def quantize_experts(w: torch.Tensor, fmt: str):
    """Per-expert symmetric quantization of a stacked weight ``[E, K, N]``
    -> ``(wq [E, K, N], sw [E])``."""
    wf = w.to(_F32)
    sw = Q.scale_from_amax(wf.abs().amax(dim=(1, 2)), fmt)
    return Q.cast_q(wf / sw[:, None, None], fmt), sw


def expert_amax(x: torch.Tensor) -> torch.Tensor:
    """Per-expert activation amax of a dispatch buffer ``[E, C, K]``
    (padded rows are zeros and cannot inflate it) -> ``[E]`` f32."""
    return x.abs().amax(dim=(1, 2)).to(_F32)


def _row_mask(counts, e: int, c: int, device) -> torch.Tensor:
    """``[E, C, 1]`` True on the rows below each expert's count."""
    rows = torch.arange(c, device=device)[None, :]
    return (rows < counts.to(device).reshape(e, 1))[..., None]


def plain_grouped_matmul(x, w, counts, sx, sw, fmt, out_dtype=None):
    """K12 in plain PyTorch: per-expert products in f32 on widened
    operands (int8 exactly, in float64 — every partial sum of int8
    products at these widths is an integer below 2^53; e4m3 in f32 from
    the dequantized values), the ``sx * sw`` epilogue for a quantized
    ``w``, rows at or past ``counts`` zeroed, cast to the output dtype."""
    e, c, _ = x.shape
    if fmt:
        xq = Q.cast_q(x.to(_F32) / sx[:, None, None], fmt)
        acc = Q.quantized_product(xq, w, fmt)
        val = acc * (sx * sw)[:, None, None]
    else:
        val = x.to(_F32) @ w.to(_F32)
    if counts is not None:
        val = torch.where(_row_mask(counts, e, c, x.device), val, 0.0)
    return val.to(out_dtype or x.dtype)


def _fn():
    fn = _build.library("mlp_matmul").dlnb_gmm
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def kernel_grouped_matmul(x, w, counts, sx, sw, fmt):
    """K12 on the card: x ``[E, C, K]`` (bf16 or f32); ``w`` ``[E, K, N]``
    in x's dtype, or with ``fmt`` the quantized weight K-major, ``[E, N,
    K]``; ``counts`` int32 ``[E]`` or None (every row); ``sx``/``sw`` f32
    ``[E]`` (quantized only), all read on the card."""
    global grouped_launches
    e, c, k = x.shape
    if x.dtype not in Q.DTYPE_CODES:
        raise ValueError(f"grouped_matmul: x dtype {x.dtype} (float32 or "
                         f"bfloat16)")
    if fmt:
        n = w.shape[1]
        want = (Q.FORMATS[fmt][0], (e, n, k))
    else:
        n = w.shape[2]
        want = (x.dtype, (e, k, n))
    if (w.dtype, tuple(w.shape)) != want:
        raise ValueError(f"grouped_matmul: weight {w.dtype} "
                         f"{tuple(w.shape)}, want {want[0]} {list(want[1])}")
    if (fmt or x.dtype != _F32) and (n % TILE_N or k % TILE_K):
        raise ValueError(
            f"grouped_matmul: the tensor-core kernel takes [E, C, K] @ "
            f"[E, K, N] with N a multiple of {TILE_N} and K of {TILE_K}; "
            f"got K={k} N={n} ({x.dtype}, fmt {fmt}), and a CUDA tensor "
            f"has no other path")
    ops = [x, w]
    if counts is not None:
        if counts.dtype != torch.int32 or counts.shape != (e,):
            raise ValueError(f"grouped_matmul: counts {counts.dtype} "
                             f"{tuple(counts.shape)}, want int32 [{e}]")
        ops.append(counts)
    if fmt:
        for s in (sx, sw):
            if s.dtype != _F32 or s.shape != (e,):
                raise ValueError(f"grouped_matmul: scale {s.dtype} "
                                 f"{tuple(s.shape)}, want float32 [{e}]")
        ops += [sx, sw]
    for t in ops:
        if t.device != x.device:
            raise ValueError(f"grouped_matmul: operands on {t.device} and "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError("grouped_matmul: operands must be contiguous")
    y = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _fn()(Q.DTYPE_CODES[x.dtype], FMT_CODES[fmt], x.data_ptr(),
                   w.data_ptr(),
                   counts.data_ptr() if counts is not None else None,
                   sx.data_ptr() if fmt else None,
                   sw.data_ptr() if fmt else None, y.data_ptr(), e, c, n, k,
                   stream)
    if rc != 0:
        raise RuntimeError(f"grouped_matmul kernel: cudaError_t {rc} (x "
                           f"{tuple(x.shape)} {x.dtype}, N={n}, fmt {fmt})")
    grouped_launches += 1
    return y


def _check_blocks(block_c, block_n, block_k) -> None:
    """The JAX package's validation of explicit grid blocks (an absent
    or zero block takes the default)."""
    if block_c is None and block_n is None and block_k is None:
        return
    blocks = {"block_c": block_c or DEFAULT_BLOCKS["block_c"],
              "block_n": block_n or DEFAULT_BLOCKS["block_n"],
              "block_k": block_k or DEFAULT_BLOCKS["block_k"]}
    for name, blk in blocks.items():
        if not isinstance(blk, int) or blk <= 0:
            raise ValueError(f"grouped_matmul: {name}={blk!r} must "
                             f"be a positive int")


def grouped_matmul(x, w, *, counts=None, sx=None, sw=None,
                   fmt: str | None = None, out_dtype=None,
                   block_c: int | None = None, block_n: int | None = None,
                   block_k: int | None = None):
    """``[E, C, K] @ [E, K, N] -> [E, C, N]`` per-expert matmul.

    ``counts`` ([E], optional): valid rows per expert — rows at or past
    it are zeros and cost no work; ``None`` computes every row.
    Quantized form (``fmt`` = "int8" | "float8"): ``w`` pre-quantized per
    expert (``quantize_experts``), ``sw`` [E] its scales and ``sx`` [E]
    the per-expert activation scales the kernel quantizes against.  The
    result is in ``out_dtype`` (default x's dtype; the card's kernel
    writes x's dtype only)."""
    e, c, kdim = x.shape
    if w.shape[0] != e or w.shape[1] != kdim:
        raise ValueError(f"grouped_matmul: shape mismatch "
                         f"x{tuple(x.shape)} @ w{tuple(w.shape)}")
    if fmt is not None:
        if fmt not in Q.FORMATS:
            raise ValueError(f"grouped_matmul: unknown fmt {fmt!r}; "
                             f"one of {tuple(Q.FORMATS)}")
        if sx is None or sw is None:
            raise ValueError("grouped_matmul: fmt set but sx/sw "
                             "per-expert scales missing")
        sx = torch.as_tensor(sx, dtype=_F32, device=x.device).reshape(e)
        sw = torch.as_tensor(sw, dtype=_F32, device=x.device).reshape(e)
    _check_blocks(block_c, block_n, block_k)
    if counts is not None:
        counts = torch.as_tensor(counts, device=x.device).to(torch.int32)
    if not on_card(x):
        return plain_grouped_matmul(x, w, counts, sx, sw, fmt, out_dtype)
    if out_dtype not in (None, x.dtype):
        raise ValueError(f"grouped_matmul: the kernel writes x's dtype "
                         f"{x.dtype}, not {out_dtype}")
    if fmt:
        w = w.transpose(1, 2).contiguous()     # K-major per expert
    return kernel_grouped_matmul(x.contiguous(), w, counts, sx, sw, fmt)


# ----------------------------------------------------- the expert FFN

def _ffn_fwd(x, w_gate, w_up, w_down, counts, fmt, blocks):
    """The three grouped products of the expert SwiGLU; ``h`` rounded to
    the products' dtype, as ``layers.swiglu_fwd_res`` rounds it."""
    kw = dict(counts=counts, **blocks)
    if fmt:
        sx = Q.scale_from_amax(expert_amax(x), fmt)
        wgq, swg = quantize_experts(w_gate, fmt)
        wuq, swu = quantize_experts(w_up, fmt)
        g = grouped_matmul(x, wgq, sx=sx, sw=swg, fmt=fmt, **kw)
        u = grouped_matmul(x, wuq, sx=sx, sw=swu, fmt=fmt, **kw)
        h = Q.silu_hidden(g, u)
        sh = Q.scale_from_amax(expert_amax(h), fmt)
        wdq, swd = quantize_experts(w_down, fmt)
        return grouped_matmul(h, wdq, sx=sh, sw=swd, fmt=fmt, **kw)
    g = grouped_matmul(x, w_gate, **kw)
    u = grouped_matmul(x, w_up, **kw)
    return grouped_matmul(Q.silu_hidden(g, u), w_down, **kw)


def _ffn_bwd(x, w_gate, w_up, w_down, dy):
    """The straight-through master-dtype backward (the JAX package's
    ``_grouped_ffn_bwd``): batched products over the expert axis, h
    recomputed.  Rows past an expert's count carry a zero cotangent
    (their combine weights are zero), so no count mask is needed.  On
    the CPU and in f32 it is the JAX formulas exactly (f32 products of
    widened operands); for bf16 on the card the f32 intermediates dg, du
    and h are rounded to bf16 and multiplied on the tensor cores with
    f32 sums (``layers.dot_f32``), as ``quantized_matmul.swiglu_bwd_impl``
    does."""
    def t(a):
        return a.transpose(1, 2)
    exact = not on_card(x) or x.dtype == _F32
    xw = x.to(_F32) if exact else x
    wg, wu, wd = ((w.to(_F32) for w in (w_gate, w_up, w_down)) if exact
                  else (w_gate, w_up, w_down))
    dyw = dy.to(_F32) if exact else dy.to(x.dtype)
    g = dot_f32(xw, wg)
    u = dot_f32(xw, wu)
    sig = torch.sigmoid(g)
    silu = g * sig
    h = silu * u
    dh = dot_f32(dyw, t(wd))
    lo = (lambda a: a) if exact else (lambda a: a.to(x.dtype))
    dwd = dot_f32(t(lo(h)), dyw).to(w_down.dtype)
    dg = lo(dh * u * (sig + silu * (1.0 - sig)))
    du = lo(dh * silu)
    dx = (dot_f32(dg, t(wg)) + dot_f32(du, t(wu))).to(x.dtype)
    dwg = dot_f32(t(xw), dg).to(w_gate.dtype)
    dwu = dot_f32(t(xw), du).to(w_up.dtype)
    return dx, dwg, dwu, dwd


class _GroupedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, counts, fmt, blocks):
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        return _ffn_fwd(x, w_gate, w_up, w_down, counts, fmt, blocks)

    @staticmethod
    def backward(ctx, dy):
        with torch.no_grad():
            grads = _ffn_bwd(*ctx.saved_tensors, dy)
        # counts is state, not a weight; fmt and blocks are not tensors
        return (*grads, None, None, None)


def grouped_ffn(x, w_gate, w_up, w_down, *, counts=None,
                fmt: str | None = None, block_c: int | None = None,
                block_n: int | None = None, block_k: int | None = None):
    """The grouped expert SwiGLU: ``x`` ``[E, C, d]`` dispatch buffers,
    weights ``[E, d, h]`` / ``[E, h, d]`` stacked per expert -> ``[E, C,
    d]`` in x's dtype.  ``counts`` enables the row skipping, ``fmt`` the
    fused-quantization recipes (per-expert dynamic scales,
    straight-through backward)."""
    if fmt is not None and fmt not in Q.FORMATS:
        raise ValueError(f"grouped_ffn: unknown fmt {fmt!r}; one of "
                         f"{tuple(Q.FORMATS)} or None")
    blocks = {"block_c": block_c, "block_n": block_n, "block_k": block_k}
    return _GroupedFFN.apply(x, w_gate, w_up, w_down, counts, fmt, blocks)
