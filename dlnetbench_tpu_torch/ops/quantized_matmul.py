"""Kernel K11, the fused-quantization matmul, and the quantization recipes
around it (the port of the JAX package's ``ops/quantized_matmul.py``).

* ``FORMATS``, ``scale_from_amax``, ``cast_q``, ``quantize_tensor`` — the
  one spelling of the symmetric per-tensor scale, shared by the composed
  recipes (``ops/int8.py``, ``ops/fp8.py``), the fused kernel and the
  quantized KV cache.
* ``fused_matmul(x, wq, sw, sx, fmt=...)`` — x ``[..., K]`` in the master
  dtype times the pre-quantized ``wq [K, N]``: on a CUDA tensor the
  hand-written Hopper kernel of ``csrc/mlp_matmul.cu`` (counted in
  ``fused_launches``): TMA loads, a quantizer warpgroup that turns each
  x stage into the 8-bit operand in shared memory (shared by a cluster
  of blocks along N; the quantized activation never exists in device
  memory), ``wgmma`` with int32 (int8) or f32 (e4m3) sums and ``sx *
  sw`` applied in registers; with ``collect_amax`` it also yields max
  |x|.
  On a CPU tensor it runs ``plain_fused_matmul``: the int8 product
  exactly (in float64, where every partial sum of int8 products at these
  widths is an exact integer), the e4m3 product in f32 from the
  dequantized values (exact), then the same epilogue.
* ``fused_dot`` / ``fused_dot_delayed`` — fresh or carried activation
  scale, weight quantized per call (once per step in the train step);
  ``int8_dot_fused``, ``fp8_dot_fused`` and their ``_delayed`` siblings
  wrap them with the straight-through master-dtype backward.
* ``swiglu_fused_fwd_res``, ``swiglu_fused_delayed_fwd_res``,
  ``swiglu_bwd_impl`` and ``swiglu_master_bwd`` — the SwiGLU bodies every
  quantized recipe shares: ``h`` is recomputed in the backward, never
  saved.

The rounding points are the JAX package's: divide by the scale (never
multiply by its inverse), int8 rounds half to even and then clips, e4m3
clips to +-448 and then casts, and the epilogue is ``float(acc) *
(sx * sw)`` with one f32 product of the scales.  There is no fall back
from the card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from dlnetbench_tpu_torch.models.layers import dot_f32
from dlnetbench_tpu_torch.ops import _build
from dlnetbench_tpu_torch.ops.common import on_card

_F32 = torch.float32

# format table: (quantized dtype, symmetric max, accumulator dtype)
FORMATS = {
    "int8": (torch.int8, 127.0, torch.int32),
    "float8": (torch.float8_e4m3fn, 448.0, torch.float32),
}

# the C entry's codes (csrc/mlp_matmul.cu, enums Dtype and Fmt)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
FMT_CODES = {"int8": 0, "float8": 1}
# the kernel's contract: rows of the output a multiple of 128 (its
# tile), columns of 256, the contraction a multiple of 64 (half of an
# 8-bit stage: a half last stage is zero-filled)
TILE_M, TILE_N, TILE_K = 128, 256, 64
# the cluster sizes the 8-bit kernels are built for (blocks along N that
# share one quantized x stage)
CLUSTERS = (1, 2, 4)

# kernel launches made by fused_matmul on the card (reset by the caller)
fused_launches = 0


def scale_from_amax(amax: torch.Tensor, fmt: str) -> torch.Tensor:
    """``max(amax, eps) / qmax`` in f32."""
    _, qmax, _ = FORMATS[fmt]
    return torch.clamp_min(amax, 1e-12) / qmax


def cast_q(scaled: torch.Tensor, fmt: str) -> torch.Tensor:
    """Scaled values -> the quantized dtype, saturating at the format's
    range: int8 rounds half to even (``torch.round``, as ``jnp.round``)
    and then clips to +-127; e4m3 clips to +-448 and then casts
    (round to nearest even).  Callers divide by the scale before this —
    never multiply by its inverse, which rounds differently."""
    qdtype, qmax, _ = FORMATS[fmt]
    if fmt == "int8":
        return torch.clamp(torch.round(scaled), -qmax, qmax).to(qdtype)
    return torch.clamp(scaled, -qmax, qmax).to(qdtype)


def amax_of(x: torch.Tensor) -> torch.Tensor:
    """max |x| as an f32 scalar.  Taken in x's own dtype, then widened:
    a max is exact in any dtype, so this equals max |float(x)| without
    an f32 copy of x."""
    return x.abs().amax().to(_F32)


def quantize_tensor(x: torch.Tensor, fmt: str):
    """Per-tensor symmetric quantization: ``(x_q, scale)`` with
    ``x ~= x_q * scale``, scale an f32 scalar on x's device."""
    scale = scale_from_amax(amax_of(x), fmt)
    return cast_q(x.to(_F32) / scale, fmt), scale


def _check_fmt(fmt: str) -> None:
    if fmt not in FORMATS:
        raise ValueError(f"unknown quantization format {fmt!r}; expected "
                         f"one of {tuple(FORMATS)}")


# ---------------------------------------------------------- plain version

def quantized_product(aq: torch.Tensor, bq: torch.Tensor,
                      fmt: str) -> torch.Tensor:
    """``aq @ bq`` of two quantized matrices, exactly as the kernel sums
    it: int8 in float64 (each product and partial sum is an integer below
    2^53), e4m3 in f32 from the dequantized values.  The accumulator is
    returned as f32 (the int8 sum, an integer below 2^31, rounded to f32
    once, as the kernel's ``__int2float_rn``)."""
    if fmt == "int8":
        return (aq.to(torch.float64) @ bq.to(torch.float64)).to(_F32)
    return aq.to(_F32) @ bq.to(_F32)


def plain_fused_matmul(x2, wq, sw, sx, fmt: str, collect_amax: bool,
                       out_dtype=None):
    """``(y, amax)`` of K11 in plain PyTorch: x2 ``[T, K]``, wq ``[K,
    N]``; amax is None unless ``collect_amax``."""
    xf = x2.to(_F32)
    acc = quantized_product(cast_q(xf / sx, fmt), wq, fmt)
    y = (acc * (sx * sw)).to(out_dtype or x2.dtype)
    return y, (xf.abs().amax() if collect_amax else None)


# ----------------------------------------------------------------- kernel

def _fn():
    fn = _build.library("mlp_matmul").dlnb_qmm
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int])
    return fn


def set_cluster(size: int) -> int:
    """The cluster size (one of ``CLUSTERS``) the card's 8-bit K11 and
    K12 launches prefer from now on when they are given none (the
    tuner off and no ``cluster`` argument); returns the previous one.
    Such a launch takes the largest of size, size / 2, ... that divides
    N / 256.  Builds the kernels if needed."""
    if size not in CLUSTERS:
        raise ValueError(f"cluster size {size!r}: one of {CLUSTERS}")
    fn = _build.library("mlp_matmul").dlnb_qmm_set_cluster
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
    return int(fn(size))


def default_cluster(n: int) -> int:
    """The cluster size an untuned launch of N output columns takes: the
    largest of 4, 2, 1 that divides N / 256 (the kernel's default rule
    at its default preference)."""
    c = CLUSTERS[-1]
    while c > 1 and (n // TILE_N) % c:
        c //= 2
    return c


def check_cluster(cfg: dict, n: int, what: str) -> None:
    """A tuned ``{"cluster": c}`` the 8-bit kernel can take: c one of
    ``CLUSTERS`` and dividing N / 256 (ValueError otherwise)."""
    c = cfg.get("cluster")
    if c not in CLUSTERS or (n // TILE_N) % c:
        raise ValueError(f"{what}: tuned cluster={c!r} is not one of "
                         f"{CLUSTERS} dividing N/{TILE_N} = {n // TILE_N}")


def tuned_cluster(t: int, kdim: int, n: int, fmt: str, xdtype,
                  device) -> int:
    """K11's cluster size for a ``(t, kdim) @ (kdim, n)`` product on
    ``device``: the tuning DB's answer (op ``quantized_matmul``, the JAX
    package's key; frozen after the first consult) or
    ``default_cluster(n)``.  With the tuner off, 0: the launch takes the
    process-wide preference (``set_cluster``), as an untuned build's
    does."""
    from dlnetbench_tpu_torch import tuning
    if not tuning.enabled():
        return 0
    return tuning.consult(
        "quantized_matmul",
        tuning.params.quantized_matmul_key(t, kdim, n, fmt, xdtype),
        {"cluster": default_cluster(n)},
        validate=lambda cfg: check_cluster(cfg, n, "fused_matmul"),
        device=device)["cluster"]


def kernel_fused_matmul(x2, w_t, sw, sx, fmt: str, collect_amax: bool,
                        cluster: int = 0):
    """K11 on the card: ``(y, amax)`` from x2 ``[T, K]`` and the
    K-major quantized weight ``w_t [N, K]``; sw and sx are f32 scalars
    on the card (read there: nothing waits for them here).  ``cluster``
    is this launch's cluster size (one of ``CLUSTERS``, dividing N /
    256), or 0 for the process-wide preference (``set_cluster``)."""
    global fused_launches
    _check_fmt(fmt)
    t, k = x2.shape
    n = w_t.shape[0]
    if x2.dtype not in DTYPE_CODES:
        raise ValueError(f"fused_matmul: x dtype {x2.dtype} (float32 or "
                         f"bfloat16)")
    if w_t.dtype != FORMATS[fmt][0] or w_t.shape != (n, k):
        raise ValueError(f"fused_matmul: weight {w_t.dtype} "
                         f"{tuple(w_t.shape)}, want {FORMATS[fmt][0]} "
                         f"[N, {k}]")
    if t % TILE_M or n % TILE_N or k % TILE_K:
        raise ValueError(
            f"fused_matmul: the kernel takes [T, K] @ [K, N] with T, N and "
            f"K multiples of {TILE_M}, {TILE_N} and {TILE_K}; got T={t} "
            f"K={k} N={n}, and a CUDA tensor has no other path")
    if cluster:
        check_cluster({"cluster": cluster}, n, "fused_matmul")
    scales = [s.reshape(()) for s in (sx, sw)]
    for tns in (x2, w_t, *scales):
        if tns.device != x2.device:
            raise ValueError(f"fused_matmul: operands on {tns.device} and "
                             f"{x2.device}")
        if not tns.is_contiguous():
            raise ValueError("fused_matmul: operands must be contiguous")
    for s in scales:
        if s.dtype != _F32:
            raise ValueError(f"fused_matmul: scale dtype {s.dtype} (f32)")
    y = torch.empty((t, n), dtype=x2.dtype, device=x2.device)
    amax = (torch.zeros((), dtype=_F32, device=x2.device) if collect_amax
            else None)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        rc = _fn()(DTYPE_CODES[x2.dtype], FMT_CODES[fmt], int(collect_amax),
                   x2.data_ptr(), w_t.data_ptr(), scales[0].data_ptr(),
                   scales[1].data_ptr(), y.data_ptr(),
                   amax.data_ptr() if collect_amax else None, t, n, k,
                   stream, int(cluster))
    if rc != 0:
        raise RuntimeError(f"fused_matmul kernel: cudaError_t {rc} (x "
                           f"{tuple(x2.shape)} {x2.dtype}, {fmt}, cluster "
                           f"{cluster})")
    fused_launches += 1
    return y, amax


def k_major(wq: torch.Tensor) -> torch.Tensor:
    """``[N, K]`` contiguous copy of a ``[K, N]`` quantized weight (a
    view when wq is already column-major): what K11 and the library
    products read."""
    return wq.t().contiguous()


def fused_matmul(x, wq, sw, sx, *, fmt: str, out_dtype=None,
                 collect_amax: bool = False, cluster: int | None = None):
    """``[..., K]`` master-dtype x  @  ``[K, N]`` pre-quantized w  ->
    ``[..., N]``; returns ``y`` or ``(y, amax)`` with ``collect_amax``.

    ``sx`` is the provided activation scale (fresh or carried), ``sw``
    the weight scale from ``quantize_tensor``.  The TPU kernel's grid
    blocks (``block_m``/``block_n``/``block_k``) do not exist here: the
    card's kernel has one fixed 128 x 256 output tile, and its knob is
    the cluster size.  An explicit ``cluster`` wins; with none the
    tuning DB is consulted per (shape, dtype, chip) key
    (``tuned_cluster``), on the CPU too, where the plain version's
    result does not depend on it."""
    _check_fmt(fmt)
    lead, kdim = x.shape[:-1], x.shape[-1]
    n = wq.shape[1]
    if wq.shape[0] != kdim:
        raise ValueError(f"fused_matmul: contraction mismatch "
                         f"x[..., {kdim}] @ wq[{wq.shape[0]}, {n}]")
    x2 = x.reshape(-1, kdim)
    sx = torch.as_tensor(sx, dtype=_F32, device=x.device)
    if cluster is None:
        cluster = tuned_cluster(x2.shape[0], kdim, n, fmt, x.dtype,
                                x.device)
    else:
        check_cluster({"cluster": cluster}, n, "fused_matmul")
    if on_card(x):
        if out_dtype not in (None, x.dtype):
            raise ValueError(f"fused_matmul: the kernel writes x's dtype "
                             f"{x.dtype}, not {out_dtype}")
        y, amax = kernel_fused_matmul(x2.contiguous(), k_major(wq), sw, sx,
                                      fmt, collect_amax, cluster)
    else:
        y, amax = plain_fused_matmul(x2, wq, sw, sx, fmt, collect_amax,
                                     out_dtype)
    y = y.reshape(*lead, n)
    return (y, amax) if collect_amax else y


# -------------------------------------------------- forward-only dots

def fused_dot(x, w, fmt: str):
    """Fresh-scaling fused dot: one amax reduction over x, the weight
    quantized by ``quantize_tensor``, everything else in the kernel."""
    sx = scale_from_amax(amax_of(x), fmt)
    wq, sw = quantize_tensor(w, fmt)
    return fused_matmul(x, wq, sw, sx, fmt=fmt)


def fused_dot_delayed(x, w, fmt: str, amax_in, *,
                      collect_amax: bool = True):
    """Delayed-scaling fused dot: the activation scale comes from
    ``amax_in`` (the previous step's state) — no reduction over x before
    the kernel.  Returns ``(y, amax_out)`` with ``collect_amax``, else
    ``y``."""
    sx = scale_from_amax(amax_in, fmt)
    wq, sw = quantize_tensor(w, fmt)
    return fused_matmul(x, wq, sw, sx, fmt=fmt, collect_amax=collect_amax)


# ------------------------------------------- differentiable wrappers

def straight_through_dot_bwd(res, g):
    """Master-dtype backward shared by every quantized dot: quantization
    treated as identity, ``dx = g . w^T``, ``dw = x^T . g`` over every
    leading axis, f32 sums (the JAX package's f32-upcast dots: products
    of bf16 values are exact in f32)."""
    x, w = res
    g2 = g.reshape(-1, g.shape[-1])
    x2 = x.reshape(-1, x.shape[-1])
    dx = dot_f32(g2, w.t()).to(x.dtype).reshape(x.shape)
    dw = dot_f32(x2.t(), g2).to(w.dtype)
    return dx, dw


class _STDot(torch.autograd.Function):
    """A quantized dot ``fwd(x, w)`` with the straight-through
    backward."""

    @staticmethod
    def forward(ctx, x, w, fwd):
        ctx.save_for_backward(x, w)
        return fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        return (*straight_through_dot_bwd(ctx.saved_tensors, g), None)


class _STDotDelayed(torch.autograd.Function):
    """``fused_dot_delayed`` with the straight-through backward; the
    emitted amax is state, and the carried one gets a zero gradient."""

    @staticmethod
    def forward(ctx, x, w, amax_in, fmt):
        y, amax_out = fused_dot_delayed(x, w, fmt, amax_in)
        ctx.save_for_backward(x, w)
        ctx.mark_non_differentiable(amax_out)
        return y, amax_out

    @staticmethod
    def backward(ctx, dy, _d_amax):
        dx, dw = straight_through_dot_bwd(ctx.saved_tensors, dy)
        return dx, dw, torch.zeros((), dtype=_F32, device=dy.device), None


def int8_dot_fused(x, w):
    """The fused-kernel sibling of ``ops.int8.int8_dot``: int32
    accumulation makes it exactly equal to the composed form."""
    return _STDot.apply(x, w, lambda a, b: fused_dot(a, b, "int8"))


def fp8_dot_fused(x, w):
    """The fused-kernel sibling of ``ops.fp8.fp8_dot`` (e4m3, f32
    accumulation)."""
    return _STDot.apply(x, w, lambda a, b: fused_dot(a, b, "float8"))


def int8_dot_fused_delayed(x, w, amax_in):
    """``(y, amax_out)``: the activation scale from ``amax_in``, the
    fresh amax emitted for the next step."""
    return _STDotDelayed.apply(x, w, amax_in, "int8")


def fp8_dot_fused_delayed(x, w, amax_in):
    """Delayed-scaling e4m3 dot; see ``int8_dot_fused_delayed``."""
    return _STDotDelayed.apply(x, w, amax_in, "float8")


# ----------------------------------------------- shared SwiGLU bodies

def silu_hidden(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``h = silu(g) * u`` in f32, rounded to g's dtype (``jax.nn.silu``
    is ``g * sigmoid(g)``)."""
    gf = g.to(_F32)
    return (gf * torch.sigmoid(gf) * u.to(_F32)).to(g.dtype)


def swiglu_fused_fwd_res(x, w_gate, w_up, w_down, fmt: str):
    """Fresh-scaling fused-SwiGLU forward: ``(y, residuals)``, the
    residuals (x, g, u, weights) — ``h`` is not saved."""
    g = fused_dot(x, w_gate, fmt)
    u = fused_dot(x, w_up, fmt)
    out = fused_dot(silu_hidden(g, u), w_down, fmt)
    return out, (x, g, u, w_gate, w_up, w_down)


def swiglu_fused_delayed_fwd_res(x, w_gate, w_up, w_down, qs, fmt: str):
    """Delayed-scaling fused-SwiGLU forward: ``qs`` is this layer's
    carried ``[amax_x, amax_h]``; gate and up share the x scale (one
    collected amax), down uses the h scale.  Returns ``((y, new_qs),
    residuals)``."""
    g, amax_x = fused_dot_delayed(x, w_gate, fmt, qs[0])
    u = fused_dot_delayed(x, w_up, fmt, qs[0], collect_amax=False)
    out, amax_h = fused_dot_delayed(silu_hidden(g, u), w_down, fmt, qs[1])
    return (out, torch.stack([amax_x, amax_h])), (x, g, u, w_gate, w_up,
                                                  w_down)


def swiglu_bwd_impl(res, dy, act_dot):
    """The SwiGLU backward shared by every quantized recipe:
    ``act_dot(a, b)`` (a result in a's dtype) runs the three
    activation-gradient products (dh and the two dx legs) — a plain
    product for the straight-through recipe, the quantized int8 dot for
    SwitchBack; h is recomputed, and the three dW products are plain
    products in the master dtype."""
    x, g, u, w_gate, w_up, w_down = res
    gf, uf = g.to(_F32), u.to(_F32)
    sg = torch.sigmoid(gf)
    silu_g = gf * sg
    h = (silu_g * uf).to(g.dtype)                  # recomputed, not saved

    dh = act_dot(dy, w_down.t()).to(_F32)
    d_wd = (h.reshape(-1, h.shape[-1]).t()
            @ dy.reshape(-1, dy.shape[-1])).to(w_down.dtype)

    d_g = (dh * uf * (sg * (1.0 + gf * (1.0 - sg)))).to(g.dtype)
    d_u = (dh * silu_g).to(u.dtype)

    x2 = x.reshape(-1, x.shape[-1])
    d_wg = (x2.t() @ d_g.reshape(-1, d_g.shape[-1])).to(w_gate.dtype)
    d_wu = (x2.t() @ d_u.reshape(-1, d_u.shape[-1])).to(w_up.dtype)
    d_x = (act_dot(d_g, w_gate.t()) + act_dot(d_u, w_up.t())).to(x.dtype)
    return d_x, d_wg, d_wu, d_wd


def swiglu_master_bwd(res, dy):
    """The master-dtype (straight-through) SwiGLU backward."""
    return swiglu_bwd_impl(res, dy, torch.matmul)


class QuantSwiGLU(torch.autograd.Function):
    """A SwiGLU whose forward is ``fwd_res(x, wg, wu, wd) -> (y, res)``
    and whose backward is ``swiglu_bwd_impl(res, dy, act_dot)``."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, fwd_res, act_dot):
        out, res = fwd_res(x, w_gate, w_up, w_down)
        ctx.save_for_backward(*res)
        ctx.act_dot = act_dot
        return out

    @staticmethod
    def backward(ctx, dy):
        return (*swiglu_bwd_impl(ctx.saved_tensors, dy, ctx.act_dot), None,
                None)


class QuantSwiGLUDelayed(torch.autograd.Function):
    """The delayed-scaling fused SwiGLU: ``(y, new_qs)``; the state
    carries no gradient (the master backward, a zero one for ``qs``)."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, qs, fmt):
        (out, new_qs), res = swiglu_fused_delayed_fwd_res(
            x, w_gate, w_up, w_down, qs, fmt)
        ctx.save_for_backward(*res)
        ctx.mark_non_differentiable(new_qs)
        return out, new_qs

    @staticmethod
    def backward(ctx, dy, d_qs):
        return (*swiglu_delayed_master_bwd(ctx.saved_tensors, (dy, d_qs)),
                None)


def swiglu_delayed_master_bwd(res, cots):
    """``swiglu_master_bwd`` for the delayed-scaling swiglus: the second
    cotangent (the emitted state) is dropped and the carried state gets
    a zero gradient."""
    dy, _d_qs = cots
    return (*swiglu_master_bwd(res, dy),
            torch.zeros((2,), dtype=_F32, device=dy.device))
