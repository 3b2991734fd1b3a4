"""int8 matmul with per-tensor dynamic scales and the int8 SwiGLU recipes
(the port of the JAX package's ``ops/int8.py``).

bf16 master weights and activations, per-tensor symmetric scaling to
[-127, 127] (``quantized_matmul.quantize_tensor``, the one definition the
fused kernel shares, which is what makes the fused and composed int8
results exactly equal), int32 accumulation, the scales re-applied to the
result; the backward is straight-through in the master dtype.

The composed recipe's product is one the JAX package leaves to XLA, not
a Pallas kernel, so on the card it is a library call, ``torch._int_mm``
(int8 x int8 -> int32, exact); on the CPU it is the plain exact product
(``quantized_matmul.quantized_product``).  It never stands in for the
fused kernel K11.

``int8_dot_batched`` is the expert-parallel sibling (``[E, C, K] x [E,
K, N]``, per-tensor scales, one exact int32 product per expert: one
``torch._int_mm`` each on the card), with the straight-through
backward: ``moe.expert_ffn(mlp_int8=True)`` runs the expert SwiGLU's
three products through it.
"""
from __future__ import annotations

import torch

from dlnetbench_tpu_torch.ops import quantized_matmul as qmm
from dlnetbench_tpu_torch.ops.common import on_card

_F32 = torch.float32


def _quantize(x):
    return qmm.quantize_tensor(x, "int8")


def int32_product(aq: torch.Tensor, bq: torch.Tensor) -> torch.Tensor:
    """The exact int32 sum ``aq @ bq`` (2-D int8 operands): on the card
    ``torch._int_mm`` with the second operand column-major (no copy when
    ``bq`` already is), on the CPU the plain float64 product (every
    partial sum an integer below 2^53)."""
    if not on_card(aq):
        return (aq.to(torch.float64) @ bq.to(torch.float64)).to(torch.int32)
    return torch._int_mm(aq.contiguous(), qmm.k_major(bq).t())


def int8_product(aq: torch.Tensor, bq: torch.Tensor) -> torch.Tensor:
    """``int32_product`` as f32 (the int32 sum rounded once)."""
    return int32_product(aq, bq).to(_F32)


def _int8_matmul(a, b_mat, out_dtype):
    """Quantized ``a @ b_mat`` with per-tensor scales and int32
    accumulation — the one definition of the int8 dot recipe (the forward
    and SwitchBack's activation-gradient dots share it)."""
    aq, sa = _quantize(a)
    bq, sb = _quantize(b_mat)
    acc = int8_product(aq.reshape(-1, aq.shape[-1]), bq)
    out = (acc * (sa * sb)).to(out_dtype)
    return out.reshape(*a.shape[:-1], b_mat.shape[-1])


def int8_dot(x, w):
    """``[..., K] x [K, N] -> [..., N]``: int8 operands, int32
    accumulation, result in x's dtype; straight-through backward."""
    return qmm._STDot.apply(x, w, lambda a, b: _int8_matmul(a, b, a.dtype))


def _swiglu_int8_fwd(x, w_gate, w_up, w_down):
    g = _int8_matmul(x, w_gate, x.dtype)
    u = _int8_matmul(x, w_up, x.dtype)
    out = _int8_matmul(qmm.silu_hidden(g, u), w_down, x.dtype)
    return out, (x, g, u, w_gate, w_up, w_down)


def swiglu_int8(x, w_gate, w_up, w_down):
    """SwiGLU with all three products in int8; the whole-op backward
    recomputes ``h`` from the saved g, u (never saved) and is
    straight-through in the master dtype."""
    return qmm.QuantSwiGLU.apply(x, w_gate, w_up, w_down, _swiglu_int8_fwd,
                                 torch.matmul)


def _fused_fwd(x, w_gate, w_up, w_down):
    return qmm.swiglu_fused_fwd_res(x, w_gate, w_up, w_down, "int8")


def swiglu_int8_fused(x, w_gate, w_up, w_down):
    """SwiGLU with all three products through the fused kernel K11;
    exactly equal to ``swiglu_int8``, with the same backward."""
    return qmm.QuantSwiGLU.apply(x, w_gate, w_up, w_down, _fused_fwd,
                                 torch.matmul)


def swiglu_int8_fused_delayed(x, w_gate, w_up, w_down, qs):
    """Delayed-scaling fused SwiGLU (int8): ``qs`` is this layer's carried
    ``[amax_x, amax_h]`` from the previous step; returns ``(y, new_qs)``,
    the state carries no gradient.  A stale scale saturates at +-127."""
    return qmm.QuantSwiGLUDelayed.apply(x, w_gate, w_up, w_down, qs, "int8")


def _sb_dot(a, b_mat):
    return _int8_matmul(a, b_mat, a.dtype)


def swiglu_int8_sb(x, w_gate, w_up, w_down):
    """SwiGLU, int8 forward and int8 activation-gradient backward (the
    SwitchBack recipe): dh = dy . Wd^T and dx = dg . Wg^T + du . Wu^T are
    quantized per tensor, the three dW products stay in the master
    dtype."""
    return qmm.QuantSwiGLU.apply(x, w_gate, w_up, w_down, _swiglu_int8_fwd,
                                 _sb_dot)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    pad = size - t.shape[dim]
    if pad <= 0:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def _int_mm_exact(aq: torch.Tensor, bq: torch.Tensor) -> torch.Tensor:
    """``int32_product`` for any shape: ``torch._int_mm`` takes more than
    16 rows and K, N multiples of 8, so the card pads the operands with
    zeros (exact) and cuts the result back."""
    if not on_card(aq):
        return int32_product(aq, bq)
    m, k = aq.shape
    n = bq.shape[1]
    r8 = lambda v: -(-v // 8) * 8  # noqa: E731
    a = _pad_to(_pad_to(aq, 0, max(24, r8(m))), 1, r8(k))
    b = _pad_to(_pad_to(bq, 0, r8(k)), 1, r8(n))
    return int32_product(a, b)[:m, :n]


def _int8_batched_product(x, w):
    xq, sx = _quantize(x)
    wq, sw = _quantize(w)
    acc = torch.stack([_int_mm_exact(xq[e], wq[e])
                       for e in range(x.shape[0])])
    return (acc.to(_F32) * (sx * sw)).to(x.dtype)


class _Int8DotBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _int8_batched_product(x, w)

    @staticmethod
    def backward(ctx, dy):
        from dlnetbench_tpu_torch.models.layers import dot_f32
        x, w = ctx.saved_tensors
        dx = dot_f32(dy, w.transpose(1, 2)).to(x.dtype)
        dw = dot_f32(x.transpose(1, 2), dy).to(w.dtype)
        return dx, dw


def int8_dot_batched(x, w):
    """``[E, C, K] x [E, K, N] -> [E, C, N]`` in x's dtype: both operands
    quantized per tensor, int32 sums per expert (exact), the scales
    re-applied; the backward is straight-through in the master dtype
    (``dx = dy . w^T``, ``dw = x^T . dy`` per expert, f32 sums)."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"int8_dot_batched: x {tuple(x.shape)} must be "
                         f"[E, C, K] and w {tuple(w.shape)} [E, K, N]")
    return _Int8DotBatched.apply(x, w)
