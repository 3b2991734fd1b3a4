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
