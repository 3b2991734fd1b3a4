"""float8 (e4m3) matmul with per-tensor dynamic scales and the e4m3
SwiGLU recipes (the port of the JAX package's ``ops/fp8.py``).

Each operand is scaled by max-abs / 448 per tensor, cast to
``float8_e4m3fn``, multiplied with f32 accumulation, and the product of
the two scales is applied to the f32 result; the backward is
straight-through in the master dtype.

The composed recipe's product is one the JAX package leaves to XLA, not
a Pallas kernel, so on the card it is a library call,
``torch._scaled_mm`` with unit scales and an f32 output (the JAX
epilogue ``acc * (sx * sw)`` follows it); on the CPU it is the plain f32
product of the dequantized values.  It never stands in for the fused
kernel K11.
"""
from __future__ import annotations

import torch

from dlnetbench_tpu_torch.ops import quantized_matmul as qmm
from dlnetbench_tpu_torch.ops.common import on_card

_F32 = torch.float32


def _quantize(x):
    return qmm.quantize_tensor(x, "float8")


def e4m3_product(aq: torch.Tensor, bq: torch.Tensor) -> torch.Tensor:
    """``aq @ bq`` (2-D e4m3 operands) accumulated in f32: on the card
    ``torch._scaled_mm`` (second operand column-major, dimensions
    multiples of 16), on the CPU the plain product of the dequantized
    values."""
    if not on_card(aq):
        return qmm.quantized_product(aq, bq, "float8")
    one = torch.ones((), dtype=_F32, device=aq.device)
    return torch._scaled_mm(aq.contiguous(), qmm.k_major(bq).t(),
                            scale_a=one, scale_b=one, out_dtype=_F32)


def quantized_weight_dot(x, wq, sw):
    """``[..., K] x [K, N] -> [..., N]`` against a weight already
    quantized (``wq`` e4m3, ``sw`` its scale): x quantized per call, the
    e4m3 product, the JAX epilogue ``acc * (sx * sw)``, result in x's
    dtype.  Forward only."""
    xq, sx = _quantize(x)
    acc = e4m3_product(xq.reshape(-1, xq.shape[-1]), wq)
    out = (acc * (sx * sw)).to(x.dtype)
    return out.reshape(*x.shape[:-1], wq.shape[-1])


def _fp8_matmul(x, w):
    return quantized_weight_dot(x, *_quantize(w))


def fp8_dot(x, w):
    """``[..., K] x [K, N] -> [..., N]``: e4m3 operands, f32
    accumulation, result in x's dtype; straight-through backward."""
    return qmm._STDot.apply(x, w, _fp8_matmul)


def swiglu_fp8(x, w_gate, w_up, w_down):
    """SwiGLU with all three products in e4m3, composed of ``fp8_dot``s
    (autograd through the hidden ``h``, as the JAX package's)."""
    g = fp8_dot(x, w_gate)
    u = fp8_dot(x, w_up)
    return fp8_dot(qmm.silu_hidden(g, u), w_down)


def _fused_fwd(x, w_gate, w_up, w_down):
    return qmm.swiglu_fused_fwd_res(x, w_gate, w_up, w_down, "float8")


def swiglu_fp8_fused(x, w_gate, w_up, w_down):
    """SwiGLU with all three products through the fused kernel K11; the
    whole-op backward recomputes ``h`` and is straight-through."""
    return qmm.QuantSwiGLU.apply(x, w_gate, w_up, w_down, _fused_fwd,
                                 torch.matmul)


def swiglu_fp8_fused_delayed(x, w_gate, w_up, w_down, qs):
    """Delayed-scaling fused SwiGLU (e4m3): scales from the carried
    ``[amax_x, amax_h]``, this step's amaxes emitted as the next state;
    returns ``(y, new_qs)``."""
    return qmm.QuantSwiGLUDelayed.apply(x, w_gate, w_up, w_down, qs,
                                        "float8")
