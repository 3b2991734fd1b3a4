"""Building-block layers of the dense gated transformer, in PyTorch (the
JAX package's ``models/layers.py``).  The cast points are the JAX
package's: norm statistics and RoPE in f32, each projection rounded to
the compute dtype, SwiGLU's gate in f32, softmax and the loss's
logsumexp in f32."""
from __future__ import annotations

import torch
import torch.nn.functional as F

_F32 = torch.float32


def init_dense(gen: torch.Generator, shape, scale: float, dtype,
               device) -> torch.Tensor:
    """Gaussian init in f32 from ``gen``, cast to the compute dtype."""
    w = torch.randn(shape, generator=gen, device=device, dtype=_F32)
    return (w * scale).to(dtype)


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the JAX package's hand-written backward
    (``models/layers.py`` ``_rmsnorm_bwd``): the scale gradient and the
    input gradient are computed as separate passes, with the same cast
    points."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        var = x.to(_F32).square().mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, scale, rstd)
        return (x * rstd.to(x.dtype)) * scale

    @staticmethod
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        xhat = x * rstd.to(x.dtype)
        dscale = (dy.to(_F32) * xhat.to(_F32)).sum(
            dim=tuple(range(x.dim() - 1))).to(scale.dtype)
        t = dy * scale
        c = (t.to(_F32) * xhat.to(_F32)).mean(dim=-1, keepdim=True)
        dx = (t.to(_F32) - xhat.to(_F32) * c) * rstd
        return dx.to(x.dtype), dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale``, statistics in f32."""
    return _RMSNorm.apply(x, scale, eps)


def rope_tables(positions: torch.Tensor, dh: int,
                theta: float = 10000.0) -> tuple:
    """``(cos, sin)`` of ``positions * inv_freq`` in f32, shaped
    ``[S, 1, Dh/2]`` to broadcast over heads.  Every layer rotates by
    the same tables, so a step computes them once."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=_F32,
                                             device=positions.device) / dh))
    angles = positions.to(_F32)[:, None] * inv_freq
    return torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]


def apply_rope(x: torch.Tensor, tables: tuple) -> torch.Tensor:
    """Rotate ``x`` ``[..., S, H, Dh]`` by ``rope_tables``; split-halves
    convention, f32 arithmetic, result in ``x``'s dtype."""
    cos, sin = tables
    x1, x2 = x.to(_F32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0):
    """Rotary embeddings; q/k ``[..., S, H, Dh]``, positions ``[S]`` (a
    decode batch passes one position per slot as its ``S``)."""
    tables = rope_tables(positions, q.shape[-1], theta)
    return apply_rope(q, tables), apply_rope(k, tables)


def swiglu_fwd_res(x: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor):
    """The SwiGLU forward, returning ``(y, residuals)``: the one place
    the three-product body lives — the autograd path (``swiglu``) and
    the split-product and fused-kernel backwards
    (``ops/mlp_backward.py``) all call it.  Each projection is rounded to
    the compute dtype, so the saved g and u are bf16 in a bf16 model."""
    g = (x @ w_gate).to(x.dtype)
    u = (x @ w_up).to(x.dtype)
    h = (F.silu(g.to(_F32)) * u.to(_F32)).to(g.dtype)
    return (h @ w_down).to(x.dtype), (x, g, u, w_gate, w_up, w_down)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return swiglu_fwd_res(x, w_gate, w_up, w_down)[0]


def quantized_swiglu(x, w_gate, w_up, w_down, *, mlp_dtype: str,
                     quant_fusion: str = "composed",
                     int8_backward: str = "master", amax_state=None):
    """The one dispatch point for the low-precision SwiGLU recipes
    (``transformer._block`` calls it; ``TransformerConfig`` validates
    the combinations): ``quant_fusion="composed"`` quantizes in separate
    passes around a plain quantized product (``ops/int8.py``,
    ``ops/fp8.py``); ``"fused"`` runs the fused kernel K11
    (``ops/quantized_matmul.py``).  ``amax_state`` (a ``[amax_x,
    amax_h]`` f32 pair, fused only) selects delayed scaling, and the
    return value is then ``(y, new_state)``."""
    if amax_state is not None and quant_fusion != "fused":
        # a composed call handing state would otherwise silently get the
        # fused path
        raise ValueError(
            "quantized_swiglu: amax_state (delayed scaling) requires "
            "quant_fusion='fused'")
    if mlp_dtype == "int8":
        from dlnetbench_tpu_torch.ops import int8 as q8
        if amax_state is not None:
            return q8.swiglu_int8_fused_delayed(x, w_gate, w_up, w_down,
                                                amax_state)
        if quant_fusion == "fused":
            return q8.swiglu_int8_fused(x, w_gate, w_up, w_down)
        if int8_backward == "switchback":
            return q8.swiglu_int8_sb(x, w_gate, w_up, w_down)
        return q8.swiglu_int8(x, w_gate, w_up, w_down)
    if mlp_dtype == "float8":
        from dlnetbench_tpu_torch.ops import fp8 as qf8
        if amax_state is not None:
            return qf8.swiglu_fp8_fused_delayed(x, w_gate, w_up, w_down,
                                                amax_state)
        if quant_fusion == "fused":
            return qf8.swiglu_fp8_fused(x, w_gate, w_up, w_down)
        return qf8.swiglu_fp8(x, w_gate, w_up, w_down)
    raise ValueError(f"quantized_swiglu: not a quantized mlp_dtype "
                     f"{mlp_dtype!r}")


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with an f32 result (the JAX package's
    ``preferred_element_type=f32``).  bf16 operands on the card keep
    bf16 inputs and an f32 output in one matmul; on the CPU they are
    widened first (exact: a bf16 value is an f32 value)."""
    if x.dtype == _F32 and w.dtype == _F32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=_F32)
    return x.to(_F32) @ w.to(_F32)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    """The einsum reference: q ``[B, S, Hq, Dh]``, k/v ``[B, S, Hkv,
    Dh]`` (GQA by reshape, KV never broadcast); scores and softmax in
    f32, probabilities rounded to v's dtype before the AV product."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(_F32), k.to(_F32))
    scores = scores / torch.sqrt(torch.tensor(dh, dtype=_F32))
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).to(_F32),
                       v.to(_F32))
    return out.reshape(b, s, hq, dh).to(v.dtype)


def cross_entropy(logits: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, ``mean(logsumexp - logits[target])``:
    the logsumexp in f32, the target logit gathered in the logits' own
    dtype (the full log-probability tensor is never formed)."""
    lse = torch.logsumexp(logits.to(_F32), dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - tgt.to(_F32)).mean()
