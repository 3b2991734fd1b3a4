"""Building-block layers of the transformer families, in PyTorch (the
JAX package's ``models/layers.py``): norms (RMSNorm, LayerNorm), RoPE,
SwiGLU, the GELU MLP, attention, the loss, and the MoE router, capacity
dispatch and combine.  The cast points are the JAX package's: norm
statistics and RoPE in f32, each projection rounded to the compute
dtype, SwiGLU's gate and GELU in f32, router logits, softmax and the
loss's logsumexp in f32.  The capacity dispatch
is held as indices (``Routing``): gathers and scatters in place of the
JAX package's one-hot einsums, with the same values."""
from __future__ import annotations

import dataclasses

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


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps)`` with the mean and population
    variance in f32, cast to x's dtype, and only then ``* scale + bias``
    in that dtype (the JAX package's order; ``F.layer_norm`` applies the
    affine before it casts)."""
    xf = x.to(_F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


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


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """The GELU MLP (gpt2 and ViT): ``a = x @ w_in + b_in`` with an f32
    result rounded to x's dtype, ``h = gelu(a)`` in f32 rounded again
    (the tanh form: ``jax.nn.gelu``'s default), then ``h @ w_out +
    b_out`` with an f32 result rounded to x's dtype, so the saved
    ``[..., ff]`` activations are in the compute dtype."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    a = (dot_f32(x2, w_in) + b_in.to(_F32)).to(x.dtype)
    h = F.gelu(a.to(_F32), approximate="tanh").to(x.dtype)
    y = (dot_f32(h, w_out) + b_out.to(_F32)).to(x.dtype)
    return y.reshape(*shape[:-1], y.shape[-1])


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched over the leading axis) with an f32
    result and no autograd: two bf16 operands on the card in one library
    product with f32 output, every other pair widened to f32 first."""
    if a.is_cuda and a.dtype == b.dtype != _F32:
        return (torch.bmm if a.dim() == 3 else torch.mm)(a, b,
                                                         out_dtype=_F32)
    return a.to(_F32) @ b.to(_F32)


class _ProductF32(torch.autograd.Function):
    """The card's f32-output product of two bf16 operands, made
    differentiable (the library's ``mm``/``bmm`` with ``out_dtype`` has
    no derivative).  The f32 cotangent is rounded to the operands' dtype
    and each gradient product is again bf16 x bf16 with an f32 sum, then
    cast to its operand's dtype: the tensor-core form of the JAX
    transpose rule, which multiplies the f32 cotangent by the widened
    operand (``ops/quantized_matmul.swiglu_bwd_impl`` rounds the same
    way)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gc = f32_cotangent(g, a, b)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _product_f32(gc, b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _product_f32(a.transpose(-1, -2), gc).to(b.dtype)
        return da, db


def f32_cotangent(g: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """The cotangent that ``a @ b``'s gradient products multiply, ``g``
    that of its f32 result: on the card, with two narrower operands of
    one dtype, rounded to their dtype, so each gradient product is again
    a tensor-core product with f32 sums; otherwise ``g`` as it is (the
    JAX formulas exactly).  ``_ProductF32`` and the decomposed
    collective matmuls (``ops/collective_matmul.py``) share it."""
    if g.is_cuda and a.dtype == b.dtype != g.dtype:
        return g.to(a.dtype)
    return g


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with an f32 result (the JAX package's
    ``preferred_element_type=f32``), for 2-D operands or 3-D ones batched
    over the leading axis.  Two bf16 operands on the card keep bf16
    inputs and an f32 output in one product (``_ProductF32``, whose
    backward rounds the cotangent to bf16); on the CPU, and for f32 or
    mixed operands, they are widened first (exact: a bf16 value is an f32
    value) and autograd follows the JAX formulas exactly."""
    if x.dtype == _F32 and w.dtype == _F32:
        return x @ w
    if x.is_cuda and x.dtype == w.dtype:
        return _ProductF32.apply(x, w)
    return x.to(_F32) @ w.to(_F32)


# ------------------------------------------------------------------ MoE

def router_logits(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """The one spelling of the router projection, in f32 (router logits
    are precision-sensitive): ``moe_router`` and the seeded grouped
    routing of ``models/moe.py`` both build on it."""
    return x.to(_F32) @ w_router.to(_F32)


def moe_router(x: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """Token router: ``(weights [T, k], expert indices [T, k])``, the
    indices by descending logit and the weights a softmax over the
    selected top-k logits (the Mixtral convention).  Among equal logits
    the lower index comes first, as in ``jax.lax.top_k``: a stable
    descending sort, cut to k columns (``torch.topk`` orders ties in no
    stated way)."""
    vals, idx = torch.sort(router_logits(x, w_router), dim=-1,
                           descending=True, stable=True)
    return torch.softmax(vals[..., :top_k], dim=-1), idx[..., :top_k]


@dataclasses.dataclass
class Routing:
    """A capacity dispatch held as indices instead of one-hots.

    ``weights``/``idx`` are the router's ``[T, k]`` output; ``slot[t, j]``
    is the buffer slot of choice j of token t in expert ``idx[t, j]``'s
    buffer of ``capacity`` slots, or -1 where the choice was dropped.
    Each slot holds at most one token, so the gather in ``buffers`` gives
    exactly the values of the JAX package's ``einsum("tec,td->ecd",
    disp, x)``, and ``combine`` sums the same at most k products per
    token as its ``einsum("ecd,tec->td", out, disp * gate)``.  ``disp``
    builds the ``[T, E, C]`` one-hots for callers that need them."""
    weights: torch.Tensor
    idx: torch.Tensor
    slot: torch.Tensor
    num_experts: int
    capacity: int

    @property
    def gate(self) -> torch.Tensor:
        """``[T, E]`` f32 combine weights (zero where not routed)."""
        t = self.weights.shape[0]
        return torch.zeros((t, self.num_experts), dtype=_F32,
                           device=self.weights.device).scatter(
                               1, self.idx, self.weights.to(_F32))

    def _flat(self) -> torch.Tensor:
        """``[T, k]`` row of each choice in the flattened ``[E * C]``
        buffer; a dropped choice points at the dummy row ``E * C``."""
        dummy = self.num_experts * self.capacity
        return torch.where(self.slot >= 0,
                           self.idx * self.capacity + self.slot, dummy)

    def buffers(self, x: torch.Tensor) -> torch.Tensor:
        """``[E, C, d]`` expert buffers of x ``[T, d]``, in x's dtype;
        empty slots are zeros."""
        t, d = x.shape
        n = self.num_experts * self.capacity
        tok = torch.arange(t, device=x.device)[:, None].expand_as(self.slot)
        src = torch.full((n + 1,), t, dtype=torch.long, device=x.device)
        src.scatter_(0, self._flat().reshape(-1), tok.reshape(-1))
        xp = torch.cat([x, x.new_zeros((1, d))])
        return xp[src[:n]].reshape(self.num_experts, self.capacity, d)

    def disp(self) -> torch.Tensor:
        """``[T, E, C]`` f32 dispatch one-hots."""
        t = self.slot.shape[0]
        c = self.capacity
        out = torch.zeros((t, self.num_experts, c + 1), dtype=_F32,
                          device=self.slot.device)
        idx = torch.where(self.slot >= 0, self.slot, c)
        out[torch.arange(t, device=idx.device)[:, None], self.idx, idx] = 1.0
        return out[..., :c]

    def kept(self) -> torch.Tensor:
        """``[E]`` f32 count of kept tokens per expert."""
        hits = torch.zeros(self.num_experts + 1, dtype=_F32,
                           device=self.slot.device)
        dest = torch.where(self.slot >= 0, self.idx, self.num_experts)
        hits.index_add_(0, dest.reshape(-1),
                        torch.ones(dest.numel(), dtype=_F32,
                                   device=dest.device))
        return hits[:self.num_experts]

    def combine(self, out: torch.Tensor) -> torch.Tensor:
        """Expert outputs ``[E, C, d]`` -> tokens ``[T, d]`` in f32: each
        token's kept choices, weighted by their gates, summed."""
        d = out.shape[-1]
        flat = torch.cat([out.reshape(-1, d).to(_F32),
                          out.new_zeros((1, d), dtype=_F32)])
        rows = flat[self._flat()]                            # [T, k, d]
        return (rows * self.weights.to(_F32)[..., None]).sum(dim=1)


def capacity_routing(weights, idx, num_experts: int, cap: int, *,
                     n_groups: int = 1, order=None) -> Routing:
    """Capacity slots for router choices: tokens are split into
    ``n_groups`` groups of consecutive tokens, each with ``cap`` slots per
    expert (group g owns slots ``[g * cap, (g + 1) * cap)``), and within
    a group each expert's slots go to its tokens in queue order —
    arrival order, or ``order`` (``[G, g]`` token positions within each
    group, the seeded priority).  Positions are integer counts, the same
    numbers as the JAX package's f32 cumsum; choices past capacity are
    dropped (slot -1)."""
    t, _ = idx.shape
    g = t // n_groups
    mask = torch.zeros((t, num_experts), dtype=torch.long,
                       device=idx.device).scatter(1, idx, 1)
    maskg = mask.reshape(n_groups, g, num_experts)
    if order is None:
        pos = torch.cumsum(maskg, dim=1) - 1
    else:
        sort_idx = order[..., None].expand_as(maskg)
        pos_sorted = torch.cumsum(torch.gather(maskg, 1, sort_idx), dim=1) - 1
        pos = torch.empty_like(pos_sorted).scatter_(1, sort_idx, pos_sorted)
    base = (torch.arange(n_groups, device=idx.device) * cap)[:, None, None]
    slot = torch.where((maskg > 0) & (pos < cap), pos + base, -1)
    slot = torch.gather(slot.reshape(t, num_experts), 1, idx)
    return Routing(weights=weights, idx=idx, slot=slot,
                   num_experts=num_experts, capacity=n_groups * cap)


def moe_capacity(tokens: int, top_k: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Dispatch slots per expert: ``max(1, int(cf * T * k / E))``, the
    JAX package's expression."""
    return max(1, int(capacity_factor * tokens * top_k / num_experts))


def moe_route(x2d, w_router, num_experts: int, top_k: int,
              capacity_factor: float) -> Routing:
    """The legacy capacity dispatch (one group, arrival order) as a
    ``Routing``."""
    weights, idx = moe_router(x2d, w_router, top_k)
    cap = moe_capacity(x2d.shape[0], top_k, num_experts, capacity_factor)
    return capacity_routing(weights, idx, num_experts, cap)


def moe_dense(x2d, w_router, w_gate, w_up, w_down, top_k: int):
    """Dense MoE (every expert computes every token, the selected ones
    combined): experts stacked on the leading axis of ``w_*``.  Forms
    ``[E, T, ff]`` f32 — for tests and small models."""
    t, d = x2d.shape
    e = w_gate.shape[0]
    weights, idx = moe_router(x2d, w_router, top_k)
    combine = torch.zeros((t, e), dtype=_F32, device=x2d.device).scatter(
        1, idx, weights)                                     # [T, E]
    xb = x2d.expand(e, t, d)
    h = F.silu(dot_f32(xb, w_gate)) * dot_f32(xb, w_up)      # [E, T, ff]
    y = dot_f32(h.to(x2d.dtype), w_down)                     # [E, T, D]
    return (y * combine.t()[..., None]).sum(dim=0).to(x2d.dtype)


def moe_dispatch(x2d, w_router, num_experts: int, top_k: int,
                 capacity_factor: float):
    """Capacity-based token dispatch (GShard/Switch style, arrival
    order): ``(xe [E, C, d] f32 expert inputs, disp [T, E, C] one-hots,
    gate [T, E] combine weights)``, C = ``moe_capacity``; tokens past
    capacity are dropped (their combine weight is zero)."""
    r = moe_route(x2d, w_router, num_experts, top_k, capacity_factor)
    return r.buffers(x2d).to(_F32), r.disp(), r.gate


def moe_combine(out, disp, gate):
    """Scatter per-expert outputs ``[E, C, d]`` back to tokens ``[T, d]``
    with ``moe_dispatch``'s one-hots and combine weights (f32)."""
    return torch.einsum("ecd,tec->td", out.to(_F32),
                        disp * gate[..., None])


def expert_swiglu(xe, w_gate, w_up, w_down) -> torch.Tensor:
    """The expert SwiGLU over dispatch buffers ``[E, C, d]`` -> ``[E, C,
    d]`` f32: the two up products with f32 results, ``silu(g) * u`` in
    f32 rounded to the buffers' dtype, the down product with an f32
    result."""
    h = F.silu(dot_f32(xe, w_gate)) * dot_f32(xe, w_up)
    return dot_f32(h.to(xe.dtype), w_down)


def moe_sparse(x2d, w_router, w_gate, w_up, w_down, top_k: int,
               capacity_factor: float = 1.25):
    """Capacity-based sparse MoE: expert work is E * C * ff, about
    k * cf * T * ff, instead of ``moe_dense``'s E * T * ff; at
    ``capacity_factor >= E / top_k`` nothing drops and the result is
    ``moe_dense``'s."""
    e = w_gate.shape[0]
    r = moe_route(x2d, w_router, e, top_k, capacity_factor)
    out = expert_swiglu(r.buffers(x2d), w_gate, w_up, w_down)
    return r.combine(out).to(x2d.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, dense_mask=None) -> torch.Tensor:
    """The einsum reference: q ``[B, S, Hq, Dh]``, k/v ``[B, S, Hkv,
    Dh]`` (GQA by reshape, KV never broadcast); scores and softmax in
    f32, probabilities rounded to v's dtype before the AV product.

    ``dense_mask`` (an ``[S, S]`` bool, True = attend, from
    ``ops/attention_mask.dense_mask``) replaces the causal tril when
    given: it already encodes the causal half.  This is the dense-masked
    reference the splash op is held against; it pays the whole S x S
    grid."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(_F32), k.to(_F32))
    scores = scores / torch.sqrt(torch.tensor(dh, dtype=_F32))
    if dense_mask is not None:
        mask = torch.as_tensor(dense_mask, dtype=torch.bool,
                               device=q.device)
        scores = scores.masked_fill(~mask, float("-inf"))
    elif causal:
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
