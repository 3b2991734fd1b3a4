"""Kernels and their wrappers.

* ``paged_attention``       — K1, decode attention over bf16/f32 pages;
* ``paged_attention_quant`` — K2, decode attention over int8/e4m3 pages;
* ``flash_attention``       — K3/K4/K5, flash attention forward, dq and
  dk/dv (the training path), and K6/K7/K8, the same under a block-sparse
  mask (``splash_attention``);
* ``attention_mask``        — mask specs, row intervals and the
  BlockMasks the splash kernels read;
* ``quantized_matmul``      — K11, the fused-quantization matmul, and
  the shared quantization recipes (with ``int8``, ``fp8`` and
  ``mlp_backward``, K9/K10, the MLP recipes);
* ``grouped_matmul``        — K12, the grouped per-expert matmul of the
  MoE expert FFN (bf16, f32, int8, e4m3) and the grouped SwiGLU;
* ``common``                — the CUDA/CPU device split;
* ``_build``                — builds ``csrc/*.cu`` with nvcc at first use.

``attention`` is the dispatcher the models call (the JAX package's
``ops.attention``).  Importing this package builds nothing
and needs no card: a kernel is compiled the first time a wrapper is
called on a CUDA tensor.
"""
from __future__ import annotations

from dlnetbench_tpu_torch.models import layers as _L
from dlnetbench_tpu_torch.ops import attention_mask as _M
from dlnetbench_tpu_torch.ops import flash_attention as _FA
from dlnetbench_tpu_torch.ops.common import on_card

__all__ = ["attention"]


def attention(q, k, v, causal: bool, impl: str = "auto", mask=None):
    """q ``[B, S, Hq, Dh]``, k/v ``[B, S, Hkv, Dh]`` -> ``[B, S, Hq, Dh]``.

    ``impl``: "flash" — the flash op (kernels K3/K4/K5 on a CUDA tensor,
    their plain versions on a CPU tensor), or with ``mask`` the splash op
    (K6/K7/K8, or their plain versions), raising where the shape is one
    they cannot take; "auto" — the same wherever the shape is one they
    take, else the einsum reference ``layers.attention`` (below); "xla"
    — the einsum reference on a CPU tensor, with ``mask`` applied densely
    (the name is the JAX package's; here it is for tests only, and a
    CUDA tensor is refused, so nothing routes the card around the
    kernels by choice).

    ``mask`` (a ``MaskSpec``, ops/attention_mask.py) must agree with
    ``causal``; the plain-causal spec is the ``mask=None`` path itself.

    The JAX package's "auto" picks flash only on a TPU at S >= 2048, a
    threshold measured on the TPU; the port's "auto" takes the kernels
    on the card at every length they support.  Off the kernels, "auto"
    runs the einsum reference, as the JAX package does wherever its
    kernel's blocks find no fit, except at S >= 64k, where it refuses
    (the S^2 score matrix would materialize).  On a CUDA tensor that
    dense route is taken only for a sequence no 128-row tile divides
    (ViT's 197 and 257 tokens: JAX's gate finds no block there either),
    and each such call is counted in ``flash_attention.
    dense_attention_calls``; a tile-aligned sequence with a head dim or
    a head grouping the kernels lack raises on the card.
    """
    s = q.shape[1]
    if mask is not None:
        if mask.causal != causal:
            raise ValueError(
                f"attention: mask spec {mask.label()!r} has "
                f"causal={mask.causal} but the call says causal={causal}")
        if mask.is_plain_causal:
            mask = None   # the dense-causal default IS this mask
    if impl == "xla":
        if on_card(q):
            raise ValueError("attention: impl='xla' is the CPU reference; "
                             "a CUDA tensor runs the flash kernels "
                             "(impl='auto')")
        return _L.attention(q, k, v, causal=causal,
                            dense_mask=_dense(mask, s))
    if impl == "flash":
        if mask is not None:
            return _FA.splash_attention(q, k, v, mask)
        return _FA.flash_attention(q, k, v, causal)
    if impl != "auto":
        raise ValueError(f"unknown attention impl {impl!r}")
    if _FA.flash_supported(q, k, v):
        if mask is not None:
            return _FA.splash_attention(q, k, v, mask)
        return _FA.flash_attention(q, k, v, causal)
    if s >= _FA.LONG_SEQ:
        raise ValueError(
            f"attention: impl='auto' refuses the dense fallback at "
            f"seq_len {s} >= {_FA.LONG_SEQ} (the S^2 score matrix would "
            f"materialize); pad the sequence to a multiple of 128 for the "
            f"flash kernels or pass impl='xla' explicitly (CPU only)")
    if on_card(q):
        if s % _FA.SEQ_MULTIPLE == 0:
            raise ValueError(
                f"attention: the flash kernels cannot take q "
                f"{tuple(q.shape)} / k {tuple(k.shape)} (seq_len a "
                f"multiple of 128, head_dim 64 or 128) and a CUDA tensor "
                f"has no other path")
        _FA.dense_attention_calls += 1
    return _L.attention(q, k, v, causal=causal, dense_mask=_dense(mask, s))


def _dense(mask, s: int):
    """The [S, S] bool of a spec for the dense reference (None without
    one): built only where the reference runs."""
    return None if mask is None else _M.dense_mask(mask, s)
