"""The quantization recipes of the JAX package's
``ops/quantized_matmul.py`` (``_FORMATS``, ``scale_from_amax``,
``_cast_q``) — the one spelling of the symmetric per-tensor scale that
the quantized KV cache shares.  The fused quantized matmul kernel itself
is not ported yet (ROADMAP.md queue 2).
"""
from __future__ import annotations

import torch

# format table: (quantized dtype, symmetric max, accumulator dtype)
FORMATS = {
    "int8": (torch.int8, 127.0, torch.int32),
    "float8": (torch.float8_e4m3fn, 448.0, torch.float32),
}


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
