"""Kernel K2: paged-KV decode attention over QUANTIZED page pools — int8
or e4m3 pages with per-page, per-head f32 scales (the port of the JAX
package's ``ops/paged_attention_quant.py::_kernel``).

``quant_paged_attention`` is the wrapper: on CUDA tensors it launches
the Hopper kernel of ``csrc/paged_attention.cu`` with the scale
pointers set (counted in ``launches``), reading the quantized pages
through the block table — where the JAX wrapper first gathers them into
a contiguous copy, the kernel loads only the pages below
``ceil(len / page_size)``.  On CPU tensors it runs
``dequant_gather_attention``: the dequantizing gather, then the K1
plain math (``paged_attention.gather_attention`` with scales).

q ``[B, Hq, Dh]`` pre-scaled; k/v pages ``[Hkv, P, S, Dh]`` int8 or
float8_e4m3fn; k/v scales ``[Hkv, P]`` f32; lengths ``[B]`` and
page_indices ``[B, Pmax]`` int32.
"""
from __future__ import annotations

import torch

from dlnetbench_tpu_torch.ops import paged_attention as _pa
from dlnetbench_tpu_torch.ops.common import on_card

FORMATS = {"int8": torch.int8, "float8": torch.float8_e4m3fn}

# kernel launches made by ``quant_paged_attention`` (reset by the caller)
launches = 0


def dequant_gather_attention(q, k_pages, v_pages, k_scale, v_scale,
                             lengths, page_indices):
    """The plain version: gather, dequantize (page values times their
    page's scale, in f32), then the masked f32-softmax attention."""
    return _pa.gather_attention(q, k_pages, v_pages, lengths,
                                page_indices, k_scale, v_scale)


def quant_paged_attention(q, k_pages, v_pages, k_scale, v_scale, lengths,
                          page_indices, *, fmt: str):
    """K2.  ``fmt`` names the recipe ('int8' | 'float8') and must match
    the pools' dtype."""
    global launches
    if fmt not in FORMATS:
        raise ValueError(f"quant_paged_attention: unknown fmt {fmt!r}")
    if k_pages.dtype != FORMATS[fmt]:
        raise ValueError(f"quant_paged_attention: fmt {fmt!r} but pages "
                         f"are {k_pages.dtype}")
    if not on_card(q):
        return dequant_gather_attention(q, k_pages, v_pages, k_scale,
                                        v_scale, lengths, page_indices)
    _pa.check_operands(q, k_pages, v_pages, lengths, page_indices,
                       page_dtypes=(FORMATS[fmt],), k_scale=k_scale,
                       v_scale=v_scale)
    out = _pa.launch(q, k_pages, v_pages, lengths, page_indices, k_scale,
                     v_scale)
    launches += 1
    return out
