"""Kernel K1: paged-KV single-query decode attention over bf16/f32 page
pools (the port of the upstream ``pallas.ops.tpu.paged_attention``
kernel that the JAX package calls at ``serving/kv_cache.py:768``).

``paged_attention`` is the wrapper: on CUDA tensors it launches the
hand-written Hopper kernel of ``csrc/paged_attention.cu`` (and counts
the launch in ``launches``); on CPU tensors it runs ``gather_attention``,
the plain PyTorch version — the JAX package's ``_gather_attention``
(``kv_cache.py:633``) math.  There is no fall back from the card to the
plain version.

Shapes (the JAX package's layout): q ``[B, Hq, Dh]`` pre-scaled by
``Dh**-0.5``; k/v pages ``[Hkv, P, S, Dh]``; lengths ``[B]`` int32 (valid
tokens, the one just written included); page_indices ``[B, Pmax]``
int32 (each slot's block table).  Returns ``[B, Hq, Dh]`` in q's dtype.

The kernel splits each slot's sequence over blocks of whole pages
(``split_pages``) and combines the partials in split order in the block
that finishes last; the wrapper hands it an f32 workspace for the
partials (``workspace_floats``) and a zeroed int32 counter per (slot,
KV head) that the kernel leaves zero (``counters``, one buffer per
device and stream, grown when needed).
"""
from __future__ import annotations

import ctypes

import torch

from dlnetbench_tpu_torch.ops import _build
from dlnetbench_tpu_torch.ops.common import on_card

# finite mask (the JAX package's kv_cache.MASK_VALUE): exp(mask - max)
# underflows to exactly 0, and a fully masked row can never give NaN
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# the C entry's dtype codes (csrc/paged_attention.cu, enum Dtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}

# the split of csrc/paged_attention.cu: a split takes the fewest whole
# pages holding SPLIT_TOKENS tokens (more if a block-table row would need
# over MAX_SPLITS of them); tests pin these to the CUDA constants
SPLIT_TOKENS = 64
MAX_SPLITS = 65535

# kernel launches made by ``paged_attention`` (reset by the caller)
launches = 0

# (device index, stream handle) -> zeroed int32 counters of the combine
_counters: dict = {}


def split_pages(page_size: int, pmax: int) -> int:
    """Pages a split of the kernel takes (csrc/paged_attention.cu,
    ``split_pages``): sized from the block table's width, never from the
    lengths, which stay on the card."""
    pps = -(-SPLIT_TOKENS // page_size)
    pps = max(pps, -(-pmax // MAX_SPLITS))
    return min(pps, pmax)


def num_splits(page_size: int, pmax: int) -> int:
    """The grid's split count (its z dimension)."""
    return -(-pmax // split_pages(page_size, pmax))


def workspace_floats(batch: int, hq: int, hkv: int, head_dim: int,
                     page_size: int, pmax: int) -> int:
    """f32 values of the kernel's workspace: every split's partial
    ``acc [G, Dh]`` and ``(m, l) [G, 2]`` per (slot, KV head)."""
    return (batch * hkv * num_splits(page_size, pmax) * (hq // hkv)
            * (head_dim + 2))


def counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The combine's per-(slot, KV head) counters for calls on
    ``stream``: zero between calls (the combining block resets its own),
    so the buffer is zeroed once, when it is made or grown."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def take_pages(pages, idx):
    """``pages[:, idx]`` for a ``[Hkv, P, ...]`` pool; e4m3 pools are
    indexed through a uint8 view of the same bytes."""
    idx = idx.long()
    if pages.dtype == torch.float8_e4m3fn:
        return pages.view(torch.uint8)[:, idx].view(pages.dtype)
    return pages[:, idx]


def gather_attention(q, k_pages, v_pages, lengths, page_indices,
                     k_scale=None, v_scale=None):
    """The plain version: gather each slot's pages contiguous, dequantize
    them when scales are given, mask by length, f32 softmax."""
    hkv, _, s, dh = k_pages.shape
    idx = page_indices.long()
    # [Hkv, B, Pmax, S, Dh] -> [B, Hkv, Pmax, S, Dh]
    k = take_pages(k_pages, idx).movedim(0, 1).float()
    v = take_pages(v_pages, idx).movedim(0, 1).float()
    if k_scale is not None:
        k = k * k_scale[:, idx].movedim(0, 1)[..., None, None]
        v = v * v_scale[:, idx].movedim(0, 1)[..., None, None]
    b, _, pmax, _, _ = k.shape
    k = k.reshape(b, hkv, pmax * s, dh)
    v = v.reshape(b, hkv, pmax * s, dh)
    g = q.shape[1] // hkv
    qg = q.reshape(b, hkv, g, dh).float()
    scores = torch.einsum("bhgd,bhtd->bhgt", qg, k)
    pos = torch.arange(pmax * s, device=q.device)
    mask = pos[None, :] < lengths.long()[:, None]              # [B, T]
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, MASK_VALUE))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v)
    return out.reshape(b, hkv * g, dh).to(q.dtype)


def check_operands(q, k_pages, v_pages, lengths, page_indices, *,
                   page_dtypes, k_scale=None, v_scale=None) -> None:
    """What the kernel takes; anything else raises before a launch."""
    tensors = [q, k_pages, v_pages, lengths, page_indices]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"paged attention: operands on {t.device} "
                             f"and {q.device}")
        if not t.is_contiguous():
            raise ValueError("paged attention: operands must be "
                             "contiguous")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"paged attention: q {tuple(q.shape)} must be "
                         f"[B, Hq, Dh] and pages {tuple(k_pages.shape)} "
                         f"[Hkv, P, S, Dh]")
    b, hq, dh = q.shape
    hkv, p, s, dh_k = k_pages.shape
    if v_pages.shape != k_pages.shape or dh_k != dh:
        raise ValueError(f"paged attention: pages {tuple(k_pages.shape)}"
                         f"/{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if hq % hkv or hq // hkv > 32:
        raise ValueError(f"paged attention: {hq} query heads over {hkv} "
                         f"KV heads (the group must divide and be <= 32)")
    if dh % 32 or dh > 256:
        raise ValueError(f"paged attention: head_dim {dh} must be a "
                         f"multiple of 32 and <= 256")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged attention: q dtype {q.dtype} (float32 "
                         f"or bfloat16)")
    if k_pages.dtype not in page_dtypes or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"paged attention: page dtype {k_pages.dtype} "
                         f"(one of {page_dtypes})")
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("paged attention: operands must be 16-byte "
                             "aligned")
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise ValueError("paged attention: lengths and page_indices must "
                         "be int32")
    if lengths.shape != (b,) or page_indices.dim() != 2 \
            or page_indices.shape[0] != b:
        raise ValueError(f"paged attention: lengths {tuple(lengths.shape)}"
                         f" / page_indices {tuple(page_indices.shape)} do "
                         f"not fit batch {b}")
    if k_scale is not None:
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or sc.shape != (hkv, p):
                raise ValueError(f"paged attention: scales must be f32 "
                                 f"[{hkv}, {p}], got {sc.dtype} "
                                 f"{tuple(sc.shape)}")


def launch(q, k_pages, v_pages, lengths, page_indices, k_scale=None,
           v_scale=None) -> torch.Tensor:
    """Call the C entry on the current stream; raise on its error code.
    Operands must already have passed ``check_operands``."""
    fn = _build.library("paged_attention").dlnb_paged_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    out = torch.empty_like(q)
    b, hq, dh = q.shape
    hkv, p, s, _ = k_pages.shape
    pmax = page_indices.shape[1]
    ws = torch.empty(workspace_floats(b, hq, hkv, dh, s, pmax),
                     dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    cnt = counters(q.device, stream, b * hkv)
    with torch.cuda.device(q.device):
        rc = fn(DTYPE_CODES[q.dtype], DTYPE_CODES[k_pages.dtype],
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scale.data_ptr() if k_scale is not None else None,
                v_scale.data_ptr() if v_scale is not None else None,
                lengths.data_ptr(), page_indices.data_ptr(),
                out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), b, hq, hkv,
                p, s, dh, pmax, stream)
    if rc != 0:
        raise RuntimeError(f"paged attention kernel: cudaError_t {rc} "
                           f"(q {tuple(q.shape)} {q.dtype}, pages "
                           f"{tuple(k_pages.shape)} {k_pages.dtype})")
    return out


def paged_attention(q, k_pages, v_pages, lengths, page_indices):
    """K1: decode attention over a bf16/f32 page pool (pages in q's
    dtype).  CUDA tensors launch the kernel; CPU tensors run
    ``gather_attention``."""
    global launches
    if not on_card(q):
        return gather_attention(q, k_pages, v_pages, lengths,
                                page_indices)
    check_operands(q, k_pages, v_pages, lengths, page_indices,
                   page_dtypes=(q.dtype,))
    out = launch(q, k_pages, v_pages, lengths, page_indices)
    launches += 1
    return out
