"""The decode-path transformer: prefill/decode over the paged KV cache
(the JAX package's ``serving/decode.py``, dense greedy path).

Two programs cover serving, with the JAX package's signatures:

* ``make_decode_step`` — ONE token per decode slot, full batch (shape
  ``[slots]``; inactive slots write nothing): project q/k/v for the fed
  token, write k/v into the slot's current page, attend over everything
  cached through kernel K1 or K2 (``kv_cache.paged_attention_decode``),
  MLP, greedy-pick the next token from f32 logits.
* ``make_prefill_chunk`` — one sequence, one chunk of its prompt: write
  the chunk's K/V into the slot's pages and attend causally over cache
  + chunk.  This attention is plain PyTorch (a gather of the slot's
  pages and a masked softmax), as it is plain XLA in the JAX package.

The programs run eagerly and update the pools in place; each returns
the pools it was given followed by the next token(s).
"""
from __future__ import annotations

import numpy as np
import torch

from dlnetbench_tpu_torch.models import layers as L
from dlnetbench_tpu_torch.models.transformer import TransformerConfig
from dlnetbench_tpu_torch.ops.paged_attention import take_pages
from dlnetbench_tpu_torch.serving.arrivals import _Rng
from dlnetbench_tpu_torch.serving.kv_cache import (MASK_VALUE, CacheConfig,
                                                   dequant_gathered,
                                                   paged_attention_decode,
                                                   span_plan, write_gate,
                                                   write_rows, write_span)

_F32 = torch.float32


def check_config(cfg: TransformerConfig) -> TransformerConfig:
    """The serving path covers the dense gated family without attention
    masks (``TransformerConfig`` already refuses everything else).  The
    JAX package refuses a segment mask in serving and a window in decode
    (its windowed prefill runs no Pallas kernel and is not ported yet),
    with these messages; the port's engine always decodes, so it refuses
    both."""
    if cfg.num_experts > 1:
        raise ValueError("serving decode: MoE decode (the JAX package's "
                         "serving/moe_decode.py) is not ported yet "
                         "(ROADMAP.md queue 1)")
    if not cfg.gated or cfg.max_positions:
        raise ValueError("serving decode covers the dense gated "
                         "(SwiGLU+RMSNorm+RoPE) family only")
    if cfg.attention_seg_avg:
        raise ValueError(
            "serving decode supports sliding-window attention masks "
            "only (attention_window); document-segment masks have no "
            "serving path — a request is one document")
    if cfg.attention_window:
        raise ValueError(
            "serving decode has no sliding-window path yet (the paged "
            "attention kernel attends the full cache): "
            "attention_window covers the PREFILL chunk only — decode "
            "under a window config would silently diverge from the "
            "training mask")
    return cfg


def _layer(params: dict, li: int) -> dict:
    return {name: w[li] for name, w in params["layers"].items()}


def _logits(cfg: TransformerConfig, params: dict, x):
    """f32 logits of the final-normed ``x`` (the JAX package's
    ``preferred_element_type=f32`` head product)."""
    x = L.rmsnorm(x, params["final_norm"])
    head = params["embed"].T if cfg.tied_embeddings else params["head"]
    return L.dot_f32(x, head)


def _split_pools(cache_cfg: CacheConfig, pools: tuple) -> tuple:
    """``(k_pages, v_pages, k_scale, v_scale)``, scales None when dense."""
    if cache_cfg.quantized:
        return pools
    k_pages, v_pages = pools
    return k_pages, v_pages, None, None


def _step_tokens(cfg: TransformerConfig, cache_cfg: CacheConfig, params,
                 pools, tokens, positions, write_ok, block_tables):
    """One batched single-token step over the paged cache.  ``write_ok``
    [B] gates the k/v write (an inactive slot's next token is garbage
    the caller ignores).  Attention covers ``positions + 1`` tokens: the
    fed token's k/v land first."""
    b = tokens.shape[0]
    scale = cfg.head_dim ** -0.5
    s = cache_cfg.page_size
    pmax = block_tables.shape[1]
    k_pages, v_pages, k_scale, v_scale = _split_pools(cache_cfg, pools)
    quant = cache_cfg.quantized
    x = params["embed"][tokens.long()]                      # [B, D]
    page_col = (positions.long() // s).clamp(max=pmax - 1)
    page_id = block_tables.long().gather(1, page_col[:, None])[:, 0]
    rows = positions.long() % s
    att_lengths = (positions + 1).to(torch.int32)
    # the per-slot RoPE tables and the cache-write gate (or quantized
    # span plan) are the same for every layer's q/k and k/v
    tables = L.rope_tables(positions, cfg.head_dim)
    if quant:
        plan = span_plan(positions, write_ok[:, None], block_tables,
                         page_size=s, num_pages=cache_cfg.num_pages)
    else:
        gate = write_gate((page_id, rows), write_ok)
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        y = L.rmsnorm(x, lp["norm1"])
        q = (y @ lp["wq"]).reshape(b, cfg.num_heads, cfg.head_dim)
        k = (y @ lp["wk"]).reshape(b, cfg.num_kv_heads, cfg.head_dim)
        v = (y @ lp["wv"]).reshape(b, cfg.num_kv_heads, cfg.head_dim)
        q, k = L.apply_rope(q, tables), L.apply_rope(k, tables)
        # write-then-read: the new token's k/v land in the pool first
        if quant:
            write_span(k_pages, k_scale, li, k[:, None], plan,
                       fmt=cache_cfg.quant_fmt)
            write_span(v_pages, v_scale, li, v[:, None], plan,
                       fmt=cache_cfg.quant_fmt)
        else:
            write_rows(k_pages, li, k, gate)
            write_rows(v_pages, li, v, gate)
        att = paged_attention_decode(
            (q * scale).contiguous(), k_pages[li], v_pages[li],
            att_lengths, block_tables,
            k_scale=k_scale[li] if quant else None,
            v_scale=v_scale[li] if quant else None,
            fmt=cache_cfg.quant_fmt)
        x = x + att.reshape(b, cfg.embed_dim) @ lp["wo"]
        y = L.rmsnorm(x, lp["norm2"])
        x = x + L.swiglu(y, lp["w_gate"], lp["w_up"], lp["w_down"])
    logits = _logits(cfg, params, x)
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    return pools, next_tokens


def make_decode_step(cfg: TransformerConfig, cache_cfg: CacheConfig):
    """``decode_step(params, k_pages, v_pages, tokens, positions,
    block_tables, active) -> (k_pages, v_pages, next_tokens)``; on a
    quantized cache the scales follow the pools: ``decode_step(params,
    k_pages, v_pages, k_scale, v_scale, tokens, positions, block_tables,
    active) -> (k_pages, v_pages, k_scale, v_scale, next_tokens)``.

    tokens/positions/active ``[slots]`` (int32/int32/bool) and
    block_tables ``[slots, pmax]`` int32, all on the pools' device; a
    slot's ``position`` is the cache index its token is written at."""
    check_config(cfg)
    n_pools = 4 if cache_cfg.quantized else 2

    def decode_step(params, *args):
        pools, (tokens, positions, block_tables, active) = (
            args[:n_pools], args[n_pools:])
        pools, nxt = _step_tokens(cfg, cache_cfg, params, pools, tokens,
                                  positions, active, block_tables)
        return (*pools, nxt)

    return decode_step


def make_prefill_chunk(cfg: TransformerConfig, cache_cfg: CacheConfig,
                       chunk: int):
    """``prefill_chunk(params, k_pages, v_pages, tokens, start, n_valid,
    block_row) -> (k_pages, v_pages, next_token)`` (scales after the
    pools on a quantized cache, as in ``make_decode_step``).

    ``tokens`` ``[chunk]`` int32 (padded), ``block_row`` ``[pmax]`` int32
    on the pools' device; ``start`` (the offset of the chunk's first
    token) and ``n_valid`` (its real tokens) are host ints.  The chunk's
    K/V land in the slot's pages, attention is causal over cache +
    chunk, and ``next_token`` (a 0-d int32 tensor) is the greedy
    continuation of the last valid token — meaningful on the chunk that
    completes the prompt (the request's first generated token)."""
    check_config(cfg)
    scale = cfg.head_dim ** -0.5
    s = cache_cfg.page_size
    pmax = cache_cfg.max_pages_per_seq
    quant = cache_cfg.quantized
    n_pools = 4 if quant else 2
    g = cfg.num_heads // cfg.num_kv_heads

    def prefill_chunk(params, *args):
        pools, (tokens, start, n_valid, block_row) = (args[:n_pools],
                                                      args[n_pools:])
        k_pages, v_pages, k_scale, v_scale = _split_pools(cache_cfg, pools)
        dev = tokens.device
        positions = start + torch.arange(chunk, device=dev)
        valid = torch.arange(chunk, device=dev) < n_valid
        x = params["embed"][tokens.long()]                  # [C, D]
        row = block_row.long()
        page_id = row[(positions // s).clamp(max=pmax - 1)]
        rows = positions % s
        last = max(n_valid - 1, 0)
        k_pos = torch.arange(pmax * s, device=dev)
        keep = k_pos[None, :] <= positions[:, None]         # [C, T]
        start_t = torch.full((1,), start, dtype=torch.int32, device=dev)
        tables = L.rope_tables(positions, cfg.head_dim)
        if quant:
            plan = span_plan(start_t, valid[None], block_row[None],
                             page_size=s, num_pages=cache_cfg.num_pages)
        else:
            gate = write_gate((page_id, rows), valid)
        for li in range(cfg.num_layers):
            lp = _layer(params, li)
            y = L.rmsnorm(x, lp["norm1"])
            q = (y @ lp["wq"]).reshape(chunk, cfg.num_heads, cfg.head_dim)
            k = (y @ lp["wk"]).reshape(chunk, cfg.num_kv_heads,
                                       cfg.head_dim)
            v = (y @ lp["wv"]).reshape(chunk, cfg.num_kv_heads,
                                       cfg.head_dim)
            q, k = L.apply_rope(q, tables), L.apply_rope(k, tables)
            if quant:
                write_span(k_pages, k_scale, li, k[None], plan,
                           fmt=cache_cfg.quant_fmt)
                write_span(v_pages, v_scale, li, v[None], plan,
                           fmt=cache_cfg.quant_fmt)
                kseq = dequant_gathered(take_pages(k_pages[li], row),
                                        k_scale[li][:, row])
                vseq = dequant_gathered(take_pages(v_pages[li], row),
                                        v_scale[li][:, row])
            else:
                write_rows(k_pages, li, k, gate)
                write_rows(v_pages, li, v, gate)
                kseq = k_pages[li][:, row].to(_F32)
                vseq = v_pages[li][:, row].to(_F32)
            hkv, npg, _, dh = kseq.shape      # [Hkv, pmax, S, Dh]
            kseq = kseq.reshape(hkv, npg * s, dh)
            vseq = vseq.reshape(hkv, npg * s, dh)
            qg = (q * scale).reshape(chunk, hkv, g, dh).to(_F32)
            scores = torch.einsum("chgd,htd->hgct", qg, kseq)
            scores = torch.where(keep[None, None], scores,
                                 torch.full_like(scores, MASK_VALUE))
            p = torch.softmax(scores, dim=-1)
            att = torch.einsum("hgct,htd->chgd", p, vseq)
            att = att.reshape(chunk, cfg.embed_dim).to(x.dtype)
            x = x + att @ lp["wo"]
            y = L.rmsnorm(x, lp["norm2"])
            x = x + L.swiglu(y, lp["w_gate"], lp["w_up"], lp["w_down"])
        logits = _logits(cfg, params, x[last:last + 1])[0]
        next_token = torch.argmax(logits).to(torch.int32)
        return (*pools, next_token)

    return prefill_chunk


def prompt_tokens(rid: int, prompt_len: int, vocab_size: int) -> np.ndarray:
    """Deterministic synthetic prompt for request ``rid`` (splitmix64 on
    the host, the JAX package's stream): the workload replays from the
    arrival plan alone."""
    rng = _Rng((rid + 1) * 0x9E3779B9)
    return np.fromiter((rng.uniform_int(0, vocab_size - 1)
                        for _ in range(prompt_len)),
                       dtype=np.int32, count=prompt_len)


def prompt_tokens_for(req, vocab_size: int) -> np.ndarray:
    """The request's full prompt: a plan-stamped shared prefix
    (``prefix_id``/``prefix_len``) comes from the prefix pool's seeded
    stream, the tail from the request's own; without a prefix this is
    ``prompt_tokens``."""
    if getattr(req, "prefix_id", -1) < 0 or req.prefix_len <= 0:
        return prompt_tokens(req.rid, req.prompt_len, vocab_size)
    n_pre = min(req.prefix_len, req.prompt_len)
    rng = _Rng((req.prefix_id + 1) * 0xC2B2AE3D)
    pre = np.fromiter((rng.uniform_int(0, vocab_size - 1)
                       for _ in range(n_pre)),
                      dtype=np.int32, count=n_pre)
    tail = prompt_tokens(req.rid, req.prompt_len, vocab_size)
    return np.concatenate([pre, tail[n_pre:]])
