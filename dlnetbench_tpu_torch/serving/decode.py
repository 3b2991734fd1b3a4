"""The decode-path transformer: prefill/decode over the paged KV cache
(the JAX package's ``serving/decode.py``).

Three programs cover serving, with the JAX package's signatures:

* ``make_decode_step`` — ONE token per decode slot, full batch (shape
  ``[slots]``; inactive slots write nothing): project q/k/v for the fed
  token, write k/v into the slot's current page, attend over everything
  cached through kernel K1 or K2 (``kv_cache.paged_attention_decode``),
  MLP, and pick the next token from f32 logits — the argmax, or with a
  ``sampling.DeviceSampler`` the seeded draw keyed by (seed, uid, fed
  position).
* ``make_multi_step_decode`` — up to N such steps per call over a
  device-resident slot state (the packed ``[6, slots]`` int32 carry,
  rows ``STATE_*``).  The loop is a host ``for`` loop over the same
  ``_step_tokens`` body: between trips the host reads nothing and
  uploads nothing, a slot whose budget runs out stops itself on the
  device, and a trip with no active slot changes nothing.
* ``make_prefill_chunk`` — one sequence, one chunk of its prompt: write
  the chunk's K/V into the slot's pages and attend causally over cache
  + chunk.  This attention is plain PyTorch (a gather of the slot's
  pages and a masked softmax), as it is plain XLA in the JAX package.

The programs run eagerly and update the pools in place; each returns
the pools it was given followed by its outputs.  Pools split along the
KV heads over devices (``kv_cache.HeadShards``, ``kv_shard > 1``) go
through the same programs: the embedding, projections, MLP and head
stay on the engine's device, each shard's k/v rows are written and its
heads attended on its own device (K1/K2 once a shard a layer), and the
attention output is concatenated back before the output projection —
the JAX package's ``shard_map`` over the paged attention.

A MoE model (``num_experts > 1``) runs every layer's MLP as per-expert
token batches with overflow rounds (``serving/moe_decode.py``; its
``moe_bias`` operand is the seeded skew), and every program appends the
step's ``(expert_load [E], rounds)``, summed over the layers (and over
the trips of a fused call), to its outputs.  Each MoE layer reads its
round count back to the host once, so a fused MoE trip makes exactly
``num_layers`` host reads where a dense one makes none.
"""
from __future__ import annotations

import numpy as np
import torch

from dlnetbench_tpu_torch.models import layers as L
from dlnetbench_tpu_torch.models.transformer import TransformerConfig
from dlnetbench_tpu_torch.serving.arrivals import _Rng
from dlnetbench_tpu_torch.serving.kv_cache import (ATTN_IMPLS, MASK_VALUE,
                                                   CacheConfig, HeadShards,
                                                   decode_split,
                                                   dequant_gathered,
                                                   gather_pages,
                                                   paged_attention_decode,
                                                   per_shard, span_plan,
                                                   write_gate, write_rows,
                                                   write_span)

_F32 = torch.float32


def check_config(cfg: TransformerConfig) -> TransformerConfig:
    """The serving path covers the gated family, dense or MoE, without
    attention masks (``TransformerConfig`` already refuses everything
    else).  The JAX package refuses a segment mask in serving and a
    window in decode (its windowed prefill runs no Pallas kernel and is
    not ported yet), with these messages; the port's engine always
    decodes, so it refuses both."""
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


def _moe_mlp(cfg: TransformerConfig, lp: dict, y, rows: int, active,
             moe_bias):
    """One layer's serving MoE MLP over ``rows`` tokens (the decode batch
    or a prefill chunk): ``(y2, load [E], rounds)``."""
    from dlnetbench_tpu_torch.serving.moe_decode import (decode_capacity,
                                                         moe_mlp_rounds)
    cap = decode_capacity(rows, cfg.top_k, cfg.num_experts,
                          cfg.moe_capacity_factor)
    return moe_mlp_rounds(y, lp["w_router"], lp["w_gate"], lp["w_up"],
                          lp["w_down"], top_k=cfg.top_k, capacity=cap,
                          bias=moe_bias, active=active)


class SplitOnce:
    """K1/K2's pages a split for one decode program, resolved at its
    first call, where the batch, the block-table width and the device
    are known (``kv_cache.decode_split``: the tuning DB's answer, or 0,
    the kernel's own split, with the tuner off), and kept for every
    later call: the served step consults nothing per launch.  On
    sharded pools the split is resolved on one shard's shapes (its
    heads, its device), as the JAX package consults inside
    ``shard_map``."""
    __slots__ = ("cfg", "cache_cfg", "done", "value")

    def __init__(self, cfg: TransformerConfig, cache_cfg: CacheConfig):
        self.cfg, self.cache_cfg = cfg, cache_cfg
        self.done, self.value = False, 0

    def __call__(self, block_tables, pools=()) -> int:
        if not self.done:
            cc = self.cache_cfg
            n, dev = 1, block_tables.device
            if pools and isinstance(pools[0], HeadShards):
                n, dev = len(pools[0]), pools[0].devices[0]
            self.value = decode_split(
                block_tables.shape[0], self.cfg.num_heads // n,
                cc.num_kv_heads // n, cc.head_dim, block_tables.shape[1],
                cc.page_size, cc.quant_fmt, dev)
            self.done = True
        return self.value


def _step_tokens(cfg: TransformerConfig, cache_cfg: CacheConfig, params,
                 pools, tokens, positions, write_ok, block_tables, *,
                 layers: int | None = None, attn_impl: str = "auto",
                 moe_bias=None, sampler=None, uids=None, gstate=None,
                 return_logits: bool = False, split: int | None = None):
    """One batched single-token step over the paged cache.  ``write_ok``
    [B] gates the k/v write (an inactive slot's next token is garbage
    the caller ignores).  Attention covers ``positions + 1`` tokens: the
    fed token's k/v land first.  ``layers`` truncates the stack (the
    speculative truncated drafter: the first ``layers`` layers plus the
    shared final norm and head).  With a ``sampler`` the next token is
    the seeded draw keyed by ``(uids[b], positions[b])`` under the
    grammar states ``gstate``; ``return_logits`` appends the f32 logits
    to the return.  A MoE model returns ``(pools, next_tokens,
    (expert_load, rounds))`` instead, summed over the layers
    (``moe_bias``: the seeded skew; ``write_ok`` masks inactive slots out
    of routing).  ``split`` is the kernels' pages a split (``SplitOnce``;
    0: the kernel's own).  On sharded pools the write gate (or span
    plan), the lengths and the block tables are moved to the shards
    once for every layer."""
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
    att_tables = block_tables
    if quant:
        plan = span_plan(positions, write_ok[:, None], block_tables,
                         page_size=s, num_pages=cache_cfg.num_pages)
    else:
        gate = write_gate((page_id, rows), write_ok)
    if isinstance(k_pages, HeadShards):
        if quant:
            plan = per_shard(plan, k_pages)
        else:
            gate = per_shard(gate, k_pages)
        att_lengths = per_shard(att_lengths, k_pages)
        att_tables = per_shard(block_tables, k_pages)
    depth = cfg.num_layers if layers is None else layers
    moe = cfg.num_experts > 1
    moe_load, moe_rounds = 0, 0
    for li in range(depth):
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
            att_lengths, att_tables,
            k_scale=k_scale[li] if quant else None,
            v_scale=v_scale[li] if quant else None,
            fmt=cache_cfg.quant_fmt, impl=attn_impl, split=split)
        x = x + att.reshape(b, cfg.embed_dim) @ lp["wo"]
        y = L.rmsnorm(x, lp["norm2"])
        if moe:
            y2, load_l, rounds_l = _moe_mlp(cfg, lp, y, b, write_ok,
                                            moe_bias)
            moe_load = moe_load + load_l
            moe_rounds += rounds_l
            x = x + y2
        else:
            x = x + L.swiglu(y, lp["w_gate"], lp["w_up"], lp["w_down"])
    logits = _logits(cfg, params, x)
    if sampler is None:
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        next_tokens = sampler.draw_tokens(logits, uids, positions, gstate)
    if moe:
        return pools, next_tokens, (moe_load, moe_rounds)
    if return_logits:
        return pools, next_tokens, logits
    return pools, next_tokens


def _check_impl(attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"serving decode: unknown attn_impl "
                         f"{attn_impl!r} (one of {ATTN_IMPLS})")


def make_decode_step(cfg: TransformerConfig, cache_cfg: CacheConfig, *,
                     attn_impl: str = "auto", moe_bias=None, sampler=None):
    """``decode_step(params, k_pages, v_pages, tokens, positions,
    block_tables, active) -> (k_pages, v_pages, next_tokens)``; on a
    quantized cache the scales follow the pools: ``decode_step(params,
    k_pages, v_pages, k_scale, v_scale, tokens, positions, block_tables,
    active) -> (k_pages, v_pages, k_scale, v_scale, next_tokens)``.

    tokens/positions/active ``[slots]`` (int32/int32/bool) and
    block_tables ``[slots, pmax]`` int32, all on the pools' device; a
    slot's ``position`` is the cache index its token is written at.
    With a ``sampler`` the signature grows two trailing operands,
    ``uids`` and ``gstate`` ``[slots]`` int32 (the draw keys' request
    ids and the grammar states; grammar transitions stay with the
    caller, which reads every token back anyway).  A MoE model appends
    ``expert_load`` ``[E]`` int32 and ``rounds`` (a host int) to the
    outputs."""
    check_config(cfg)
    _check_impl(attn_impl)
    n_pools = 4 if cache_cfg.quantized else 2
    n_ops = 6 if sampler is not None else 4
    moe = cfg.num_experts > 1
    split_for = SplitOnce(cfg, cache_cfg)

    def decode_step(params, *args):
        if len(args) != n_pools + n_ops:
            raise TypeError(f"decode_step: {n_pools} pools and {n_ops} "
                            f"operands, got {len(args)} arguments")
        pools, ops = args[:n_pools], args[n_pools:]
        tokens, positions, block_tables, active = ops[:4]
        uids, gstate = ops[4:] if sampler is not None else (None, None)
        out = _step_tokens(cfg, cache_cfg, params, pools, tokens,
                           positions, active, block_tables,
                           attn_impl=attn_impl, moe_bias=moe_bias,
                           sampler=sampler, uids=uids, gstate=gstate,
                           split=split_for(block_tables, pools))
        if moe:
            pools, nxt, (load, rounds) = out
            return (*pools, nxt, load, rounds)
        pools, nxt = out
        return (*pools, nxt)

    return decode_step


# rows of the packed device slot-state carry ([6, slots] int32, one
# tensor per host<->device crossing): the token each slot feeds next,
# its cache write index (= tokens cached), the output tokens still owed
# (``remaining > 0`` is the active bit), the prompt+output reservation
# cap, the request id sampled draws key by, the grammar state.  The last
# two ride as zeros in greedy engines.
(STATE_LAST, STATE_POS, STATE_REM, STATE_LIMIT, STATE_UID,
 STATE_GRAMMAR) = 0, 1, 2, 3, 4, 5
STATE_ROWS = 6


def make_multi_step_decode(cfg: TransformerConfig,
                           cache_cfg: CacheConfig, n_max: int, *,
                           attn_impl: str = "auto", moe_bias=None,
                           sampler=None):
    """The device-resident fused decode loop.

    ``multi_step(params, k_pages, v_pages, state, block_tables, n_steps)
    -> (k_pages, v_pages, state, tokens_out, counts, steps_run)``; on a
    quantized cache the scales follow the pools, in and out.

    ``state`` is the packed ``[6, slots]`` int32 carry (``STATE_*``
    rows), left untouched: the call returns an updated copy.
    ``n_steps`` is a host int; the call runs ``min(n_steps, n_max)``
    trips of ``_step_tokens`` (the same body as ``make_decode_step``,
    sampler included), issued back to back with no host read or upload
    between them.  A slot whose budget reaches 0 stops feeding and
    writing on the device; a trip with no active slot changes nothing.
    ``tokens_out[b, j]`` ``[slots, n_max]`` is slot ``b``'s j-th token
    of this call, ``counts[b]`` how many are valid, and ``steps_run``
    (0-d int32) the trips that had an active slot — the JAX loop's trip
    count, which exits as soon as every slot is done.  A caller that
    knows every slot's remaining budget (greedy decode has no early
    stop) passes ``n_steps`` at most their largest and wastes no trip.
    With a ``sampler`` each trip draws by (uid row, fed position) and
    advances the grammar row after each accepted token.  A MoE model
    appends ``expert_load`` ``[E]`` int32 and ``rounds`` (a host int),
    summed over the trips; each of its trips reads ``num_layers`` round
    counts back to the host (``serving/moe_decode.host_reads``), a dense
    trip none."""
    check_config(cfg)
    _check_impl(attn_impl)
    if n_max < 1:
        raise ValueError(f"multi_step_decode: n_max must be >= 1, "
                         f"got {n_max}")
    n_pools = 4 if cache_cfg.quantized else 2
    advance = sampler is not None and sampler.trans_dev is not None
    moe = cfg.num_experts > 1
    split_for = SplitOnce(cfg, cache_cfg)

    def multi_step(params, *args):
        if len(args) != n_pools + 3:
            raise TypeError(f"multi_step: {n_pools} pools, state, "
                            f"block_tables and n_steps, got {len(args)} "
                            f"arguments")
        pools = args[:n_pools]
        state, block_tables, n_steps = args[n_pools:]
        st = state.clone()
        b = st.shape[1]
        dev = st.device
        rows = torch.arange(b, device=dev)
        # one column past the end takes the tokens of inactive slots
        out = torch.zeros((b, n_max + 1), dtype=torch.int32, device=dev)
        cnt = torch.zeros((b,), dtype=torch.int32, device=dev)
        steps = torch.zeros((), dtype=torch.int32, device=dev)
        load = torch.zeros((cfg.num_experts,), dtype=torch.int32,
                           device=dev)
        rounds = 0
        split = split_for(block_tables, pools)
        for _ in range(min(int(n_steps), n_max)):
            last, pos = st[STATE_LAST], st[STATE_POS]
            act = st[STATE_REM] > 0
            step_out = _step_tokens(
                cfg, cache_cfg, params, pools, last, pos, act,
                block_tables, attn_impl=attn_impl, moe_bias=moe_bias,
                sampler=sampler, uids=st[STATE_UID],
                gstate=st[STATE_GRAMMAR], split=split)
            if moe:
                pools, nxt, (load_s, rounds_s) = step_out
                load += load_s
                rounds += rounds_s
            else:
                pools, nxt = step_out
            out[rows, torch.where(act, cnt, n_max).long()] = nxt
            step = act.to(torch.int32)
            steps += act.any().to(torch.int32)
            if advance:
                g = st[STATE_GRAMMAR]
                st[STATE_GRAMMAR] = torch.where(
                    act, sampler.advance(g, nxt), g)
            st[STATE_LAST] = torch.where(act, nxt, last)
            st[STATE_POS] += step
            st[STATE_REM] -= step
            cnt += step
        if moe:
            return (*pools, st, out[:, :n_max], cnt, steps, load, rounds)
        return (*pools, st, out[:, :n_max], cnt, steps)

    return multi_step


def make_prefill_chunk(cfg: TransformerConfig, cache_cfg: CacheConfig,
                       chunk: int, *, moe_bias=None, sampler=None):
    """``prefill_chunk(params, k_pages, v_pages, tokens, start, n_valid,
    block_row) -> (k_pages, v_pages, next_token)`` (scales after the
    pools on a quantized cache, as in ``make_decode_step``).

    ``tokens`` ``[chunk]`` int32 (padded), ``block_row`` ``[pmax]`` int32
    on the pools' device; ``start`` (the offset of the chunk's first
    token) and ``n_valid`` (its real tokens) are host ints.  The chunk's
    K/V land in the slot's pages, attention is causal over cache +
    chunk, and ``next_token`` (a 0-d int32 tensor) is the greedy
    continuation of the last valid token — meaningful on the chunk that
    completes the prompt (the request's first generated token).

    With a ``sampler`` the signature grows one trailing host int, the
    request id ``uid``, and the first token is the seeded draw keyed by
    ``(uid, start + last valid index)`` — the fed position of the last
    prompt token, the decode programs' counter convention — under the
    grammar's start state.  A MoE model appends ``expert_load`` and
    ``rounds`` over the chunk's valid rows (capacity sized over the
    chunk)."""
    check_config(cfg)
    scale = cfg.head_dim ** -0.5
    s = cache_cfg.page_size
    pmax = cache_cfg.max_pages_per_seq
    quant = cache_cfg.quantized
    n_pools = 4 if quant else 2
    g = cfg.num_heads // cfg.num_kv_heads
    n_ops = 5 if sampler is not None else 4
    moe = cfg.num_experts > 1

    def prefill_chunk(params, *args):
        if len(args) != n_pools + n_ops:
            raise TypeError(f"prefill_chunk: {n_pools} pools and {n_ops} "
                            f"operands, got {len(args)} arguments")
        pools, ops = args[:n_pools], args[n_pools:]
        tokens, start, n_valid, block_row = ops[:4]
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
        if isinstance(k_pages, HeadShards):
            if quant:
                plan = per_shard(plan, k_pages)
            else:
                gate = per_shard(gate, k_pages)
        moe_load, moe_rounds = 0, 0
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
                kseq = dequant_gathered(gather_pages(k_pages[li], row),
                                        gather_pages(k_scale[li], row))
                vseq = dequant_gathered(gather_pages(v_pages[li], row),
                                        gather_pages(v_scale[li], row))
            else:
                write_rows(k_pages, li, k, gate)
                write_rows(v_pages, li, v, gate)
                kseq = gather_pages(k_pages[li], row).to(_F32)
                vseq = gather_pages(v_pages[li], row).to(_F32)
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
            if moe:
                y2, load_l, rounds_l = _moe_mlp(cfg, lp, y, chunk, valid,
                                                moe_bias)
                moe_load = moe_load + load_l
                moe_rounds += rounds_l
                x = x + y2
            else:
                x = x + L.swiglu(y, lp["w_gate"], lp["w_up"],
                                 lp["w_down"])
        logits = _logits(cfg, params, x[last:last + 1])
        if sampler is None:
            next_token = torch.argmax(logits[0]).to(torch.int32)
        else:
            def one(v):
                return torch.full((1,), v, dtype=torch.int32, device=dev)
            next_token = sampler.draw_tokens(
                logits, one(ops[4]), one(start + last),
                one(sampler.start_state))[0]
        if moe:
            return (*pools, next_token, moe_load, moe_rounds)
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
