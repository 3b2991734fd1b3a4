"""Self-drafting speculative decode in the device-resident loop (the JAX
package's ``serving/speculative.py``).

Per round, per active slot: draft ``spec_k`` tokens cheaply, verify
them in one target pass over ``spec_k + 1`` fed positions, accept on the
device, and emit 1 to ``spec_k + 1`` tokens.  Greedy acceptance keeps
the longest prefix of drafts equal to the target's own argmax plus the
target's bonus token, so the stream is exactly the 1-step greedy stream
whatever the drafter proposes.  With a sampler the acceptance is
rejection sampling against the filtered target distribution (accept
draft ``t`` iff ``u * q(t) < p(t)``, resample the residual at the first
reject, draw the bonus from ``p`` after full acceptance), which emits
the target distribution.

The verify pass is not a kernel of the JAX package: its Pallas decode
kernel is single-query, so JAX runs the pass as dense gather math over
all fed positions at once, and so does the port (``_verify_tokens``).
The stream is then exactly the 1-step stream where both share that
math at the same rounding: on the CPU, token for token.  On a card the
pass's products run at ``slots * (spec_k + 1)`` rows where the 1-step
engine's run at ``slots``, and a near-tie argmax can flip.

Drafters:

* ``ngram``     — a per-slot bigram table ``[slots, vocab]`` on the
  device (``table[s, t]`` = the token that last followed ``t`` in slot
  ``s``'s stream), seeded from the prompt at admission and updated from
  emitted tokens; drafting is ``spec_k`` chained lookups.
* ``truncated`` — the first ``drafter_layers`` layers of the target
  plus the shared final norm and head; its k/v for those layers are the
  target's own, and the verify pass rewrites them.

A fed token writes k/v only while ``position < seq_limit`` (the slot's
reservation): draft overshoot past the budget writes nowhere.

The host issues ``n_rounds`` rounds back to back (a round's emission
depends on the data, so the host cannot know when every slot is done);
a round with no active slot changes nothing, and ``rounds_run`` counts
the rounds that had one — the JAX loop's trip count.
"""
from __future__ import annotations

import numpy as np
import torch

from dlnetbench_tpu_torch.models import layers as L
from dlnetbench_tpu_torch.models.transformer import TransformerConfig
from dlnetbench_tpu_torch.ops.paged_attention import take_pages
from dlnetbench_tpu_torch.serving.decode import (STATE_GRAMMAR,
                                                 STATE_LAST, STATE_LIMIT,
                                                 STATE_POS, STATE_REM,
                                                 STATE_UID, SplitOnce,
                                                 _check_impl, _layer,
                                                 _logits, _step_tokens,
                                                 check_config)
from dlnetbench_tpu_torch.serving.kv_cache import (MASK_VALUE, CacheConfig,
                                                   write_gate, write_rows)
from dlnetbench_tpu_torch.serving.sampling import (LANE_ACCEPT,
                                                   LANE_DRAFT, LANE_RESID,
                                                   LANE_TOKEN)

_F32 = torch.float32

DRAFTERS = ("ngram", "truncated")


def check_spec_config(cfg: TransformerConfig, *, spec_k: int,
                      drafter: str, drafter_layers: int) -> None:
    """The speculative knobs the model shape must agree with."""
    if cfg.num_experts > 1:
        raise ValueError(
            "speculative: MoE models are not supported — the "
            "draft/verify overwrite cycle has no stated parity story "
            "through the MoE overflow rounds (ISSUE 15)")
    if spec_k < 1:
        raise ValueError(f"speculative: spec_k must be >= 1, got "
                         f"{spec_k}")
    if drafter not in DRAFTERS:
        raise ValueError(f"speculative: unknown drafter {drafter!r} "
                         f"(one of {DRAFTERS})")
    if drafter == "truncated" and not (
            1 <= drafter_layers < cfg.num_layers):
        raise ValueError(
            f"speculative: truncated drafter needs 1 <= drafter_layers "
            f"< num_layers ({cfg.num_layers}), got {drafter_layers} — "
            f"a full-depth drafter is the target itself (no draft "
            f"speedup, double the cost)")


def _verify_tokens(cfg: TransformerConfig, cache_cfg: CacheConfig,
                   params, k_pages, v_pages, tokens, positions,
                   write_ok, block_tables, *,
                   return_logits: bool = False):
    """The batched target pass: feed ``tokens`` [B, K1] from cache index
    ``positions`` [B], write their k/v where ``write_ok`` [B, K1] allows
    (one gated write of B * K1 rows per layer), attend causally over
    cache + fed tokens, and return the greedy continuation after every
    fed position: ``out[b, j]`` is the target's next token given
    ``tokens[b, :j+1]``.  ``return_logits`` appends the f32 ``[B, K1,
    vocab]`` logits.  Pools are updated in place.

    One pass over B * K1 rows verifies K1 positions for about the cost
    of one wide step.  Attention is the dense gather form (the
    length-masked f32 softmax of ``gather_attention`` extended to K1
    queries): kernel K1 is single-query, so the pass launches no kernel.
    On the CPU the pass equals K1 iterated single steps token for token;
    on a card its products and reductions run at B * K1 rows where the
    1-step engine runs B, which can round differently and flip a
    near-tie argmax."""
    b, k1 = tokens.shape
    s = cache_cfg.page_size
    pmax = block_tables.shape[1]
    scale = cfg.head_dim ** -0.5
    hkv = cfg.num_kv_heads
    g = cfg.num_heads // hkv
    dev = tokens.device
    pos2 = positions.long()[:, None] + torch.arange(k1, device=dev)
    x = params["embed"][tokens.long()]                      # [B, K1, D]
    bt = block_tables.long()
    page_id = bt.gather(1, (pos2 // s).clamp(max=pmax - 1))
    gate = write_gate((page_id.reshape(-1), (pos2 % s).reshape(-1)),
                      write_ok.reshape(-1))
    t_len = pmax * s
    keep = torch.arange(t_len, device=dev)[None, None, :] \
        <= pos2[:, :, None]                                  # [B, K1, T]
    tables = L.rope_tables(pos2.reshape(-1), cfg.head_dim)
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        y = L.rmsnorm(x, lp["norm1"])
        q = (y @ lp["wq"]).reshape(b * k1, cfg.num_heads, cfg.head_dim)
        k = (y @ lp["wk"]).reshape(b * k1, hkv, cfg.head_dim)
        v = (y @ lp["wv"]).reshape(b * k1, hkv, cfg.head_dim)
        q, k = L.apply_rope(q, tables), L.apply_rope(k, tables)
        write_rows(k_pages, li, k, gate)
        write_rows(v_pages, li, v, gate)
        # each slot's whole page row; the stale tail is masked by the
        # per-query causal length, as in gather_attention
        kseq = take_pages(k_pages[li], bt).movedim(0, 1)
        vseq = take_pages(v_pages[li], bt).movedim(0, 1)
        kseq = kseq.reshape(b, hkv, t_len, cfg.head_dim).to(_F32)
        vseq = vseq.reshape(b, hkv, t_len, cfg.head_dim).to(_F32)
        qg = (q * scale).reshape(b, k1, hkv, g, cfg.head_dim).to(_F32)
        scores = torch.einsum("bjhgd,bhtd->bhgjt", qg, kseq)
        scores = torch.where(keep[:, None, None], scores,
                             torch.full_like(scores, MASK_VALUE))
        p = torch.softmax(scores, dim=-1)
        att = torch.einsum("bhgjt,bhtd->bjhgd", p, vseq)
        att = att.reshape(b, k1, cfg.embed_dim).to(x.dtype)
        x = x + att @ lp["wo"]
        y = L.rmsnorm(x, lp["norm2"])
        x = x + L.swiglu(y, lp["w_gate"], lp["w_up"], lp["w_down"])
    logits = _logits(cfg, params, x.reshape(b * k1, cfg.embed_dim))
    logits = logits.reshape(b, k1, -1)
    out = torch.argmax(logits, dim=-1).to(torch.int32)      # [B, K1]
    if return_logits:
        return k_pages, v_pages, out, logits
    return k_pages, v_pages, out


def _draft_ngram(table, last_tokens, k: int):
    """k chained bigram lookups per slot: [B, vocab] table, [B] seed."""
    rows = torch.arange(table.shape[0], device=table.device)
    drafts = []
    prev = last_tokens
    for _ in range(k):
        prev = table[rows, prev.long()]
        drafts.append(prev)
    return torch.stack(drafts, dim=1)                        # [B, k]


def make_spec_decode_loop(cfg: TransformerConfig,
                          cache_cfg: CacheConfig, n_max: int, *,
                          spec_k: int, drafter: str,
                          drafter_layers: int = 1,
                          attn_impl: str = "auto", sampler=None):
    """The draft/verify/accept loop.  ``attn_impl`` is the truncated
    drafter's decode attention; the verify pass is always gather math.

    ``spec_loop(params, k_pages, v_pages, state, ngram_table,
    block_tables, n_rounds) -> (k_pages, v_pages, state, ngram_table,
    tokens_out, counts, rounds_run, drafted, accepted)``.  ``state`` is
    the packed ``[6, slots]`` carry and ``ngram_table`` ``[slots,
    vocab]`` int32; both come back as updated copies, the pools are
    updated in place.  ``n_rounds`` is a host int: the call issues
    ``min(n_rounds, n_max)`` rounds.  Per round each active slot emits
    ``min(accepted + 1, remaining)`` tokens and advances position and
    remaining by as many.  ``tokens_out`` is ``[slots, n_max * (spec_k
    + 1)]`` with ``counts`` valid per slot; ``rounds_run``, ``drafted``
    and ``accepted`` are 0-d int32 (the last two the raw acceptance
    stats, before the budget clamp).

    With a ``sampler`` drafts are sampled from the truncated drafter's
    filtered distribution (``LANE_DRAFT``), accepted iff ``u * q(d) <
    p(d)`` (``LANE_ACCEPT``), the first reject resamples from the
    normalized residual ``max(p - q, 0)`` (``LANE_RESID``; ``p`` itself
    when the residual is empty) and full acceptance draws the bonus
    from ``p`` (``LANE_TOKEN``).  Grammar states advance along the
    emitted tokens; target probabilities are masked through the draft
    chain's states."""
    check_config(cfg)
    _check_impl(attn_impl)
    check_spec_config(cfg, spec_k=spec_k, drafter=drafter,
                      drafter_layers=drafter_layers)
    if sampler is not None and drafter != "truncated":
        raise ValueError(
            "spec_decode_loop: speculative sampling requires drafter "
            f"probs — drafter {drafter!r} has no distribution; use "
            "drafter='truncated'")
    if cache_cfg.quantized:
        raise ValueError(
            "speculative decode supports the bf16 cache only — "
            f"cache_dtype={cache_cfg.cache_dtype!r} re-quantizes "
            "pages on every draft/verify overwrite and has no stated "
            "parity bar; run speculative on the dense cache")
    if n_max < 1:
        raise ValueError(f"spec_decode_loop: n_max must be >= 1, "
                         f"got {n_max}")
    k1 = spec_k + 1
    cap = n_max * k1
    advance = sampler is not None and sampler.trans_dev is not None
    i32 = torch.int32

    split_for = SplitOnce(cfg, cache_cfg)

    def draft_truncated(params, pools, last, pos, act, limits, uids, g0,
                        block_tables):
        """``spec_k`` drafter steps: the drafts ``[B, spec_k]`` and, when
        sampling, each step's distribution and its value at the draw."""
        rows = torch.arange(last.shape[0], device=last.device)
        split = split_for(block_tables)
        prev, dpos, gd = last, pos, g0
        ds, q_list, q_at_draft = [], [], []
        for _ in range(spec_k):
            ok = act & (dpos < limits)
            if sampler is None:
                pools, prev = _step_tokens(
                    cfg, cache_cfg, params, pools, prev, dpos, ok,
                    block_tables, layers=drafter_layers,
                    attn_impl=attn_impl, split=split)
            else:
                pools, _, dlog = _step_tokens(
                    cfg, cache_cfg, params, pools, prev, dpos, ok,
                    block_tables, layers=drafter_layers,
                    attn_impl=attn_impl, return_logits=True, split=split)
                qj = sampler.probs(dlog, gd)
                prev = sampler.draw_from_probs(
                    qj, sampler.u01(uids, dpos, LANE_DRAFT))
                q_list.append(qj)
                q_at_draft.append(qj[rows, prev.long()])
                gd = sampler.advance(gd, prev)
            ds.append(prev)
            dpos = dpos + 1
        return torch.stack(ds, dim=1), q_list, q_at_draft

    def accept_sampled(drafts, vlogits, q_list, q_at_draft, pos, uids,
                       g0):
        """Rejection-sampling acceptance: ``(accepted [B], emitted
        tokens [B, K1])``."""
        rows = torch.arange(drafts.shape[0], device=drafts.device)
        gs = [g0]
        for j in range(spec_k):
            gs.append(sampler.advance(gs[j], drafts[:, j]))
        p_js = [sampler.probs(vlogits[:, j], gs[j]) for j in range(k1)]
        p_at_draft = torch.stack(
            [p_js[j][rows, drafts[:, j].long()] for j in range(spec_k)],
            dim=1)
        q_d = torch.stack(q_at_draft, dim=1)
        u_acc = torch.stack([sampler.u01(uids, pos + j, LANE_ACCEPT)
                             for j in range(spec_k)], dim=1)
        # strict: a draft of zero target probability never passes
        accept = (u_acc * q_d < p_at_draft).to(i32)
        acc = torch.cumprod(accept, dim=1).sum(dim=1).to(i32)
        cols = []
        for j in range(spec_k):
            resid = torch.clamp(p_js[j] - q_list[j], min=0.0)
            z = resid.sum(dim=-1, keepdim=True)
            rdist = torch.where(z > 0, resid / torch.clamp(z, min=1e-30),
                                p_js[j])
            r_j = sampler.draw_from_probs(
                rdist, sampler.u01(uids, pos + j, LANE_RESID))
            cols.append(torch.where(j < acc, drafts[:, j], r_j))
        cols.append(sampler.draw_from_probs(
            p_js[spec_k], sampler.u01(uids, pos + spec_k, LANE_TOKEN)))
        return acc, torch.stack(cols, dim=1)

    def spec_loop(params, k_pages, v_pages, state, ngram_table,
                  block_tables, n_rounds):
        st = state.clone()
        table = ngram_table.clone()
        b = st.shape[1]
        dev = st.device
        rows = torch.arange(b, device=dev)
        steps = torch.arange(k1, dtype=i32, device=dev)
        # one column past the end takes the tokens no slot emits
        out = torch.zeros((b, cap + 1), dtype=i32, device=dev)
        cnt = torch.zeros((b,), dtype=i32, device=dev)
        rounds = torch.zeros((), dtype=i32, device=dev)
        drafted = torch.zeros((), dtype=i32, device=dev)
        accepted = torch.zeros((), dtype=i32, device=dev)
        pools = (k_pages, v_pages)
        for _ in range(min(int(n_rounds), n_max)):
            last, pos = st[STATE_LAST].clone(), st[STATE_POS].clone()
            rem, limits = st[STATE_REM].clone(), st[STATE_LIMIT]
            act = rem > 0
            uids, g0 = st[STATE_UID], st[STATE_GRAMMAR].clone()
            rounds += act.any().to(i32)
            # ---- draft spec_k tokens per slot
            if drafter == "ngram":
                drafts = _draft_ngram(table, last, spec_k)
            else:
                drafts, q_list, q_at_draft = draft_truncated(
                    params, pools, last, pos, act, limits, uids, g0,
                    block_tables)
            # ---- the target pass over [last, drafts]
            fed = torch.cat([last[:, None], drafts], dim=1)
            pos2 = pos[:, None] + steps
            write_ok = act[:, None] & (pos2 < limits[:, None])
            if sampler is None:
                *pools, tgt = _verify_tokens(cfg, cache_cfg, params,
                                             *pools, fed, pos, write_ok,
                                             block_tables)
                # greedy: the longest prefix where draft == target
                match = (drafts == tgt[:, :spec_k]).to(i32)
                acc = torch.cumprod(match, dim=1).sum(dim=1).to(i32)
                etoks = tgt
            else:
                *pools, _, vlogits = _verify_tokens(
                    cfg, cache_cfg, params, *pools, fed, pos, write_ok,
                    block_tables, return_logits=True)
                acc, etoks = accept_sampled(drafts, vlogits, q_list,
                                            q_at_draft, pos, uids, g0)
            emit = torch.where(act, torch.minimum(acc + 1, rem), 0)
            # ---- append the emitted tokens at each slot's count
            for j in range(k1):
                w = act & (j < emit)
                out[rows, torch.where(w, cnt + j, cap).long()] = \
                    etoks[:, j]
            # ---- the ngram table learns every emitted (prev -> next)
            if drafter == "ngram":
                prevs = torch.cat([last[:, None], etoks[:, :spec_k]],
                                  dim=1)
                for j in range(k1):
                    w = act & (j < emit)
                    col = torch.where(w, prevs[:, j], 0).long()
                    table[rows, col] = torch.where(w, etoks[:, j],
                                                   table[rows, col])
            st[STATE_LAST] = torch.where(
                act, etoks[rows, torch.clamp(emit - 1, min=0).long()],
                last)
            st[STATE_POS] = pos + emit
            st[STATE_REM] = rem - emit
            if advance:
                g_new = g0
                for j in range(k1):
                    g_new = torch.where(j < emit,
                                        sampler.advance(g_new,
                                                        etoks[:, j]),
                                        g_new)
                st[STATE_GRAMMAR] = g_new
            cnt += emit
            drafted += torch.where(act, spec_k, 0).sum().to(i32)
            accepted += torch.where(act, acc, 0).sum().to(i32)
        return (*pools, st, table, out[:, :cap], cnt, rounds, drafted,
                accepted)

    return spec_loop


def seed_ngram_row(prompt_tokens, first_token: int, vocab: int):
    """A fresh ``[vocab]`` bigram row for a newly admitted slot, seeded
    from the prompt and the first generated token; a repeated index
    keeps its last write, as the device's sequential update does."""
    row = np.zeros((vocab,), np.int32)
    toks = np.append(np.asarray(prompt_tokens, np.int32),
                     np.int32(first_token))
    row[toks[:-1]] = toks[1:]
    return row
