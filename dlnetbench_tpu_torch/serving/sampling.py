"""Seeded counter-keyed sampling and grammar-constrained decode (the JAX
package's ``serving/sampling.py``).

Every uniform draw is a stateless function of ``(sample_seed, uid,
counter, lane)``: ``uid`` is the request id (warm requests ride
negative rids), ``counter`` the cache position of the token FED when
the draw happens, ``lane`` which of a position's independent draws it
is (``LANE_TOKEN`` the emitted token, ``LANE_ACCEPT`` the speculative
accept test, ``LANE_RESID`` the residual resample, ``LANE_DRAFT`` the
drafter's own draw).  No generator state is carried: the key is the
position, so the 1-step engine, the fused N-step loop and the
speculative loop draw the same token at the same stream position.

The derivation is a murmur3-fmix32 chain, 32 bits end to end: a host
twin in masked Python ints (``key_bits``) and a device twin on int64
tensors holding 32-bit values, whose products are taken in 16-bit
halves so that no step leaves int64's range (``_fmix32_dev``).  The
uniform is the top 24 bits, exact in f32.

One filtering pipeline serves the direct draw, the speculative target
and the truncated drafter: grammar mask -> temperature -> top-k
(kth-value threshold, ties kept) -> top-p (stable sort, exclusive
cumsum; the top-1 token always survives) -> softmax.  ``temperature ==
0`` is the one-hot on the (masked) argmax.

The grammar is a depth-bounded JSON-mode automaton over the synthetic
vocab (token class ``token % 4``), compiled to dense ``[states, vocab]``
mask and transition tables.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_F32 = torch.float32
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_GOLDEN = 0x9E3779B9          # the prompt streams' golden ratio
_FMIX_C1 = 0x85EBCA6B         # murmur3 fmix32 constants
_FMIX_C2 = 0xC2B2AE35
_NEG = -1e30                  # masked-logit sentinel

# draw lanes: the independent uniforms one stream position can consume
LANE_TOKEN = 0    # the emitted-token draw (and the spec bonus draw)
LANE_ACCEPT = 1   # speculative accept test at this position
LANE_RESID = 2    # residual-distribution resample at this position
LANE_DRAFT = 3    # the drafter's own draw at this position


# ---------------------------------------------------------------------
# the keyed derivation: host twin (python ints) + device twin (tensors)

def _fmix32_host(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * _FMIX_C1) & _M32
    x ^= x >> 13
    x = (x * _FMIX_C2) & _M32
    x ^= x >> 16
    return x


def key_bits(seed: int, uid: int, counter: int, lane: int) -> int:
    """The 32-bit draw key for ``(seed, uid, counter, lane)``.  Negative
    uids fold as their two's-complement uint32."""
    h = _fmix32_host((seed & _M32) ^ _GOLDEN)
    for v in (uid, counter, lane):
        h = _fmix32_host(h ^ (v & _M32))
    return h


def key_u01(seed: int, uid: int, counter: int, lane: int) -> float:
    """The uniform in [0, 1) drawn for this key: the top 24 bits."""
    return (key_bits(seed, uid, counter, lane) >> 8) / float(1 << 24)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): the high half
    of ``x`` only reaches the product's low 32 bits through its own low
    16 bits times ``c``, so every partial product stays below 2**48."""
    lo, hi = x & _M16, x >> 16
    return (lo * c + (((hi * c) & _M16) << 16)) & _M32


def _fmix32_dev(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _FMIX_C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _FMIX_C2)
    return x ^ (x >> 16)


# ---------------------------------------------------------------------
# grammar: JSON-mode token-mask automaton over the synthetic vocab

GRAMMARS = ("json",)
N_TOKEN_CLASSES = 4
CLASS_OPEN, CLASS_CLOSE, CLASS_SCALAR, CLASS_COMMA = 0, 1, 2, 3
JSON_MAX_DEPTH = 3


@dataclasses.dataclass
class Grammar:
    """A compiled token-mask automaton: ``mask[s, t]`` says token ``t``
    is legal in state ``s``; ``trans[s, t]`` the state after it."""
    name: str
    mask: np.ndarray    # [states, vocab] bool
    trans: np.ndarray   # [states, vocab] int32
    start: int

    @property
    def num_states(self) -> int:
        return self.mask.shape[0]


def _json_automaton(depth: int):
    """States ``S0`` (top level), ``A_d`` (just opened depth ``d``),
    ``B_d`` (after a value inside ``d``), ``V_d`` (after a comma in
    ``d``); every state admits at least one class."""
    s0 = 0

    def a(d):
        return d

    def b(d):
        return depth + d

    def v(d):
        return 2 * depth + d

    n = 3 * depth + 1
    allowed = np.zeros((n, N_TOKEN_CLASSES), bool)
    nxt = np.zeros((n, N_TOKEN_CLASSES), np.int32)

    def arc(s, c, t):
        allowed[s, c] = True
        nxt[s, c] = t

    arc(s0, CLASS_SCALAR, s0)
    arc(s0, CLASS_OPEN, a(1))
    for d in range(1, depth + 1):
        arc(a(d), CLASS_SCALAR, b(d))
        arc(a(d), CLASS_CLOSE, s0 if d == 1 else b(d - 1))
        arc(b(d), CLASS_COMMA, v(d))
        arc(b(d), CLASS_CLOSE, s0 if d == 1 else b(d - 1))
        arc(v(d), CLASS_SCALAR, b(d))
        if d < depth:
            arc(a(d), CLASS_OPEN, a(d + 1))
            arc(v(d), CLASS_OPEN, a(d + 1))
    return allowed, nxt, s0


def compile_grammar(name: str, vocab: int) -> Grammar:
    """Grammar name -> dense ``[states, vocab]`` tables (token class =
    ``token % 4``)."""
    if name not in GRAMMARS:
        raise ValueError(f"sampling: unknown grammar {name!r} "
                         f"(one of {GRAMMARS})")
    if vocab < N_TOKEN_CLASSES:
        raise ValueError(
            f"sampling: grammar {name!r} needs vocab >= "
            f"{N_TOKEN_CLASSES} (token class = token % "
            f"{N_TOKEN_CLASSES}), got {vocab}")
    allowed, nxt, start = _json_automaton(JSON_MAX_DEPTH)
    cls = np.arange(vocab) % N_TOKEN_CLASSES
    return Grammar(name=name, mask=allowed[:, cls],
                   trans=nxt[:, cls].astype(np.int32), start=start)


def validate_stream(grammar: Grammar, tokens, state: int | None = None
                    ) -> bool:
    """Host replay of the tables over an emitted token stream."""
    s = grammar.start if state is None else state
    for t in tokens:
        if not grammar.mask[s, int(t)]:
            return False
        s = int(grammar.trans[s, int(t)])
    return True


# ---------------------------------------------------------------------
# config + the one validator (engine build and arg-parse time)

@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """``temperature == 0`` is greedy; ``grammar`` alone turns the
    sampler on in masked-greedy mode."""
    temperature: float = 0.0
    top_k: int = 0          # 0 = off; >= 1 keeps the k highest logits
    top_p: float = 1.0      # 1.0 = off; (0, 1) keeps the nucleus
    sample_seed: int = 0
    grammar: str = ""       # "" = unconstrained; else one of GRAMMARS

    @property
    def enabled(self) -> bool:
        return self.temperature > 0.0 or bool(self.grammar)


def check_sampling_config(*, temperature: float, top_k: int,
                          top_p: float, sample_seed: int, grammar: str,
                          speculative: bool = False,
                          drafter: str = "ngram") -> SamplingConfig:
    """The one sampling validator, with the JAX package's messages:
    ``ServingConfig.validate`` runs it at engine build and ``cli serve``
    at parse time.  Speculative sampling needs a drafter with a
    distribution (the truncated one)."""
    if temperature < 0.0:
        raise ValueError(f"sampling: temperature must be >= 0 "
                         f"(0 = greedy), got {temperature}")
    if top_k < 0:
        raise ValueError(f"sampling: top_k must be >= 1 when set "
                         f"(0 = off), got {top_k}")
    if not (0.0 < top_p <= 1.0):
        raise ValueError(f"sampling: top_p must be in (0, 1], "
                         f"got {top_p}")
    if grammar and grammar not in GRAMMARS:
        raise ValueError(f"sampling: unknown grammar {grammar!r} "
                         f"(one of {GRAMMARS})")
    if temperature == 0.0 and top_k > 0:
        raise ValueError(
            f"sampling: top_k={top_k} without temperature > 0 — "
            f"greedy ignores the cutoff; set --temperature or drop "
            f"top_k")
    if temperature == 0.0 and top_p < 1.0:
        raise ValueError(
            f"sampling: top_p={top_p} without temperature > 0 — "
            f"greedy ignores the nucleus; set --temperature or drop "
            f"top_p")
    cfg = SamplingConfig(temperature=temperature, top_k=top_k,
                         top_p=top_p, sample_seed=sample_seed,
                         grammar=grammar)
    if cfg.enabled and speculative and drafter != "truncated":
        raise ValueError(
            f"sampling: speculative sampling requires drafter probs — "
            f"the {drafter!r} drafter proposes tokens without a "
            f"distribution, and the rejection-sampling accept rule "
            f"needs q(draft); use drafter='truncated' (greedy "
            f"speculation keeps both drafters)")
    return cfg


# ---------------------------------------------------------------------
# the device sampler

class DeviceSampler:
    """The on-device half of the sampling stack, built once per engine
    on the engine's device: the keyed uniforms, the filtered
    distribution and the inverse-CDF draw every decode program shares,
    plus the grammar tables and their host twin."""

    def __init__(self, cfg: SamplingConfig, vocab: int,
                 device: torch.device | str = "cpu"):
        self.cfg = cfg
        self.vocab = vocab
        self.device = torch.device(device)
        # the seed is folded on the host once: the device chain starts
        # at the mixed seed word
        self._seed_h = _fmix32_host((cfg.sample_seed & _M32) ^ _GOLDEN)
        self.grammar = (compile_grammar(cfg.grammar, vocab)
                        if cfg.grammar else None)
        self.mask_dev = self.trans_dev = None
        if self.grammar is not None:
            self.mask_dev = torch.from_numpy(self.grammar.mask).to(
                self.device)
            self.trans_dev = torch.from_numpy(self.grammar.trans).to(
                self.device)
        self.start_state = self.grammar.start if self.grammar else 0
        # the divisor as a device tensor: a Python scalar divisor may be
        # applied as a product with its reciprocal
        self._temp = torch.full((1,), cfg.temperature, dtype=_F32,
                                device=self.device)

    # ---- keyed uniforms ---------------------------------------------
    def u01(self, uids, counters, lane: int):
        """[B] uniforms in [0, 1) for ``(seed, uid, counter, lane)`` —
        the device twin of ``key_u01``."""
        h = _fmix32_dev(self._seed_h ^ (uids.long() & _M32))
        h = _fmix32_dev(h ^ (counters.long() & _M32))
        h = _fmix32_dev(h ^ (lane & _M32))
        return (h >> 8).to(_F32) * (1.0 / (1 << 24))

    # ---- the filtering pipeline -------------------------------------
    def gmask(self, gstate):
        """Per-slot legal-token mask [B, vocab], or None."""
        if self.mask_dev is None:
            return None
        return self.mask_dev[gstate.long()]

    def _filter(self, logits):
        """temperature -> top-k -> top-p on [B, vocab] logits."""
        x = logits / self._temp
        k = self.cfg.top_k
        if k and k < self.vocab:
            kth = torch.sort(x, dim=-1).values[..., self.vocab - k]
            x = torch.where(x >= kth[..., None], x, _NEG)
        p = self.cfg.top_p
        if p < 1.0:
            order = torch.argsort(-x, dim=-1, stable=True)
            xs = torch.gather(x, -1, order)
            ps = torch.softmax(xs, dim=-1)
            cum = torch.cumsum(ps, dim=-1) - ps      # exclusive
            keep_s = cum < p                          # top-1 always kept
            keep = torch.zeros_like(keep_s).scatter(-1, order, keep_s)
            x = torch.where(keep, x, _NEG)
        return x

    def _masked(self, logits, gstate):
        x = logits.to(_F32)
        m = self.gmask(gstate) if gstate is not None else None
        return x if m is None else torch.where(m, x, _NEG)

    def probs(self, logits, gstate=None):
        """The filtered distribution [B, vocab]; the one-hot on the
        masked argmax at ``temperature == 0``."""
        x = self._masked(logits, gstate)
        if self.cfg.temperature <= 0.0:
            hot = torch.argmax(x, dim=-1, keepdim=True)
            return torch.zeros_like(x).scatter_(-1, hot, 1.0)
        return torch.softmax(self._filter(x), dim=-1)

    # ---- draws ------------------------------------------------------
    def draw_from_probs(self, p, u):
        """Inverse-CDF draw, one uniform per row; a zero-probability
        token is never drawn."""
        cdf = torch.cumsum(p, dim=-1)
        lim = u * cdf[..., -1]
        hit = (cdf >= lim[..., None]) & (p > 0)
        return torch.argmax(hit.to(torch.uint8), dim=-1).to(torch.int32)

    def draw_tokens(self, logits, uids, counters, gstate=None):
        """The emitted-token draw (``LANE_TOKEN``) for one batched
        step; ``counters`` is the fed position per slot."""
        if self.cfg.temperature <= 0.0:
            x = self._masked(logits, gstate)
            return torch.argmax(x, dim=-1).to(torch.int32)
        u = self.u01(uids, counters, LANE_TOKEN)
        return self.draw_from_probs(self.probs(logits, gstate), u)

    # ---- grammar state ----------------------------------------------
    def advance(self, gstate, tokens):
        """Automaton step [B]; identity when unconstrained."""
        if self.trans_dev is None:
            return gstate
        return self.trans_dev[gstate.long(), tokens.long()]

    def host_advance(self, gstate: int, token: int) -> int:
        """The host twin of ``advance`` (the 1-step engine's grammar
        transitions between fenced steps)."""
        if self.grammar is None:
            return gstate
        return int(self.grammar.trans[gstate, token])


# ---------------------------------------------------------------------
# distribution-equality machinery

def chi_square(counts, probs, min_expected: float = 5.0
               ) -> tuple[float, int]:
    """Pearson chi-square of ``counts`` against ``probs`` with
    small-expected bins pooled: ``(statistic, degrees_of_freedom)``."""
    counts = np.asarray(counts, float)
    probs = np.asarray(probs, float)
    n = counts.sum()
    if n <= 0:
        raise ValueError("chi_square: no samples")
    exp = probs / probs.sum() * n
    order = np.argsort(exp)
    c_bins: list[float] = []
    e_bins: list[float] = []
    c_acc = e_acc = 0.0
    for i in order:
        c_acc += counts[i]
        e_acc += exp[i]
        if e_acc >= min_expected:
            c_bins.append(c_acc)
            e_bins.append(e_acc)
            c_acc = e_acc = 0.0
    if e_acc > 0:
        if e_bins:
            c_bins[-1] += c_acc
            e_bins[-1] += e_acc
        else:
            c_bins.append(c_acc)
            e_bins.append(e_acc)
    stat = float(sum((c - e) ** 2 / e
                     for c, e in zip(c_bins, e_bins) if e > 0))
    return stat, max(len(e_bins) - 1, 1)


def chi_square_critical(df: int, z: float = 3.090) -> float:
    """Upper critical value by the Wilson–Hilferty approximation
    (``z = 3.090``: p ~= 0.001)."""
    if df < 1:
        raise ValueError(f"chi_square_critical: df must be >= 1, "
                         f"got {df}")
    t = 1.0 - 2.0 / (9.0 * df) + z * math.sqrt(2.0 / (9.0 * df))
    return df * t ** 3
