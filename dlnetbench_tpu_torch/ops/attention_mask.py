"""Block-sparse attention masks: declarative specs -> per-block verdicts
(the port of the JAX package's ``ops/attention_mask.py``; every integer
array it builds is equal to the JAX package's).

This is the host-side mask layer the splash kernels K6/K7/K8
(``ops/flash_attention.py``) consume:

* ``MaskSpec`` — a small hashable spec: ``causal``, a sliding
  ``window(W)`` (each query attends its W most recent keys, itself
  included) and document ``segments`` from a seeded plan (splitmix64,
  the arrival-plan generator: the plan is replayable from ``(seg_seed,
  seg_avg)`` alone), intersected freely.
* ``row_intervals`` — for every admitted spec the allowed keys of a
  query row form ONE contiguous interval ``[lo[q], hi[q]]``, both bounds
  non-decreasing in ``q``.  Block verdicts, ring-hop verdicts and the
  in-kernel partial-tile mask are all interval arithmetic on those two
  arrays; the S x S mask is never built on the sparse paths.
* ``BlockMask`` — per (q tile, kv tile) verdicts {skip, full, partial}
  from the intervals, the transposed (per kv tile) visit ranges of the
  dk/dv kernel, and ``stats``.  A kernel's BlockMask is built at that
  kernel's own tiles.
* ``ring_hop_work`` — the same verdict at ring-shard granularity.

``dense_mask`` (numpy) and ``allowed`` (torch tensors) give the
equivalent boolean mask for the dense reference
(``models/layers.attention(dense_mask=...)``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from dlnetbench_tpu_torch.serving.arrivals import splitmix64

# BlockMask verdicts
SKIP, PARTIAL, FULL = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Declarative attention-mask spec; hashable, so it keys the caches
    below and rides through ``torch.autograd.Function`` as a constant.

    window=W (W > 0): query q attends keys in ``(q - W, q]``; requires
    ``causal``.  seg_avg > 0 turns on the seeded document-segment plan:
    token positions are partitioned into documents whose lengths are
    splitmix64 draws around ``seg_avg``, and attention never crosses a
    document boundary."""
    causal: bool = True
    window: int = 0          # 0 = unbounded
    seg_avg: int = 0         # 0 = no segment structure (tokens)
    seg_seed: int = 0

    def __post_init__(self):
        if self.window < 0 or self.seg_avg < 0:
            raise ValueError(f"MaskSpec: window={self.window} / "
                             f"seg_avg={self.seg_avg} must be >= 0")
        if self.window and not self.causal:
            raise ValueError("MaskSpec: window requires causal=True "
                             "(non-causal sliding windows are not "
                             "supported)")
        if not (self.causal or self.seg_avg):
            raise ValueError("MaskSpec: the trivial all-allowed mask "
                             "has no sparse path — use causal=False "
                             "attention directly")

    @property
    def is_plain_causal(self) -> bool:
        """True when the spec is exactly the dense-causal default."""
        return self.causal and not self.window and not self.seg_avg

    def label(self) -> str:
        """Stable record key: 'causal', 'causal&window(512)',
        'causal&seg(avg=64,seed=0)', ..."""
        parts = []
        if self.causal:
            parts.append("causal")
        if self.window:
            parts.append(f"window({self.window})")
        if self.seg_avg:
            parts.append(f"seg(avg={self.seg_avg},seed={self.seg_seed})")
        return "&".join(parts)

    def to_dict(self) -> dict:
        return {"causal": self.causal, "window": self.window,
                "seg_avg": self.seg_avg, "seg_seed": self.seg_seed}

    @classmethod
    def from_dict(cls, d: dict) -> "MaskSpec":
        return cls(causal=bool(d.get("causal", True)),
                   window=int(d.get("window", 0)),
                   seg_avg=int(d.get("seg_avg", 0)),
                   seg_seed=int(d.get("seg_seed", 0)))

    @classmethod
    def from_knobs(cls, window: int, seg_avg: int,
                   seg_seed: int) -> "MaskSpec | None":
        """The config knobs ``attention_window`` / ``attention_seg_avg``
        / ``attention_seg_seed`` -> spec, or None when both are off (the
        dense-causal default, whose path is unchanged)."""
        if not (window or seg_avg):
            return None
        return cls(causal=True, window=window, seg_avg=seg_avg,
                   seg_seed=seg_seed)


@functools.lru_cache(maxsize=64)
def segment_ids(seg_seed: int, seg_avg: int, s: int) -> np.ndarray:
    """[S] int32 document ids from the seeded plan: lengths are
    splitmix64 draws uniform in [max(1, avg/2), avg + avg/2], ids
    monotone from 0.  Deterministic in (seed, avg, S)."""
    if seg_avg <= 0:
        raise ValueError(f"segment_ids: seg_avg={seg_avg} must be > 0")
    lo, hi = max(1, seg_avg // 2), seg_avg + seg_avg // 2
    state = (seg_seed * 0x9E3779B9 + 0xD1B54A32D192ED03) & ((1 << 64) - 1)
    ids = np.empty(s, np.int32)
    pos = doc = 0
    while pos < s:
        v, state = splitmix64(state)
        length = lo + v % (hi - lo + 1)
        ids[pos:pos + length] = doc
        pos += length
        doc += 1
    return ids


@functools.lru_cache(maxsize=64)
def row_intervals(spec: MaskSpec, s: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-query allowed-key interval: ([S] lo, [S] hi) int64, inclusive,
    both non-decreasing."""
    q = np.arange(s, dtype=np.int64)
    lo = np.zeros(s, np.int64)
    hi = (q if spec.causal else np.full(s, s - 1, np.int64)).copy()
    if spec.window:
        lo = np.maximum(lo, q - spec.window + 1)
    if spec.seg_avg:
        ids = segment_ids(spec.seg_seed, spec.seg_avg, s).astype(np.int64)
        # first/last position of each row's document
        starts = np.searchsorted(ids, ids, side="left")
        ends = np.searchsorted(ids, ids, side="right") - 1
        lo = np.maximum(lo, starts)
        hi = np.minimum(hi, ends)
    if not np.all(lo <= hi):
        raise AssertionError("row_intervals: empty row interval — every "
                             "admitted spec keeps q in its own interval")
    return lo, hi


def dense_mask(spec: MaskSpec, s: int) -> np.ndarray:
    """[S, S] bool, mask[q, k] = k allowed for q: the dense reference's
    mask.  O(S^2): reference and tests only."""
    lo, hi = row_intervals(spec, s)
    k = np.arange(s, dtype=np.int64)
    return (k[None, :] >= lo[:, None]) & (k[None, :] <= hi[:, None])


def allowed(spec: MaskSpec, q_pos: torch.Tensor, k_pos: torch.Tensor,
            seg_ids=None) -> torch.Tensor:
    """The mask predicate over position tensors that broadcast against
    each other (the JAX package's jnp version, on torch tensors);
    ``seg_ids`` (an [S]-indexable tensor or array) is required when the
    spec has segments."""
    m = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                   dtype=torch.bool, device=q_pos.device)
    if spec.causal:
        m = m & (q_pos >= k_pos)
    if spec.window:
        m = m & (q_pos - k_pos < spec.window)
    if spec.seg_avg:
        if seg_ids is None:
            raise ValueError("allowed: spec has segments but no seg_ids "
                             "array was provided")
        ids = torch.as_tensor(seg_ids, device=q_pos.device)
        m = m & (ids[q_pos.long()] == ids[k_pos.long()])
    return m


def sparsity_fraction(spec: MaskSpec, s: int) -> float:
    """Fraction of the S x S score grid that is MASKED.  Exact, from the
    row intervals."""
    lo, hi = row_intervals(spec, s)
    return float(1.0 - (hi - lo + 1).sum() / (s * s))


@dataclasses.dataclass(frozen=True)
class BlockMask:
    """Per-tile verdicts for one (spec, S, block_q, block_k), as host
    numpy int32:

    q_first_k/q_last_k   [nq]  kv-tile visit range per q tile (the
                               forward and dq kernels; tiles outside
                               are neither loaded nor multiplied)
    kv_first_q/kv_last_q [nk]  q-tile visit range per kv tile (dk/dv)
    blk_lo_max/blk_hi_min [nq] max(lo)/min(hi) over the tile's rows: kv
                               tile j is FULL for q tile i iff
                               blk_lo_max[i] <= j*bk and
                               blk_hi_min[i] >= (j+1)*bk - 1 (FULL
                               tiles skip the in-register mask)
    lo/hi                [S]   the row intervals (the partial-tile mask:
                               k in [lo[q], hi[q]])
    """
    spec: MaskSpec
    seq_len: int
    block_q: int
    block_k: int
    q_first_k: np.ndarray
    q_last_k: np.ndarray
    kv_first_q: np.ndarray
    kv_last_q: np.ndarray
    blk_lo_max: np.ndarray
    blk_hi_min: np.ndarray
    lo: np.ndarray
    hi: np.ndarray

    @property
    def nq(self) -> int:
        return self.seq_len // self.block_q

    @property
    def nk(self) -> int:
        return self.seq_len // self.block_k

    def verdicts(self) -> np.ndarray:
        """[nq, nk] uint8 verdict table (SKIP/PARTIAL/FULL), derived from
        the interval arrays (tests and stats; the kernels read the
        arrays)."""
        j = np.arange(self.nk, dtype=np.int64)
        visit = ((j[None, :] >= self.q_first_k[:, None])
                 & (j[None, :] <= self.q_last_k[:, None]))
        full = ((self.blk_lo_max[:, None] <= j[None, :] * self.block_k)
                & (self.blk_hi_min[:, None]
                   >= (j[None, :] + 1) * self.block_k - 1))
        out = np.where(visit, np.where(full, FULL, PARTIAL), SKIP)
        return out.astype(np.uint8)

    def stats(self) -> dict:
        """Tile-level work accounting (the expected-speedup side of the
        longcontext line)."""
        v = self.verdicts()
        total = v.size
        skipped = int((v == SKIP).sum())
        return {
            "blocks_total": total,
            "blocks_skipped": skipped,
            "blocks_full": int((v == FULL).sum()),
            "blocks_partial": int((v == PARTIAL).sum()),
            "block_skip_fraction": round(skipped / total, 6),
            "sparsity_fraction": round(
                sparsity_fraction(self.spec, self.seq_len), 6),
        }


@functools.lru_cache(maxsize=64)
def block_mask(spec: MaskSpec, s: int, block_q: int,
               block_k: int) -> BlockMask:
    """The BlockMask for (spec, S, tiles): interval arithmetic, O(S +
    nq*nk) host work, cached."""
    if s % block_q or s % block_k:
        raise ValueError(f"block_mask: blocks ({block_q}, {block_k}) "
                         f"do not divide seq_len {s}")
    lo, hi = row_intervals(spec, s)
    nq, nk = s // block_q, s // block_k
    lo_b = lo.reshape(nq, block_q)
    hi_b = hi.reshape(nq, block_q)
    # a q tile's rows' intervals union to a contiguous range (monotone
    # bounds): the kv tiles to visit span [min(lo)//bk, max(hi)//bk]
    q_first_k = (lo_b.min(axis=1) // block_k).astype(np.int32)
    q_last_k = (hi_b.max(axis=1) // block_k).astype(np.int32)
    # transposed: the q rows that see key k are [searchsorted(hi, k),
    # searchsorted(lo, k, right) - 1]; per kv tile the union over its
    # first and last key
    k_lo = np.arange(nk, dtype=np.int64) * block_k
    k_hi = k_lo + block_k - 1
    kv_first_q = (np.searchsorted(hi, k_lo, side="left")
                  // block_q).astype(np.int32)
    kv_last_q = ((np.searchsorted(lo, k_hi, side="right") - 1)
                 // block_q).astype(np.int32)
    if not (np.all(kv_first_q <= kv_last_q)
            and np.all(kv_first_q >= 0)):
        raise AssertionError("block_mask: empty kv-block q range — "
                             "admitted specs leave no orphan key")
    return BlockMask(
        spec=spec, seq_len=s, block_q=block_q, block_k=block_k,
        q_first_k=q_first_k, q_last_k=q_last_k,
        kv_first_q=kv_first_q, kv_last_q=kv_last_q,
        blk_lo_max=lo_b.max(axis=1).astype(np.int32),
        blk_hi_min=hi_b.min(axis=1).astype(np.int32),
        lo=lo.astype(np.int32), hi=hi.astype(np.int32))


def ring_hop_work(spec: MaskSpec | None, s: int, n: int) -> np.ndarray:
    """[n, n] bool: does ring shard ``me``'s query range see shard
    ``src``'s key range at all?  ``spec=None`` means plain causal: work
    iff src <= me."""
    me = np.arange(n)
    if spec is None:
        return me[None, :] <= me[:, None]   # src <= me
    if s % n:
        raise ValueError(f"ring_hop_work: seq_len {s} % shards {n} != 0")
    bm = block_mask(spec, s, s // n, s // n)
    return bm.verdicts() != SKIP


def ring_skipped_hop_fraction(spec: MaskSpec | None, s: int,
                              n: int) -> float:
    """Fraction of the n^2 ring (shard, hop) compute legs the mask skips
    (nonzero for plain causal too: the strictly-future hops)."""
    work = ring_hop_work(spec, s, n)
    return float(1.0 - work.mean())


def record_globals(spec: MaskSpec, s: int, *, n_shards: int | None = None
                   ) -> dict:
    """The mask's record globals (comparable: a different mask is a
    different run)."""
    out = {"attention_mask": spec.label(),
           "mask_sparsity": round(sparsity_fraction(spec, s), 6)}
    if n_shards is not None:
        out["ring_skipped_hop_fraction"] = round(
            ring_skipped_hop_fraction(spec, s, n_shards), 6)
    return out
