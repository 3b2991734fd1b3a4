"""Block-table paged KV cache and the decode attention over it (the JAX
package's ``serving/kv_cache.py``).

* ``PagedKVCache`` (host) — the page allocator: a free list over
  ``num_pages`` physical pages, one block-table row per decode slot,
  allocate/append/free and occupancy/fragmentation stats.  Pure numpy,
  and the same allocation order as the JAX package, so the same
  admit/append/free sequence gives the same block tables.  Every page
  carries a refcount, and a trie over published prompt pages
  (``_PrefixTrie``) lets a request whose prompt shares a prefix with a
  resident, fully prefilled sequence map its block-table entries onto
  the same physical pages: fully covered pages by reference (admission
  charges only the unshared pages), a partly covered boundary page
  copy-on-write (a private page is charged and the engine copies the
  prefix rows into it at admission).  ``append`` refuses to grow into
  a page with refcount > 1, and a page returns to the free list when
  its last reader frees it.
* device pools — ``k``/``v`` of shape ``[L, Hkv, num_pages, page_size,
  Dh]`` (``device_buffers``); quantized caches (``cache_dtype`` int8 or
  fp8) add f32 scales ``[L, Hkv, num_pages]``, one per page and head.
  The port updates the pools IN PLACE (the JAX programs return new
  arrays; here a program returns the same tensors it was given).
* cache writes — ``write_rows`` (unquantized) and ``write_span``
  (quantized: every touched page re-quantized against a fresh amax over
  its valid rows; ``quant_write_span`` is the JAX package's signature
  for it).  The gating and the column plan depend only on the step's
  positions and block tables, so a step builds them once
  (``write_gate``, ``span_plan``) for every layer's k and v writes.
  A write that is switched off changes nothing: where the JAX package
  scatters it to an out-of-bounds page in ``drop`` mode,
  the port points it at the first enabled write's target and value (or,
  when none is enabled, at that target's own current content), so every
  duplicate index writes the same bytes and no host sync is needed.
* ``paged_attention_decode`` — one decode step's attention: kernel K1
  (``ops/paged_attention``) for unquantized pools, K2
  (``ops/paged_attention_quant``) for quantized ones.  ``impl`` keeps
  two of the JAX package's names: ``auto`` launches the Hopper kernel
  on a CUDA tensor and runs its plain version (the JAX package's gather
  math) on a CPU tensor; ``gather`` is the plain version, run only when
  a caller names it.  The kernels' pages a split is the tuner's
  ``pages_per_compute_block`` (``decode_split``, resolved once per decode
  program; ``resolve_pages_per_compute_block``, the JAX package's
  function).
* ``pages_for_pool_bytes`` — the pages a byte budget buys under a cache
  geometry and dtype (the equal-pool-bytes axis of the density A/B).
* KV-head sharding (``kv_shard > 1``, the JAX package's
  ``sharded_paged_attention``): ``sharded_buffers`` splits every pool
  (and the scales with it) along its KV-head axis over a device list,
  each part a ``HeadShards`` entry on its own device.  The writes, the
  page gather (``gather_pages``), the copy-on-write copy and
  ``paged_attention_decode`` take either form: on shards, each part's
  heads are written and attended on its own device (q split by GQA
  group, K1/K2 launched once a shard), and the attention outputs and
  gathered pages come back concatenated on the caller's device.  A
  step moves its shared operands to the shards once (``per_shard``);
  no host read is involved.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dlnetbench_tpu_torch.ops.paged_attention import (  # noqa: F401
    MASK_VALUE, gather_attention, paged_attention, take_pages)
from dlnetbench_tpu_torch.ops.paged_attention_quant import \
    quant_paged_attention
from dlnetbench_tpu_torch.ops.quantized_matmul import cast_q, scale_from_amax

_F32 = torch.float32

# "bf16" labels the UNQUANTIZED pool, stored in the model's own dtype
# (float32 in the CPU tests, bfloat16 on the card)
CACHE_DTYPES = ("bf16", "int8", "fp8")
_QUANT_FMT = {"int8": "int8", "fp8": "float8"}
_QUANT_TORCH = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_MODEL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# paged_attention_decode's paths (the JAX package's names)
ATTN_IMPLS = ("auto", "gather")

# the JAX package's stated decode-parity bars: max absolute error of the
# paged-attention output against the unquantized cache on unit-scale
# activations
QUANT_DECODE_TOL = {"int8": 0.05, "fp8": 0.15}


class CacheOOM(RuntimeError):
    """The free list is empty: the scheduler must reserve a request's
    worst-case pages at admission, so a running sequence never runs
    out."""


@dataclasses.dataclass
class CacheConfig:
    num_layers: int
    num_kv_heads: int
    head_dim: int
    num_pages: int           # physical pages shared by every slot
    page_size: int           # tokens per page
    max_seqs: int            # decode slots (the block table's rows)
    max_pages_per_seq: int   # block-table width
    dtype: str = "float32"   # the model's dtype (unquantized pools)
    cache_dtype: str = "bf16"   # "bf16" (pools in `dtype`) | "int8" | "fp8"

    @property
    def quantized(self) -> bool:
        return self.cache_dtype != "bf16"

    @property
    def quant_fmt(self) -> str | None:
        """The ``ops/quantized_matmul`` format name, or None."""
        return _QUANT_FMT.get(self.cache_dtype)

    @property
    def pool_dtype(self) -> torch.dtype:
        return (_QUANT_TORCH[self.cache_dtype] if self.quantized
                else _MODEL_DTYPES[self.dtype])

    @property
    def page_bytes(self) -> int:
        """Device bytes one physical page costs across both pools, the
        scale entries of a quantized pool included."""
        itemsize = torch.empty((), dtype=self.pool_dtype).element_size()
        payload = (2 * self.num_layers * self.num_kv_heads
                   * self.page_size * self.head_dim * itemsize)
        scales = (2 * self.num_layers * self.num_kv_heads * 4
                  if self.quantized else 0)
        return payload + scales

    @property
    def pool_bytes(self) -> int:
        return self.num_pages * self.page_bytes

    def validate(self) -> "CacheConfig":
        for name in ("num_layers", "num_kv_heads", "head_dim",
                     "num_pages", "page_size", "max_seqs",
                     "max_pages_per_seq"):
            if getattr(self, name) < 1:
                raise ValueError(f"kv cache: {name} must be >= 1")
        if self.cache_dtype not in CACHE_DTYPES:
            raise ValueError(
                f"kv cache: unknown cache_dtype {self.cache_dtype!r} "
                f"(one of {CACHE_DTYPES})")
        if self.dtype not in _MODEL_DTYPES:
            raise ValueError(f"kv cache: dtype {self.dtype!r} (one of "
                             f"{tuple(_MODEL_DTYPES)})")
        if self.num_pages < self.max_pages_per_seq:
            raise ValueError(
                f"kv cache: num_pages {self.num_pages} cannot hold even "
                f"one max-seq request ({self.max_pages_per_seq} pages) — "
                f"the admission gate would starve the queue head forever")
        return self


def pages_for_pool_bytes(budget_bytes: int, cfg: CacheConfig) -> int:
    """How many physical pages a byte budget buys under ``cfg``'s
    geometry and cache dtype (scale arrays priced in through
    ``page_bytes``).  The count still has to pass ``validate``'s
    one-request guard, which fails loudly for a budget too small."""
    if budget_bytes < 1:
        raise ValueError(f"pages_for_pool_bytes: budget {budget_bytes}")
    return max(1, budget_bytes // cfg.page_bytes)


# ---------------------------------------------------------------------
# prefix trie (host): prompt token ids -> resident physical pages


class _TrieNode:
    """One cached page's worth of prompt tokens.  ``key`` is the token
    tuple the page holds (``page_size`` long for interior nodes; a
    shorter tuple is a partial boundary page, shareable copy-on-write up
    to its length).  Children may overlap in prefix: a lookup scans a
    node's few children for the best match."""

    __slots__ = ("key", "page", "parent", "children")

    def __init__(self, key: tuple, page: int, parent):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: dict[tuple, _TrieNode] = {}


class _PrefixTrie:
    """Trie over PUBLISHED prompt pages.  Non-owning: a node exists
    exactly while its physical page has readers (the allocator drops it
    when the refcount reaches 0), so a lookup never hands out a freed
    page."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _TrieNode((), -1, None)
        self._node_of_page: dict[int, _TrieNode] = {}

    def match(self, tokens) -> tuple[int, list[int], int | None]:
        """Longest shared prefix of ``tokens`` against the published
        pages: ``(shared_tokens, full_page_ids, partial_page_id)``, the
        fully covered pages in column order and the boundary page whose
        first ``shared_tokens % page_size`` rows match (None when the
        match ends on a page boundary)."""
        toks = tuple(int(t) for t in tokens)
        node, pos, full = self.root, 0, []
        s = self.page_size
        while len(toks) - pos >= s:
            child = node.children.get(toks[pos:pos + s])
            if child is None:
                break
            full.append(child.page)
            node = child
            pos += s
        # the boundary: the child sharing the longest token prefix with
        # the rest (at least one token to be worth a copy-on-write)
        rest = toks[pos:]
        best_len, best_page = 0, None
        for key, child in node.children.items():
            n = 0
            for a, b in zip(key, rest):
                if a != b:
                    break
                n += 1
            if n > best_len:
                best_len, best_page = n, child.page
        if best_len > 0:
            return pos + best_len, full, best_page
        return pos, full, None

    def publish(self, tokens, pages: list[int]) -> None:
        """Register a fully prefilled prompt's pages.  Idempotent: a path
        already present (the publisher shared it) is left alone; the
        first publisher wins, the content being the same."""
        toks = tuple(int(t) for t in tokens)
        s = self.page_size
        node, pos, col = self.root, 0, 0
        while pos < len(toks):
            key = toks[pos:pos + s]
            child = node.children.get(key)
            if child is None:
                page = pages[col]
                if page in self._node_of_page:
                    # the page already backs another node (a shared page
                    # republished under a longer prompt): never twice
                    child = self._node_of_page[page]
                    if child.key != key:
                        break
                else:
                    child = _TrieNode(key, page, node)
                    node.children[key] = child
                    self._node_of_page[page] = child
            node = child
            pos += len(key)
            col += 1
            if len(key) < s:      # a partial tail ends the path
                break

    def drop_page(self, page: int) -> None:
        """The page's refcount reached 0: unlink its node.  A holder of a
        child page holds its parent too (it matched the whole path), so
        a dying node has no live children."""
        node = self._node_of_page.pop(page, None)
        if node is not None and node.parent is not None:
            node.parent.children.pop(node.key, None)


@dataclasses.dataclass
class AdmissionPlan:
    """What admitting one request costs and shares (``plan_admission``
    -> ``admit``): the UNSHARED page charge, the matched prefix, and the
    copy-on-write source of a partly shared boundary page (the engine
    copies it on the device)."""
    n_tokens: int
    need_pages: int
    shared_tokens: int = 0
    shared_pages: list = dataclasses.field(default_factory=list)
    cow_src: int | None = None       # physical page to copy from
    cow_rows: int = 0                # valid prefix rows in cow_src


class PagedKVCache:
    """Host-side page allocator + block tables.  Page 0 is a real,
    allocatable page; block-table padding also points at 0, which every
    consumer masks by length.  Every page carries a refcount (see the
    module docstring)."""

    def __init__(self, cfg: CacheConfig):
        self.cfg = cfg.validate()
        self._free: list[int] = list(range(cfg.num_pages - 1, -1, -1))
        self._ref = np.zeros((cfg.num_pages,), np.int32)
        self.block_tables = np.zeros(
            (cfg.max_seqs, cfg.max_pages_per_seq), np.int32)
        self.lengths = np.zeros((cfg.max_seqs,), np.int32)
        self._pages_of: list[list[int]] = [[] for _ in range(cfg.max_seqs)]
        self.peak_pages_in_use = 0
        self.trie = _PrefixTrie(cfg.page_size)
        self.admissions = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_shared_tokens = 0
        self.prefix_pages_shared = 0
        self.prefix_bytes_saved = 0
        self.cow_copies = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.cfg.num_pages - len(self._free)

    def can_fit(self, n_tokens: int) -> bool:
        return -(-n_tokens // self.cfg.page_size) <= len(self._free)

    def prefix_match_len(self, prompt_tokens) -> int:
        """Read-only probe: how many of the prompt's leading tokens are
        already resident in published pages, capped at ``prompt_len -
        1`` as ``plan_admission`` caps it.  Not counted in the lookup or
        hit stats: a probe is not an admission."""
        if prompt_tokens is None or len(prompt_tokens) < 2:
            return 0
        matched, _full, _partial = self.trie.match(
            np.asarray(prompt_tokens)[: len(prompt_tokens) - 1])
        return int(matched)

    def plan_admission(self, n_tokens: int,
                       prompt_tokens=None) -> AdmissionPlan:
        """Price one admission.  With ``prompt_tokens`` (prefix sharing
        on) the trie is consulted: matched full pages are shared by
        reference and charged nothing; a partly matched boundary page is
        charged (its private copy) but its prefix rows skip prefill.
        The match is capped at ``prompt_len - 1``: the last prompt token
        always prefills, its forward pass giving the first generated
        token."""
        s = self.cfg.page_size
        total = -(-n_tokens // s)
        if total > self.cfg.max_pages_per_seq:
            raise ValueError(
                f"kv cache: {n_tokens} tokens need {total} pages > "
                f"max_pages_per_seq {self.cfg.max_pages_per_seq}")
        if prompt_tokens is None or len(prompt_tokens) < 2:
            return AdmissionPlan(n_tokens=n_tokens, need_pages=total)
        self.prefix_lookups += 1
        matched, full_pages, partial_page = self.trie.match(
            np.asarray(prompt_tokens)[: len(prompt_tokens) - 1])
        full = len(full_pages)
        partial = matched - full * s
        if partial <= 0:
            partial_page = None
            matched = full * s
        return AdmissionPlan(
            n_tokens=n_tokens, need_pages=total - full,
            shared_tokens=matched, shared_pages=list(full_pages),
            cow_src=partial_page, cow_rows=partial)

    def admit(self, slot: int, plan: AdmissionPlan) -> int | None:
        """Carry out a plan on an empty slot: shared pages by reference
        (refcount + 1), the rest freshly allocated, the boundary page's
        private copy included.  Returns the copy-on-write DESTINATION
        page when the plan has one (the engine copies ``plan.cow_src``
        into it on the device), else None.  ``lengths[slot]`` starts at
        ``shared_tokens``: that content is already cached."""
        if self._pages_of[slot]:
            raise ValueError(f"kv cache: slot {slot} already allocated")
        if plan.need_pages > len(self._free):
            raise CacheOOM(
                f"kv cache: need {plan.need_pages} pages, "
                f"{len(self._free)} free — admission control must gate "
                f"on the plan (can_fit() for the no-sharing path)")
        total = -(-plan.n_tokens // self.cfg.page_size)
        self.admissions += 1
        cow_dst = None
        for i in range(total):
            if i < len(plan.shared_pages):
                page = plan.shared_pages[i]
                self._ref[page] += 1
            else:
                page = self._free.pop()
                self._ref[page] = 1
                if i == len(plan.shared_pages) and plan.cow_src is not None:
                    cow_dst = page
            self._pages_of[slot].append(page)
            self.block_tables[slot, i] = page
        self.lengths[slot] = plan.shared_tokens
        if plan.shared_tokens > 0:
            self.prefix_hits += 1
            self.prefix_shared_tokens += plan.shared_tokens
            self.prefix_pages_shared += len(plan.shared_pages)
            self.prefix_bytes_saved += (len(plan.shared_pages)
                                        * self.cfg.page_bytes)
        if cow_dst is not None:
            self.cow_copies += 1
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)
        return cow_dst

    def allocate(self, slot: int, n_tokens: int) -> None:
        """Reserve pages for ``n_tokens`` on an empty slot (the scheduler
        reserves prompt + output up front): the no-sharing admission."""
        self.admit(slot, self.plan_admission(n_tokens))

    def append(self, slot: int, n: int = 1) -> None:
        """Advance the slot's length by ``n`` tokens (the device write
        already happened).  Growing past the reservation is a scheduler
        bug, and so is writing into a page another sequence still reads
        (copy-on-write must have replaced it at admission)."""
        s = self.cfg.page_size
        old_len = int(self.lengths[slot])
        new_len = old_len + n
        if new_len > len(self._pages_of[slot]) * s:
            raise CacheOOM(
                f"kv cache: slot {slot} grew to {new_len} tokens past "
                f"its {len(self._pages_of[slot])}-page reservation")
        for col in range(old_len // s, (new_len - 1) // s + 1):
            page = self._pages_of[slot][col]
            if self._ref[page] > 1:
                raise RuntimeError(
                    f"kv cache: slot {slot} wrote into shared page "
                    f"{page} (refcount {int(self._ref[page])}) — a "
                    f"shared page is read-only; copy-on-write must "
                    f"have replaced it at admission")
        self.lengths[slot] = new_len

    def free(self, slot: int) -> None:
        """Release the slot's pages: a page returns to the free list and
        leaves the trie when its last reader frees it."""
        for page in self._pages_of[slot]:
            self._ref[page] -= 1
            if self._ref[page] == 0:
                self._free.append(page)
                self.trie.drop_page(page)
            elif self._ref[page] < 0:
                raise RuntimeError(
                    f"kv cache: page {page} refcount went negative")
        self._pages_of[slot] = []
        self.block_tables[slot, :] = 0
        self.lengths[slot] = 0

    def publish(self, slot: int, prompt_tokens) -> None:
        """Register the slot's fully prefilled PROMPT pages in the trie
        (generated tokens are the request's own and never published)."""
        toks = np.asarray(prompt_tokens)
        n = -(-len(toks) // self.cfg.page_size)
        self.trie.publish(toks, self._pages_of[slot][:n])

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def stats(self) -> dict:
        """Occupancy = fraction of pages in use; fragmentation =
        fraction of allocated token capacity holding no token (shared
        pages count once).  The prefix-sharing counters ride along once
        a lookup happened."""
        cap = self.pages_in_use * self.cfg.page_size
        toks = int(self.lengths.sum())
        out = {
            "num_pages": self.cfg.num_pages,
            "page_size": self.cfg.page_size,
            "cache_dtype": self.cfg.cache_dtype,
            "pool_bytes": self.cfg.pool_bytes,
            "pages_in_use": self.pages_in_use,
            "peak_pages_in_use": self.peak_pages_in_use,
            "admissions": self.admissions,
            "occupancy": round(self.pages_in_use / self.cfg.num_pages, 4),
            "peak_occupancy": round(
                self.peak_pages_in_use / self.cfg.num_pages, 4),
            "fragmentation": (round(max(cap - toks, 0) / cap, 4)
                              if cap else 0.0),
        }
        if self.prefix_lookups:
            out["prefix"] = {
                "lookups": self.prefix_lookups,
                "hits": self.prefix_hits,
                # per admission, not per lookup: a blocked queue head is
                # planned again every engine step
                "hit_rate": round(self.prefix_hits
                                  / max(self.admissions, 1), 4),
                "shared_tokens": self.prefix_shared_tokens,
                "pages_shared": self.prefix_pages_shared,
                "bytes_saved": self.prefix_bytes_saved,
                "cow_copies": self.cow_copies,
            }
        return out


def device_buffers(cfg: CacheConfig, device="cuda") -> tuple:
    """Zeroed pools ``(k, v)``; quantized configs add ``(k_scale,
    v_scale)`` set to 1.0 (a zeroed page dequantizes to zeros)."""
    shape = (cfg.num_layers, cfg.num_kv_heads, cfg.num_pages,
             cfg.page_size, cfg.head_dim)
    k = torch.zeros(shape, dtype=cfg.pool_dtype, device=device)
    v = torch.zeros(shape, dtype=cfg.pool_dtype, device=device)
    if not cfg.quantized:
        return k, v
    return (k, v, torch.ones(shape[:3], dtype=_F32, device=device),
            torch.ones(shape[:3], dtype=_F32, device=device))


# ---------------------------------------------------------------------
# cache writes


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Pool bytes for selection and indexing: e4m3 tensors are handled
    through a uint8 view (the same bytes), every other dtype as is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


class HeadShards:
    """One pool split along its KV-head axis over devices: ``parts[i]``
    holds heads ``[i * h, (i + 1) * h)`` on its own device.  Indexing
    takes the same index of every part, so ``pool[li]`` is the layer's
    shards, heads on axis 0 — the layouts this module's functions take
    in either form."""
    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)

    def __getitem__(self, index) -> "HeadShards":
        return HeadShards(p[index] for p in self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    @property
    def devices(self) -> list:
        return [p.device for p in self.parts]


class PerShard(tuple):
    """A step operand copied once to each shard's device, aligned with a
    ``HeadShards``' parts (``per_shard``)."""


def sharded_buffers(cfg: CacheConfig, devices) -> tuple:
    """``device_buffers`` split along the KV heads over ``devices``: the
    same zeroed pools (and unit scales), one ``HeadShards`` a pool.
    ``len(devices)`` must divide ``num_kv_heads``."""
    n = len(devices)
    if cfg.num_kv_heads % n:
        raise ValueError(f"serving: kv_shard {n} must divide num_kv_heads "
                         f"{cfg.num_kv_heads}")
    part_cfg = dataclasses.replace(cfg, num_kv_heads=cfg.num_kv_heads // n)
    parts = [device_buffers(part_cfg, d) for d in devices]
    return tuple(HeadShards(p[i] for p in parts)
                 for i in range(len(parts[0])))


def _moved(x, dev):
    """``x`` (a tensor, a ``WriteGate`` or a span plan) on ``dev``; a
    tensor already there is returned as is."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=True)
    if isinstance(x, WriteGate):
        return WriteGate(targets=tuple(_moved(t, dev) for t in x.targets),
                         first=_moved(x.first, dev),
                         first_on=_moved(x.first_on, dev),
                         first_target=tuple(_moved(t, dev)
                                            for t in x.first_target),
                         ok=_moved(x.ok, dev))
    if isinstance(x, list):
        return [SpanColumn(page=_moved(c.page, dev),
                           old_valid=_moved(c.old_valid, dev),
                           onehot=_moved(c.onehot, dev),
                           new_mask=_moved(c.new_mask, dev),
                           gate=_moved(c.gate, dev)) for c in x]
    raise TypeError(f"per_shard: cannot move {type(x).__name__}")


def per_shard(x, pools: HeadShards) -> PerShard:
    """``x`` copied to each of ``pools``' devices, in part order."""
    if isinstance(x, PerShard):
        return x
    return PerShard(_moved(x, d) for d in pools.devices)


def _heads(part_ix: int, total: int, n: int) -> slice:
    h = total // n
    return slice(part_ix * h, (part_ix + 1) * h)


def gather_pages(pages, idx):
    """``pages[:, idx]`` of one layer's pool or scales (heads first); on
    shards each part is gathered on its device and the parts come back
    concatenated along the heads on ``idx``'s device."""
    if isinstance(pages, HeadShards):
        return torch.cat([take_pages(p, idx.to(p.device)).to(idx.device)
                          for p in pages.parts])
    return take_pages(pages, idx)


@dataclasses.dataclass(frozen=True)
class WriteGate:
    """Where the rows of a gated write land (see the module docstring):
    ``targets`` — one ``[B]`` index tensor per indexed pool dimension,
    a disabled row redirected to the first enabled row's target;
    ``first`` — ``[1]`` index of that row (0 when none is enabled),
    ``first_on`` its ``[1]`` enable bit, ``first_target`` its target;
    ``ok`` — the ``[B]`` enable bits.  Built once per step (or chunk)
    and shared by every layer's k and v writes."""
    targets: tuple
    first: torch.Tensor
    first_on: torch.Tensor
    first_target: tuple
    ok: torch.Tensor


def write_gate(idx: tuple, ok: torch.Tensor) -> WriteGate:
    """The gate for writing row ``b`` at ``idx[..][b]`` where ``ok[b]``.
    The first enabled row is found on the device (a ``[1]`` tensor:
    indexing with a 0-d tensor would read it back to the host)."""
    first = torch.argmax(ok.to(torch.int32)).view(1)
    targets = tuple(torch.where(ok, i, i[first]).long() for i in idx)
    return WriteGate(targets=targets, first=first, first_on=ok[first],
                     first_target=tuple(t[first] for t in targets), ok=ok)


def _gated_put(pool, gate: WriteGate, val) -> None:
    """``pool[:, *targets[b]] = val[:, b]`` for the enabled rows; the rest
    change nothing.  ``pool`` is a byte-level view (``_bits``), ``val``
    ``[H, B, ...]`` of pool's dtype."""
    shape = (1, -1) + (1,) * (val.dim() - 2)
    old = pool[(slice(None),) + gate.first_target]
    first = torch.where(gate.first_on.view(shape), val[:, gate.first], old)
    pool[(slice(None),) + gate.targets] = torch.where(gate.ok.view(shape),
                                                      val, first)


def write_rows(pages, li: int, new, gate: WriteGate):
    """Unquantized write of one token per row: ``new[b]`` (``[Hkv, Dh]``)
    lands at ``pages[li, :, page, row]`` for the gate's ``(page, row)``
    targets (``write_gate((page_ids, rows), write_ok)``).  In place;
    returns ``pages``.  On shards each part takes its heads of ``new``
    and the gate on its device (``per_shard``)."""
    if isinstance(pages, HeadShards):
        gates = per_shard(gate, pages)
        n = len(pages)
        for i, (part, g) in enumerate(zip(pages.parts, gates)):
            write_rows(part, li, new[:, _heads(i, new.shape[1], n)]
                       .to(part.device, non_blocking=True), g)
        return pages
    val = _bits(new.transpose(0, 1).to(pages.dtype))        # [Hkv, B, Dh]
    _gated_put(_bits(pages[li]), gate, val)
    return pages


@dataclasses.dataclass(frozen=True)
class SpanColumn:
    """One page column a span write touches — everything about it that
    does not depend on the layer or on k/v, so a step plans it once:
    the page per slot, the cached rows kept (``old_valid``), the new
    rows (``onehot`` token -> row, ``new_mask``), and the write gate."""
    page: torch.Tensor
    old_valid: torch.Tensor
    onehot: torch.Tensor
    new_mask: torch.Tensor
    gate: WriteGate


def span_plan(positions, write_ok, block_tables, *, page_size: int,
              num_pages: int) -> list[SpanColumn]:
    """Plan a span write: token ``j`` of slot ``b`` lands at position
    ``positions[b] + j``, gated by ``write_ok[b, j]``; positions ``[B]``,
    write_ok ``[B, K]``, block_tables ``[B, pmax]``."""
    k1 = write_ok.shape[1]
    s = page_size
    pmax = block_tables.shape[1]
    dev = write_ok.device
    pos = positions.long()
    tok_pos = pos[:, None] + torch.arange(k1, device=dev)[None, :]
    tok_col = tok_pos // s                                  # [B, K]
    row_of_tok = tok_pos % s
    rows = torch.arange(s, device=dev)
    bt = block_tables.long()
    plan = []
    # bound on distinct page columns one span can touch
    for c in range((k1 + s - 2) // s + 1):
        col = pos // s + c                                  # [B]
        in_col = (tok_col == col[:, None]) & write_ok       # [B, K]
        page = bt.gather(1, col.clamp(0, pmax - 1)[:, None])[:, 0]
        page = page.clamp(max=num_pages - 1)
        old_valid = rows[None, :] < (pos - col * s).clamp(0, s)[:, None]
        onehot = in_col[:, :, None] & (rows[None, None, :]
                                       == row_of_tok[:, :, None])
        plan.append(SpanColumn(
            page=page, old_valid=old_valid[None, :, :, None],
            onehot=onehot.to(_F32),
            new_mask=onehot.any(dim=1)[None, :, :, None],
            gate=write_gate((page,), in_col.any(dim=1))))
    return plan


def write_span(pages, scales, li: int, new, plan: list[SpanColumn], *,
               fmt: str):
    """Write a planned span into layer ``li`` of a QUANTIZED pool: every
    touched page is re-quantized against a fresh amax over its valid
    rows — the cached prefix (dequantized at the old scale) plus the new
    rows, masked to the sequence's own content.  The JAX package's
    arithmetic (divide by the scale, ``cast_q``).  pages ``[L, Hkv, P,
    S, Dh]`` int8/e4m3, scales ``[L, Hkv, P]`` f32, new ``[B, K, Hkv,
    Dh]``.  In place; returns ``(pages, scales)``.  On shards each part
    (pages and scales) takes its heads of ``new`` and the plan on its
    device."""
    if isinstance(pages, HeadShards):
        plans = per_shard(plan, pages)
        n = len(pages)
        for i, (pp, sp, pl) in enumerate(zip(pages.parts, scales.parts,
                                             plans)):
            write_span(pp, sp, li, new[:, :, _heads(i, new.shape[2], n)]
                       .to(pp.device, non_blocking=True), pl, fmt=fmt)
        return pages, scales
    pool = _bits(pages[li])
    sc = scales[li]
    newf = new.to(_F32)
    for col in plan:
        deq = (pool[:, col.page].view(pages.dtype).to(_F32)
               * sc[:, col.page][:, :, None, None])         # [H, B, S, D]
        base = torch.where(col.old_valid, deq, 0.0)
        new_rows = torch.einsum("bks,bkhd->hbsd", col.onehot, newf)
        pagef = torch.where(col.new_mask, new_rows, base)
        scale = scale_from_amax(pagef.abs().amax(dim=(2, 3)), fmt)
        q = _bits(cast_q(pagef / scale[:, :, None, None], fmt))
        _gated_put(sc, col.gate, scale)
        _gated_put(pool, col.gate, q)
    return pages, scales


def quant_write_span(pages, scales, li: int, new, positions, write_ok,
                     block_tables, *, fmt: str, page_size: int,
                     num_pages: int):
    """The JAX package's ``quant_write_span`` signature: ``span_plan``
    then ``write_span``."""
    return write_span(pages, scales, li, new,
                      span_plan(positions, write_ok, block_tables,
                                page_size=page_size, num_pages=num_pages),
                      fmt=fmt)


def copy_page(pools, src: int, dst: int) -> None:
    """Copy physical page ``src`` into ``dst`` along the page axis of
    every pool (axis 2 of ``[L, Hkv, P, S, Dh]``) and, on a quantized
    cache, of both scale arrays (axis 2 of ``[L, Hkv, P]``): the
    admission-time copy-on-write of a shared boundary page.  In place,
    on every shard of a sharded pool."""
    for t in pools:
        for part in (t.parts if isinstance(t, HeadShards) else (t,)):
            b = _bits(part)
            b[:, :, dst] = b[:, :, src]


def dequant_gathered(pages_g, scales_g):
    """Gathered quantized pages -> f32: ``pages_g`` [..., pages, S, Dh]
    times the matching [..., pages] scales."""
    return pages_g.to(_F32) * scales_g[..., None, None]


# ---------------------------------------------------------------------
# decode attention over the page pool


def _check_divides(p, pages_per_seq: int, what: str = "") -> None:
    if not isinstance(p, int) or p < 1 or pages_per_seq % p:
        raise ValueError(
            f"{what}pages_per_compute_block={p!r} does not divide "
            f"pages_per_seq {pages_per_seq}")


def decode_split(b: int, hq: int, hkv: int, dh: int, pages_per_seq: int,
                 page_size: int, fmt: str | None = None,
                 device=None) -> int:
    """K1/K2's pages a split for a decode batch of this geometry on
    ``device``, resolved once where the shapes are fixed (the decode
    programs' build): the tuning DB's ``pages_per_compute_block`` (op
    ``paged_attention``, or ``paged_attention_quant`` with ``fmt``; the
    JAX package's keys; validated to divide ``pages_per_seq``, as the
    JAX package validates it), or the kernel's ``split_pages`` on a
    miss.  0 with the tuner off: the launch sizes its own split, as an
    untuned build's does, and the served step's host path does no more
    work than it did."""
    from dlnetbench_tpu_torch import tuning
    from dlnetbench_tpu_torch.ops.paged_attention import split_pages
    if not tuning.enabled():
        return 0
    if fmt is None:
        op = "paged_attention"
        key = tuning.params.paged_attention_key(pages_per_seq, page_size,
                                                b, hq, hkv, dh)
    else:
        op = "paged_attention_quant"
        key = tuning.params.paged_attention_quant_key(
            pages_per_seq, page_size, b, hq, hkv, dh, fmt)
    cfg = tuning.consult(
        op, key,
        {"pages_per_compute_block": split_pages(page_size, pages_per_seq)},
        validate=lambda c: _check_divides(c.get("pages_per_compute_block"),
                                          pages_per_seq),
        device=device)
    return cfg["pages_per_compute_block"]


def resolve_pages_per_compute_block(q, k_pages, page_indices,
                                    pages_per_compute_block: int | None,
                                    fmt: str | None = None) -> int:
    """The kernels' pages a split (the JAX package's
    ``pages_per_compute_block`` knob, the same function): an explicit
    value wins and must divide the per-sequence page count exactly
    (with JAX's message); None consults the tuning DB
    (``decode_split``) and takes the kernel's ``split_pages`` on a miss
    or with the tuner off."""
    from dlnetbench_tpu_torch.ops.paged_attention import split_pages
    pages_per_seq = page_indices.shape[1]
    if pages_per_compute_block is not None:
        _check_divides(pages_per_compute_block, pages_per_seq,
                       "paged_attention: ")
        return pages_per_compute_block
    b, hq, dh = q.shape
    hkv, _, page_size, _ = k_pages.shape
    return (decode_split(b, hq, hkv, dh, pages_per_seq, page_size, fmt,
                         q.device)
            or split_pages(page_size, pages_per_seq))


def paged_attention_decode(q, k_pages, v_pages, lengths, page_indices, *,
                           k_scale=None, v_scale=None,
                           fmt: str | None = None, impl: str = "auto",
                           pages_per_compute_block: int | None = None,
                           split: int | None = None):
    """One decode step's attention for a batch of slots over ONE layer's
    pools (``[Hkv, P, S, Dh]``).  ``q`` must be pre-scaled by
    ``head_dim**-0.5``.  With ``k_scale``/``v_scale`` (+ ``fmt``) the
    pools are quantized and K2 runs; otherwise K1.  ``impl``: ``auto``
    (the kernel on a CUDA tensor, its plain version on a CPU tensor) or
    ``gather`` (the plain version on either device).

    The kernels' pages a split: ``split`` when the caller resolved it
    already (the decode programs, once: ``decode_split``; 0 is the
    kernel's own ``split_pages``), else
    ``pages_per_compute_block`` resolved as the JAX package resolves it
    (``resolve_pages_per_compute_block``: an explicit value must divide
    the pages a slot; None consults the tuning DB on the kernel path).
    An explicit value is validated on every path, the plain one
    included; the plain versions' results do not depend on it.

    On sharded pools (``HeadShards``) each shard attends over its own
    KV heads on its own device: ``q`` is split by GQA group, K1/K2 run
    once a shard (a failed launch raises; there is no fallback),
    ``lengths`` and ``page_indices`` are a ``per_shard`` copy or moved
    here, and the outputs come back concatenated on ``q``'s device.  A
    resolved ``split`` is the per-shard shapes'."""
    if k_scale is not None and fmt is None:
        raise ValueError("paged_attention_decode: scale arrays need "
                         "fmt ('int8'|'float8')")
    if impl not in ATTN_IMPLS:
        raise ValueError(f"paged_attention_decode: unknown impl "
                         f"{impl!r} (auto|gather)")
    if pages_per_compute_block is not None:
        _check_divides(pages_per_compute_block, page_indices.shape[1],
                       "paged_attention: ")
    if isinstance(k_pages, HeadShards):
        return _sharded_decode(q, k_pages, v_pages, lengths, page_indices,
                               k_scale=k_scale, v_scale=v_scale, fmt=fmt,
                               impl=impl, split=split,
                               pages_per_compute_block=
                               pages_per_compute_block)
    if impl == "gather":
        return gather_attention(q, k_pages, v_pages, lengths,
                                page_indices, k_scale, v_scale)
    if split is None and q.is_cuda:
        split = resolve_pages_per_compute_block(
            q, k_pages, page_indices, pages_per_compute_block,
            fmt if k_scale is not None else None)
    if k_scale is not None:
        return quant_paged_attention(q, k_pages, v_pages, k_scale,
                                     v_scale, lengths, page_indices,
                                     fmt=fmt, split=split or None)
    return paged_attention(q, k_pages, v_pages, lengths, page_indices,
                           split=split or None)


def _sharded_decode(q, k_pages: HeadShards, v_pages: HeadShards, lengths,
                    page_indices, *, k_scale, v_scale, fmt, impl, split,
                    pages_per_compute_block):
    """``paged_attention_decode`` over KV-head shards (its docstring)."""
    n = len(k_pages)
    lens = per_shard(lengths, k_pages)
    bts = per_shard(page_indices, k_pages)
    outs = []
    for i, dev in enumerate(k_pages.devices):
        q_i = q[:, _heads(i, q.shape[1], n)].contiguous().to(
            dev, non_blocking=True)
        out = paged_attention_decode(
            q_i, k_pages.parts[i], v_pages.parts[i], lens[i], bts[i],
            k_scale=None if k_scale is None else k_scale.parts[i],
            v_scale=None if v_scale is None else v_scale.parts[i],
            fmt=fmt, impl=impl, split=split,
            pages_per_compute_block=pages_per_compute_block)
        outs.append(out.to(q.device, non_blocking=True))
    return torch.cat(outs, dim=1)
