"""KV-page migration channel: prefill pool -> decode pool, in the STORED
dtype (the JAX package's ``ops/page_migration.py``).

The disaggregated server (``serving/disagg.py``) finishes a prompt on
the prefill replica and hands its pages to the decode replica over this
channel.  A send moves the sequence's pages as a short loop of chunk
transfers: per chunk and per pool, an index gather of ``[L, Hkv, chunk,
S, Dh]`` pages (``[L, Hkv, chunk]`` for the f32 scales of an int8/fp8
cache) in the pool's own dtype, a copy to the destination device, and
at landing an index scatter into the destination pools.  The payload is
never widened, so the decode replica reads exactly the bytes a
monolithic engine would have written: the token-parity bar rests on it.
The index programs are plain torch ops, as the JAX package's are jitted
index programs (no kernel of the TPU's sits on this path).

Streams, on a card.  A cross-device ``copy_`` on the current streams
would wait on the decode replica's in-flight program (torch barriers the
copy against the destination's current stream), so each send runs on
side streams: the source's side stream waits on an event recorded on
the source's current stream (the prefill writes), gathers and copies
there, with the destination's side stream current for the copy; the
arrival is an event on the destination's side stream, and ``scatter``
makes the destination's current stream wait on it.  Torch does not
order a later write to a freed source page after the in-flight read
(the JAX runtime does), so the source's current stream waits on the
send's completion event before any later work on it — the prefill
replica may reuse the pages at once.

Byte accounting is closed form: a migrated page costs exactly
``CacheConfig.page_bytes`` (payload rows plus, quantized, the 2 x L x
Hkv f32 scales), and the bf16 equivalent is kept beside it so the record
states its compression ratio.  Overlap: a send is fenced (solo, the
comm-only leg) or left in flight under a decode dispatch; the channel
records the raw legs and reduces them through
``metrics/stats.overlap_fraction``, NaN unless every leg was measured.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from dlnetbench_tpu_torch.metrics import stats
from dlnetbench_tpu_torch.serving.kv_cache import CacheConfig, _bits

# sends made by every channel in this process (reset by the caller)
sends = 0


def _ids(ids: list[int], device: torch.device) -> torch.Tensor:
    """Page ids as an index tensor on ``device``; on a card through
    pinned memory and a non-blocking copy (a pageable upload would
    synchronise the stream)."""
    t = torch.from_numpy(np.asarray(ids, np.int64))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def bf16_equiv_page_bytes(cfg: CacheConfig) -> int:
    """One page's k+v payload stored as bf16 with no scales: the
    denominator of the migration compression ratio."""
    return (2 * cfg.num_layers * cfg.num_kv_heads * cfg.page_size
            * cfg.head_dim * 2)


@dataclasses.dataclass
class SendRecord:
    """One sequence's migration: closed-form bytes, measured wall."""
    pages: int
    bytes: int
    wall_ms: float
    chunks: int
    overlapped: bool   # dispatched under an in-flight decode program


class PendingSend:
    """A send in flight: the payload slabs on the destination device and,
    on a card, the arrival event.  ``wait()`` fences it and closes its
    timing window (dispatch -> arrival); idempotent."""

    def __init__(self, channel: "MigrationChannel", slabs: tuple,
                 page_ids: list[int], t0: float, overlapped: bool,
                 arrived=None):
        self._channel = channel
        self.slabs = slabs
        self.page_ids = list(page_ids)
        self.arrived = arrived
        self._t0 = t0
        self._overlapped = overlapped
        self._record: SendRecord | None = None

    def wait(self) -> SendRecord:
        if self._record is None:
            if self.arrived is not None:
                self.arrived.synchronize()
            ch = self._channel
            rec = SendRecord(
                pages=len(self.page_ids),
                bytes=ch.bytes_for_pages(len(self.page_ids)),
                wall_ms=(time.perf_counter() - self._t0) * 1e3,
                chunks=len(self.slabs), overlapped=self._overlapped)
            ch._sends.append(rec)
            self._record = rec
        return self._record


class MigrationChannel:
    """Pages (and scales) from a source pool to ``dst_device`` as a chunk
    loop in the stored dtype.  One channel per disaggregated pair; its
    sends become the record's ``migration`` block."""

    def __init__(self, cache_cfg: CacheConfig, dst_device, *,
                 chunk_pages: int = 8):
        if chunk_pages < 1:
            raise ValueError(
                f"page migration: chunk_pages must be >= 1, got "
                f"{chunk_pages}")
        self.cfg = cache_cfg
        self.dst_device = torch.device(dst_device)
        self.chunk_pages = int(chunk_pages)
        self._sends: list[SendRecord] = []
        self._compute_solo_s: list[float] = []
        self._both_s: list[float] = []
        self._side: dict = {}     # device -> its side stream

    def reset(self) -> None:
        """Clear the sends and overlap legs (a new measured run)."""
        self._sends.clear()
        self._compute_solo_s.clear()
        self._both_s.clear()

    # ---- closed-form byte accounting ---------------------------------
    def bytes_for_pages(self, n_pages: int) -> int:
        """Wire bytes for ``n_pages``: exactly ``n * page_bytes``."""
        return int(n_pages) * self.cfg.page_bytes

    def bf16_equiv_bytes(self, n_pages: int) -> int:
        return int(n_pages) * bf16_equiv_page_bytes(self.cfg)

    # ---- the wire ----------------------------------------------------
    def _side_stream(self, device: torch.device):
        s = self._side.get(device)
        if s is None:
            s = self._side[device] = torch.cuda.Stream(device=device)
        return s

    def send(self, pools: tuple, page_ids, *, fence: bool = True,
             overlapped: bool = False) -> PendingSend:
        """Move ``page_ids`` (source-pool page ids) to the destination
        device.  ``pools`` is the source engine's pool tuple, ``(k, v)``
        or ``(k, v, k_scale, v_scale)``; the slabs keep its structure
        and dtypes.  ``fence=True`` waits for the arrival (the solo
        comm leg); ``fence=False`` leaves it in flight for the server
        to ``wait()`` after the decode dispatch it overlapped."""
        global sends
        ids = [int(p) for p in page_ids]
        if not ids:
            raise ValueError("page migration: empty page list — a "
                             "zero-page send is a scheduler bug, not "
                             "a transfer")
        t0 = time.perf_counter()
        src = pools[0].device
        dst = self.dst_device
        chunks = [ids[lo:lo + self.chunk_pages]
                  for lo in range(0, len(ids), self.chunk_pages)]
        arrived = None
        if src.type == "cuda":
            src_side, dst_side = (self._side_stream(src),
                                  self._side_stream(dst))
            src_side.wait_stream(torch.cuda.current_stream(src))
            with torch.cuda.stream(src_side), torch.cuda.stream(dst_side):
                slabs = self._move(pools, chunks, src, dst)
            done = torch.cuda.Event()
            done.record(src_side)
            # the prefill stream's later writes (a freed page reused)
            # wait for the in-flight read of the payload
            torch.cuda.current_stream(src).wait_event(done)
            arrived = torch.cuda.Event()
            arrived.record(dst_side)
        else:
            slabs = self._move(pools, chunks, src, dst)
        sends += 1
        pending = PendingSend(self, tuple(slabs), ids, t0,
                              overlapped=overlapped, arrived=arrived)
        if fence:
            pending.wait()
        return pending

    @staticmethod
    def _move(pools, chunks, src, dst) -> list:
        slabs = []
        for chunk in chunks:
            idx = _ids(chunk, src)
            moved = []
            for pool in pools:
                slab = _bits(pool)[:, :, idx]
                out = torch.empty(slab.shape, dtype=slab.dtype, device=dst)
                out.copy_(slab, non_blocking=True)
                moved.append(out.view(pool.dtype))
            slabs.append(tuple(moved))
        return slabs

    def scatter(self, dst_pools: tuple, pending: PendingSend,
                dst_page_ids) -> tuple:
        """Land a send's slabs in ``dst_pools`` at ``dst_page_ids``
        (positional: source page k -> destination page k), in place, on
        the destination's current stream after the arrival.  Returns
        the pools."""
        dst = [int(p) for p in dst_page_ids]
        if len(dst) != len(pending.page_ids):
            raise ValueError(
                f"page migration: {len(pending.page_ids)} pages sent "
                f"but {len(dst)} destination pages allocated — the "
                f"block tables would desync from the payload")
        pools = tuple(dst_pools)
        dev = pools[0].device
        if pending.arrived is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(pending.arrived)
        off = 0
        for slab in pending.slabs:
            n = int(slab[0].shape[2])
            ids = _ids(dst[off:off + n], dev)
            for pool, part in zip(pools, slab):
                if pending.arrived is not None:
                    # the slab was made on the side stream: keep its
                    # memory until this stream's scatter has read it
                    part.record_stream(stream)
                _bits(pool)[:, :, ids] = _bits(part)
            off += n
        return pools

    # ---- overlap legs (server-fed) -----------------------------------
    def note_compute_solo(self, wall_s: float) -> None:
        """A decode dispatch window with no send in flight."""
        self._compute_solo_s.append(float(wall_s))

    def note_both(self, wall_s: float) -> None:
        """A decode dispatch window that covered an in-flight send,
        dispatch -> both fenced."""
        self._both_s.append(float(wall_s))

    # ---- the record block --------------------------------------------
    def overlap(self) -> float:
        """Median-leg overlap fraction, or NaN unless the comm-solo,
        compute-solo and together legs were all measured."""
        comm = [r.wall_ms * 1e-3 for r in self._sends
                if not r.overlapped]
        if not comm or not self._compute_solo_s or not self._both_s:
            return float("nan")
        med = stats.summarize
        tm = med(comm)["value"]
        tc = med(self._compute_solo_s)["value"]
        tb = med(self._both_s)["value"]
        return stats.overlap_fraction([tb], [tc], [tm])[0]

    def stats_block(self) -> dict | None:
        """The serving record's ``migration`` block; None when the
        channel never carried a sequence."""
        if not self._sends:
            return None
        from dlnetbench_tpu_torch.serving.metrics import percentile
        pages = sum(r.pages for r in self._sends)
        walls = [r.wall_ms for r in self._sends]
        ov = self.overlap()
        return {
            "sends": len(self._sends),
            "pages": pages,
            "bytes": self.bytes_for_pages(pages),
            "bf16_equiv_bytes": self.bf16_equiv_bytes(pages),
            "bytes_ratio_vs_bf16": round(
                self.bytes_for_pages(pages)
                / max(1, self.bf16_equiv_bytes(pages)), 4),
            "chunk_pages": self.chunk_pages,
            "ms": {"total": round(sum(walls), 3),
                   "p50": round(percentile(walls, 50), 3),
                   "mean": round(sum(walls) / len(walls), 3),
                   "n": len(walls)},
            "overlap": (round(ov, 4) if not math.isnan(ov)
                        else float("nan")),
            "overlapped_sends": sum(1 for r in self._sends
                                    if r.overlapped),
        }
