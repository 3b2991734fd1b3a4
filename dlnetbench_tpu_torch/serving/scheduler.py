"""Continuous-batching engine (the JAX package's ``serving/scheduler.py``,
classic one-token-per-step greedy engine).

Requests arrive on an OPEN-LOOP schedule (``serving/arrivals.py``), are
admitted from the queue into free decode slots whenever pages for their
worst case (prompt + output) can be reserved, prefill either at admit
time (``separate``) or one chunk per engine step (``inline``), decode
one token per active slot per step over the paged KV cache, and leave
on completion.  The host reads every step's next tokens back — that
read is the step's fence, as in the JAX engine, and the engine adds no
other synchronisation.

With the flight recorder on (``metrics/telemetry.py``) every engine
step is a ring sample (``step_wall_us``, ``queue_depth``,
``active_slots``, ``kv_occupancy``, ``kv_fragmentation``) that feeds the
step-time detector and the rolling SLO check (``trigger("slo")``); with
it off the step reads no clock for it and allocates nothing.  On a
traced run the engine build, the warmup requests and the measured run
are the spans ``build``, ``warmup`` and ``serving_run``.

Outside this slice, and refused with a ``ValueError`` naming ROADMAP.md:
fused multi-step decode, speculative decode, sampling, grammars, MoE
models, KV sharding, several capacity ranks, disaggregation, prefix
sharing and fault plans.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from dlnetbench_tpu_torch.metrics import spans, telemetry
from dlnetbench_tpu_torch.models.transformer import (TransformerConfig,
                                                     init_params)
from dlnetbench_tpu_torch.ops.common import resolve_device
from dlnetbench_tpu_torch.serving import decode as D
from dlnetbench_tpu_torch.serving import metrics as M
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan, Request
from dlnetbench_tpu_torch.serving.kv_cache import (CACHE_DTYPES,
                                                   CacheConfig,
                                                   PagedKVCache,
                                                   device_buffers)

PREFILL_MODES = ("separate", "inline")

# decode-step dispatches made by every Engine in this process (reset by
# the caller; each dispatch launches the decode attention kernel once
# per layer)
decode_dispatches = 0


def _not_ported(what: str) -> ValueError:
    return ValueError(f"serving: {what} is not ported to the torch "
                      f"package yet (ROADMAP.md queue 1)")


@dataclasses.dataclass
class ServingConfig:
    """Engine knobs.  The first block is the slice; the rest are the JAX
    package's knobs outside it, kept so that a config asking for one
    fails loudly instead of being ignored."""
    slots: int = 4              # decode slots = max continuous batch
    page_size: int = 8          # tokens per KV page
    num_pages: int = 64         # physical pages shared by all slots
    max_seq_len: int = 64       # per-request cap (prompt + output)
    prefill: str = "separate"   # "separate" (drain at admit) | "inline"
    prefill_chunk: int = 16     # prompt tokens per prefill call
    slo_ttft_ms: float = 500.0
    slo_tpot_ms: float = 200.0
    cache_dtype: str = "bf16"   # "bf16" (pools in the model dtype) |
    #                             "int8" | "fp8" (quantized pages)
    warmup_requests: int = 8    # synthetic requests run (and discarded)
    #                             before the measured run
    world: int = 1
    kv_shard: int = 1
    multi_step_n: int = 1
    speculative: bool = False
    temperature: float = 0.0
    grammar: str = ""
    prefix_sharing: bool = False
    disaggregate: bool = False

    def validate(self) -> "ServingConfig":
        if self.prefill not in PREFILL_MODES:
            raise ValueError(f"serving: prefill must be one of "
                             f"{PREFILL_MODES}, got {self.prefill!r}")
        for name in ("slots", "page_size", "num_pages", "max_seq_len",
                     "prefill_chunk"):
            if getattr(self, name) < 1:
                raise ValueError(f"serving: {name} must be >= 1")
        if self.max_seq_len % self.page_size:
            raise ValueError("serving: max_seq_len must be a multiple "
                             "of page_size (block tables are "
                             "page-granular)")
        if self.num_pages < self.max_seq_len // self.page_size:
            raise ValueError(
                f"serving: num_pages {self.num_pages} cannot hold even "
                f"one max_seq_len request "
                f"({self.max_seq_len // self.page_size} pages) — the "
                f"admission gate would starve the queue head forever")
        if self.cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"serving: unknown cache_dtype "
                             f"{self.cache_dtype!r} (one of "
                             f"{CACHE_DTYPES})")
        if self.multi_step_n < 1:
            raise ValueError(f"serving: multi_step_n must be >= 1, got "
                             f"{self.multi_step_n}")
        if self.multi_step_n > 1:
            raise _not_ported("multi_step_n > 1 (the fused decode loop)")
        if self.speculative:
            raise _not_ported("speculative decode")
        if self.temperature > 0 or self.grammar:
            raise _not_ported("sampling (temperature > 0) and grammars")
        if self.world != 1:
            raise _not_ported("world > 1 (capacity ranks)")
        if self.kv_shard != 1:
            raise _not_ported("kv_shard > 1")
        if self.disaggregate:
            raise _not_ported("disaggregated prefill/decode")
        if self.prefix_sharing:
            raise _not_ported("prefix sharing")
        return self


class _SlotState:
    """One in-flight request's host-side state."""

    def __init__(self, req: Request, admitted_s: float):
        self.req = req
        self.admitted_s = admitted_s
        self.prompt = None          # np [prompt_len] int32
        self.prefill_done = 0       # prompt tokens already cached
        self.generated = 0
        self.last_token = 0
        self.first_token_s: float | None = None


class Engine:
    """One serving engine over a fixed slot/page capacity on one device.

    ``device`` is ``"cuda"`` (the default; raises without a card) or
    ``"cpu"``; on the card the decode attention runs the Hopper kernels
    K1/K2, on the CPU their plain versions."""

    def __init__(self, model_cfg: TransformerConfig, cfg: ServingConfig,
                 *, params=None, device="cuda"):
        self.model_cfg = D.check_config(model_cfg)
        self.cfg = cfg.validate()
        self.device = (device if isinstance(device, torch.device)
                       else resolve_device(device))
        self.cache_cfg = CacheConfig(
            num_layers=model_cfg.num_layers,
            num_kv_heads=model_cfg.num_kv_heads,
            head_dim=model_cfg.head_dim,
            num_pages=cfg.num_pages, page_size=cfg.page_size,
            max_seqs=cfg.slots,
            max_pages_per_seq=cfg.max_seq_len // cfg.page_size,
            dtype=model_cfg.dtype, cache_dtype=cfg.cache_dtype)
        with spans.span("build", what="serving engine"):
            self.params = (params if params is not None
                           else init_params(model_cfg, seed=0,
                                            device=self.device))
            self._decode = D.make_decode_step(model_cfg, self.cache_cfg)
            self._prefill = D.make_prefill_chunk(model_cfg, self.cache_cfg,
                                                 cfg.prefill_chunk)
        self._reset_state()

    def _reset_state(self):
        self.cache = PagedKVCache(self.cache_cfg)
        self.pools = device_buffers(self.cache_cfg, self.device)
        self.slots: list[_SlotState | None] = [None] * self.cfg.slots
        self.completed: list[M.Completed] = []
        self.queue: deque[Request] = deque()
        self.pending: list[Request] = []
        self.engine_steps = 0
        self.queue_depth_max = 0
        self.concurrent_peak = 0
        self._occupancy_samples: list[int] = []
        self._prompt_memo: dict[int, np.ndarray] = {}
        self.token_streams: dict[int, list[int]] = {}
        self._host_dispatch_us: list[float] = []
        self._dispatches = 0
        self._device_time_s = 0.0    # every program call, prefill too
        self._decode_device_s = 0.0  # decode dispatches only
        self._tokens_emitted = 0
        # the flight recorder of this run (None, the default, keeps the
        # step allocation-free); a new run is a new step-time baseline
        self._tele = telemetry.current()
        if self._tele is not None:
            self._tele.reset_walls("serving")

    # ---- the loop ----------------------------------------------------
    def run(self, requests: list[Request]
            ) -> tuple[list[M.Completed], float]:
        """Drive the engine until every request completes; returns
        ``(completed, wall_s)``."""
        self._reset_state()
        for r in requests:
            if r.prompt_len + r.output_len > self.cfg.max_seq_len:
                raise ValueError(
                    f"serving: request {r.rid} needs "
                    f"{r.prompt_len + r.output_len} tokens > max_seq_len "
                    f"{self.cfg.max_seq_len}")
        self.queue = deque(sorted(requests, key=lambda r: r.arrival_s))
        self._t0 = time.monotonic()
        while self.queue or self.pending or any(
                s is not None for s in self.slots):
            self._admit_arrivals(self._now())
            if not any(s is not None for s in self.slots) \
                    and not self.pending:
                # idle: sleep to the next arrival (open loop)
                if self.queue:
                    dt = self.queue[0].arrival_s - self._now()
                    if dt > 0:
                        time.sleep(dt)
                continue
            self._step()
        return self.completed, self._now()

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a stream sync: through
        pinned memory (the caching host allocator keeps the block until
        the copy has run) and a non-blocking copy."""
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _admit_arrivals(self, now: float) -> None:
        while self.queue and self.queue[0].arrival_s <= now:
            self.pending.append(self.queue.popleft())
        self.queue_depth_max = max(self.queue_depth_max,
                                   len(self.pending))
        for i in range(self.cfg.slots):
            if not self.pending:
                break
            if self.slots[i] is not None:
                continue
            req = self.pending[0]
            # reserve the WORST CASE (prompt + output) so a running
            # sequence never runs out of pages mid-decode
            if not self.cache.can_fit(req.prompt_len + req.output_len):
                break  # FIFO: never starve the head
            self.pending.pop(0)
            self.cache.allocate(i, req.prompt_len + req.output_len)
            st = _SlotState(req, admitted_s=self._now())
            st.prompt = self._prompt_of(req)
            self.slots[i] = st
            self.concurrent_peak = max(
                self.concurrent_peak,
                sum(1 for s in self.slots if s is not None))
            if self.cfg.prefill == "separate":
                while self.slots[i] is not None \
                        and st.prefill_done < req.prompt_len:
                    self._prefill_one(i, st)

    def _prompt_of(self, req: Request) -> np.ndarray:
        toks = self._prompt_memo.get(req.rid)
        if toks is None:
            toks = D.prompt_tokens_for(req, self.model_cfg.vocab_size)
            self._prompt_memo[req.rid] = toks
        return toks

    def _prefill_one(self, slot: int, st: _SlotState) -> float:
        """One prefill chunk; returns its program-call wall seconds.
        Only the chunk completing the prompt reads back (its token is
        the request's first — the TTFT stamp)."""
        c = self.cfg.prefill_chunk
        start = st.prefill_done
        n = min(c, st.req.prompt_len - start)
        chunk_np = np.zeros((c,), np.int32)
        chunk_np[:n] = st.prompt[start:start + n]
        chunk = self._to_device(chunk_np)
        row = self._to_device(self.cache.block_tables[slot].copy())
        t0 = time.perf_counter()
        *self.pools, nxt = self._prefill(self.params, *self.pools, chunk,
                                         start, n, row)
        st.prefill_done += n
        self.cache.append(slot, n)
        if st.prefill_done >= st.req.prompt_len:
            st.last_token = int(nxt)        # the fence
            dev_s = time.perf_counter() - t0
            st.generated = 1
            st.first_token_s = self._now()
            self.token_streams.setdefault(st.req.rid, []).append(
                st.last_token)
            self._maybe_finish(slot, st)
        else:
            dev_s = time.perf_counter() - t0
        self._device_time_s += dev_s
        return dev_s

    def _step(self) -> None:
        """One engine step (``_step_once``), sampled into the flight
        ring when telemetry is on."""
        if self._tele is None:
            self._step_once()
            return
        t0 = time.perf_counter()
        self._step_once()
        self._sample_step((time.perf_counter() - t0) * 1e6)

    def _sample_step(self, wall_us: float) -> None:
        """One flight-ring sample per engine step: queue depth, active
        slots, KV occupancy and fragmentation beside the step wall; the
        step-time detector and the rolling SLO-breach check."""
        tele, now, step = self._tele, self._now(), self.engine_steps
        cs = self.cache.stats()
        tele.record("serving", step=step, phase="engine_step",
                    step_wall_us=round(wall_us, 1),
                    queue_depth=len(self.pending),
                    active_slots=sum(1 for s in self.slots
                                     if s is not None),
                    kv_occupancy=cs["occupancy"],
                    kv_fragmentation=cs["fragmentation"])
        tele.observe_step_wall("serving", wall_us, step=step)
        # a bounded tail: completions append in finish order, so the
        # trailing window is a suffix
        breach = M.rolling_slo_breach(
            self.completed[-64:], slo_ttft_ms=self.cfg.slo_ttft_ms,
            slo_tpot_ms=self.cfg.slo_tpot_ms, now_s=now)
        if breach is not None:
            tele.trigger("slo", step=step, detail={
                **breach, "slo": {"ttft_ms": self.cfg.slo_ttft_ms,
                                  "tpot_ms": self.cfg.slo_tpot_ms}})

    def _step_once(self) -> None:
        """One engine step: inline prefill chunks first (one per
        prefilling slot), then one decode token per active slot.
        ``host_dispatch_us`` records the step wall minus the program
        calls' wall."""
        global decode_dispatches
        t_step = time.perf_counter()
        dev_s = 0.0
        for i, st in enumerate(self.slots):
            if st is not None and st.prefill_done < st.req.prompt_len:
                dev_s += self._prefill_one(i, st)
        decode_ix = [i for i, st in enumerate(self.slots)
                     if st is not None
                     and st.prefill_done >= st.req.prompt_len]
        self._occupancy_samples.append(len(decode_ix))
        self.engine_steps += 1
        if not decode_ix:
            return
        b = self.cfg.slots
        tokens = np.zeros((b,), np.int32)
        positions = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        for i in decode_ix:
            tokens[i] = self.slots[i].last_token
            positions[i] = int(self.cache.lengths[i])
            active[i] = True
        t0 = time.perf_counter()
        *self.pools, nxt = self._decode(
            self.params, *self.pools, self._to_device(tokens),
            self._to_device(positions),
            self._to_device(self.cache.block_tables.copy()),
            self._to_device(active))
        decode_dispatches += 1
        nxt = nxt.cpu().numpy()             # the fence
        leg = time.perf_counter() - t0
        dev_s += leg
        self._device_time_s += leg
        self._decode_device_s += leg
        self._dispatches += 1
        for i in decode_ix:
            st = self.slots[i]
            self.cache.append(i)            # the fed token is now cached
            st.last_token = int(nxt[i])
            st.generated += 1
            self._tokens_emitted += 1
            self.token_streams.setdefault(st.req.rid, []).append(
                st.last_token)
            self._maybe_finish(i, st)
        self._host_dispatch_us.append(
            max(0.0, time.perf_counter() - t_step - dev_s) * 1e6)

    def _maybe_finish(self, slot: int, st: _SlotState) -> None:
        if st.generated < st.req.output_len:
            return
        self.completed.append(M.Completed(
            rid=st.req.rid, arrival_s=st.req.arrival_s,
            admitted_s=st.admitted_s, first_token_s=st.first_token_s,
            finish_s=self._now(), prompt_len=st.req.prompt_len,
            output_len=st.req.output_len))
        self.cache.free(slot)
        self.slots[slot] = None

    # ---- record assembly ---------------------------------------------
    def batch_occupancy_mean(self) -> float:
        if not self._occupancy_samples:
            return 0.0
        return sum(self._occupancy_samples) / len(self._occupancy_samples)

    def decode_loop_block(self) -> dict:
        """The dispatch decomposition (one device step per dispatch in
        this engine)."""
        d = self._dispatches
        hd = self._host_dispatch_us
        return {
            "multi_step_n": 1,
            "adaptive_n": True,
            "speculative": False,
            "dispatches": d,
            "device_steps": d,
            "steps_per_dispatch": 1.0 if d else 0.0,
            "tokens_per_sync": (round(self._tokens_emitted / d, 3)
                                if d else 0.0),
            "device_us": {"total": round(self._device_time_s * 1e6, 1)},
            "decode_device_us": {
                "total": round(self._decode_device_s * 1e6, 1)},
            "host_dispatch_us": {
                "total": round(sum(hd), 1),
                "p50": round(M.percentile(hd, 50), 1) if hd else 0.0,
                "mean": round(sum(hd) / len(hd), 1) if hd else 0.0,
                "n": len(hd)},
        }

    def mesh_info(self) -> dict:
        """The record's one-device mesh header."""
        on_gpu = self.device.type == "cuda"
        return {
            "axes": {"devices": 1},
            "num_devices": 1,
            "platform": "gpu" if on_gpu else "cpu",
            "device_kind": (torch.cuda.get_device_name(self.device)
                            if on_gpu else "cpu"),
            "num_hosts": 1,
            "fabric": "real",
            "devices": [{"id": self.device.index or 0, "process": 0}],
        }

    def global_meta(self, plan: ArrivalPlan) -> dict:
        cfg, mc = self.cfg, self.model_cfg
        return {
            "proxy": "serving",
            "framework": "torch",
            "model": (f"decode_d{mc.embed_dim}_l{mc.num_layers}"
                      f"_h{mc.num_heads}kv{mc.num_kv_heads}"
                      f"_v{mc.vocab_size}"),
            "world_size": 1,
            "arrival_plan": plan.to_dict(),
            "kv_cache_dtype": cfg.cache_dtype,
            "serving_config": {
                "slots": cfg.slots, "page_size": cfg.page_size,
                "num_pages": cfg.num_pages,
                "max_seq_len": cfg.max_seq_len,
                "pool_bytes": self.cache_cfg.pool_bytes,
                "cache_dtype": cfg.cache_dtype,
                "prefix_sharing": False,
                "prefill": cfg.prefill,
                "prefill_chunk": cfg.prefill_chunk,
                "kv_shard": 1,
                "multi_step_n": 1,
                "adaptive_n": True,
                "speculative": False,
            },
            "mesh": self.mesh_info(),
        }


def run_serving(model_cfg: TransformerConfig, cfg: ServingConfig,
                plan: ArrivalPlan, *, params=None, device="cuda",
                engine: Engine | None = None, fault_plan=None):
    """One measured serving run -> ``ProxyResult`` (-> ``metrics.emit``).

    ``cfg.warmup_requests`` synthetic requests run first and are
    discarded.  Pass ``engine`` to keep a handle on the engine (its
    ``token_streams`` after the run are the measured run's)."""
    if fault_plan is not None:
        raise _not_ported("fault composition (fault plans)")
    if engine is None:
        engine = Engine(model_cfg, cfg, params=params, device=device)
    requests = plan.sample()
    if cfg.warmup_requests > 0:
        p_len = min(cfg.prefill_chunk + 1, cfg.max_seq_len - 2)
        with spans.span("warmup", what="serving engine",
                        reps=cfg.warmup_requests):
            engine.run([Request(rid=-1 - i, arrival_s=0.0,
                                prompt_len=p_len, output_len=2)
                        for i in range(cfg.warmup_requests)])
    meta = engine.global_meta(plan)
    with spans.span("serving_run", requests=len(requests)):
        completed, wall = engine.run(requests)
    meta["serving"] = M.serving_block(
        completed, plan, slo_ttft_ms=cfg.slo_ttft_ms,
        slo_tpot_ms=cfg.slo_tpot_ms, wall_s=wall,
        engine_steps=engine.engine_steps,
        cache_stats=engine.cache.stats(),
        queue_depth_max=engine.queue_depth_max,
        batch_occupancy_mean=engine.batch_occupancy_mean(),
        decode_loop=engine.decode_loop_block(),
        admitted_peak=engine.concurrent_peak)
    return M.build_result(completed, plan, meta)
