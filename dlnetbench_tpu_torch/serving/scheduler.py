"""Continuous-batching engine (the JAX package's ``serving/scheduler.py``).

Requests arrive on an OPEN-LOOP schedule (``serving/arrivals.py``), are
admitted from the queue into free decode slots whenever pages for their
worst case (prompt + output) can be reserved, prefill either at admit
time (``separate``) or one chunk per engine step (``inline``), decode
over the paged KV cache, and leave on completion.

Two decode paths, as in the JAX engine:

* ``multi_step_n == 1`` without speculation — the classic engine: one
  dispatch per token, the step's tokens read back at its end (the
  step's fence).  The loop program is not even built.
* otherwise — the fused path: slot state lives on the device between
  syncs (``serving/device_state.py``), and one dispatch issues up to N
  decode steps (``decode.make_multi_step_decode``) or N draft/verify
  rounds (``speculative.make_spec_decode_loop``) with no host read or
  upload between them.  The host syncs at admission boundaries and
  reads each dispatch's token block once, every crossing a recorded
  timer.  ``adaptive_n`` caps N so the loop never starves a waiting
  request (``_pick_n_steps``), and the host, which knows each slot's
  remaining budget, never issues a trip past the longest of them.

``temperature > 0`` or a ``grammar`` builds a ``sampling.DeviceSampler``
shared by every program: draws are keyed by (sample_seed, request id,
stream position), so the 1-step and N-step engines emit the same
sampled tokens position by position, and the speculative engine (its
rejection sampling draws on other lanes) the same distribution.

With ``prefix_sharing`` a request whose prompt shares a prefix with a
resident, fully prefilled sequence is admitted onto the same physical
pages (``kv_cache.PagedKVCache.plan_admission`` / ``admit``): only its
unshared pages are charged, a partly shared boundary page is copied
into a private page at admission (``_cow_copy``, never inside a decode
dispatch), its prefill resumes at the shared length, and its prompt
pages are published once its prompt is cached.  A MoE model decodes
through ``serving/moe_decode.py`` (its seeded skew bias built once with
the engine); its per-expert load and overflow rounds ride the record's
``moe`` block and the flight ring.

With the flight recorder on (``metrics/telemetry.py``) every engine
step is a ring sample (``step_wall_us``, ``queue_depth``,
``active_slots``, ``kv_occupancy``, ``kv_fragmentation``, and where
they apply ``prefix_hit_rate``, ``moe_rounds`` / ``moe_imbalance``, and
on the fused path ``sync_us`` and the speculative acceptance) that
feeds the step-time detector and the rolling SLO check
(``trigger("slo")``); with it off, and no live-metrics stream attached
(``Engine.live``, a ``metrics.LiveMetricsWriter``), the step reads no
clock for it and allocates nothing.  On a traced run the engine build,
the warmup requests and the measured run are the spans ``build``,
``warmup`` and ``serving_run``.

Serving at scale is one process over an explicit device list
(``devices=``, the JAX package's single controller): the default is
``cuda:0 .. cuda:n-1``, too few devices fail with the JAX package's
message, and a list may name one device more than once (``[cpu, cpu]``
here, ``[cuda:0, cuda:0]`` on one card; the record's ``mesh`` header
lists them as given).  ``world`` capacity ranks split the slots evenly
(the fault-shrink unit); the engine computes on ``devices[0]``.  With
``kv_shard > 1`` the page pools are split along the KV heads over
``devices[:kv_shard]`` (``kv_cache.HeadShards``) and K1/K2 run once a
shard.  A step is split at the dispatch boundary
(``_step_dispatch`` launches the decode program and reads nothing back;
``_step_complete`` fences its outputs and does the host bookkeeping),
the window the disaggregated and fleet servers
(``serving/disagg.py``, ``serving/fleet.py``) run other devices' work
in.  ``run_serving`` takes the training tier's fault plans: delays and
jitter at engine-step boundaries, a crash or preemption under
``fail_fast`` propagates, and under ``shrink`` the engine is rebuilt
over the surviving ranks' slot share with the leftovers re-queued on
the first segment's clock (``serving/requeue.py``).
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
from dlnetbench_tpu_torch.serving import requeue
from dlnetbench_tpu_torch.serving import sampling as SMP
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan, Request
from dlnetbench_tpu_torch.serving.kv_cache import (ATTN_IMPLS, CACHE_DTYPES,
                                                   CacheConfig,
                                                   PagedKVCache, copy_page,
                                                   device_buffers,
                                                   sharded_buffers)

PREFILL_MODES = ("separate", "inline")

# decode dispatches made by every Engine in this process, and the device
# steps (fused trips, draft/verify rounds) they issued; reset by the
# caller.  A classic dispatch is one step and launches the decode
# attention kernel once per layer; a fused dispatch of n trips launches
# it n x layers times; a speculative round launches it spec_k x
# drafter_layers times for the truncated drafter and never in the
# verify pass (gather math over every fed position); nothing launches
# it under attn_impl="gather"
decode_dispatches = 0
decode_device_steps = 0


def normalize_device(device) -> torch.device:
    """An indexed ``torch.device``: a bare ``cuda`` names the current
    card (``cuda:0`` unless the caller moved it), so per-device caches
    never mix two cards under one key."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def resolve_devices(devices=None, device=None, need: int = 1) -> list:
    """The device list an entry point runs over: ``devices`` as given
    (repeats allowed), else ``[device]``, else ``cuda:0 .. cuda:k-1``
    for the first ``need`` cards there are (an error without a card).
    Every entry is normalized (``normalize_device``); the caller checks
    the count against its world with the JAX package's message."""
    if devices is not None:
        return [normalize_device(d) for d in devices]
    if device is not None:
        return [normalize_device(device if isinstance(device, torch.device)
                                 else resolve_device(device))]
    resolve_device("cuda")
    return [torch.device("cuda", i)
            for i in range(min(need, torch.cuda.device_count()))]


def tree_to(tree, device):
    """A parameter tree (dicts and lists of tensors) on ``device``; a
    tensor already there is kept, not copied."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


@dataclasses.dataclass
class ServingConfig:
    """Engine knobs, with the JAX package's names, defaults and checks."""
    slots: int = 4              # decode slots = max continuous batch
    page_size: int = 8          # tokens per KV page
    num_pages: int = 64         # physical pages shared by all slots
    max_seq_len: int = 64       # per-request cap (prompt + output)
    prefill: str = "separate"   # "separate" (drain at admit) | "inline"
    prefill_chunk: int = 16     # prompt tokens per prefill call
    slo_ttft_ms: float = 500.0
    slo_tpot_ms: float = 200.0
    attn_impl: str = "auto"     # kv_cache.paged_attention_decode impl:
    #                             "auto" (K1/K2 on a card, the plain
    #                             gather on the CPU) | "gather"
    multi_step_n: int = 1       # decode steps fused per dispatch; 1 =
    #                             the classic engine (no loop built)
    adaptive_n: bool = True     # cap N by the shortest remaining output
    #                             while work waits, and by the measured
    #                             steps until the next arrival
    speculative: bool = False   # self-drafting speculative decode in
    #                             the fused loop
    spec_k: int = 4             # draft tokens per verify round
    drafter: str = "ngram"      # "ngram" | "truncated"
    drafter_layers: int = 1     # truncated drafter depth (< num_layers)
    temperature: float = 0.0    # 0 = greedy (no sampler built)
    top_k: int = 0              # keep the k highest logits (0 = off)
    top_p: float = 1.0          # nucleus cutoff in (0, 1]; 1.0 = off
    sample_seed: int = 0        # the draw-key seed (run identity)
    grammar: str = ""           # "" | "json" (masked decode)
    cache_dtype: str = "bf16"   # "bf16" (pools in the model dtype) |
    #                             "int8" | "fp8" (quantized pages)
    prefix_sharing: bool = False  # map a shared prompt prefix onto a
    #                             resident sequence's pages (refcounts,
    #                             copy-on-write at the divergence page)
    moe_skew: float = 0.0       # seeded router-logit skew of a MoE
    #                             model's serving MLP (0 = no bias)
    moe_skew_seed: int = 0      # which experts the skew favors
    warmup_requests: int = 8    # synthetic requests run (and discarded)
    #                             before the measured run
    world: int = 1              # capacity ranks (the fault-shrink unit:
    #                             slots split evenly, a crashed rank
    #                             takes its share down)
    kv_shard: int = 1           # >1: pools split along the KV heads
    #                             over the first kv_shard devices
    disaggregate: bool = False  # a prefill replica and a decode replica
    #                             on disjoint devices (serving/disagg.py)
    prefill_ranks: int = 1      # disaggregate: ranks [0, prefill_ranks)
    decode_ranks: int = 1       # disaggregate: ranks [prefill_ranks, world)
    migration_chunk_pages: int = 8  # pages a migration chunk transfer

    def validate(self) -> "ServingConfig":
        if self.prefill not in PREFILL_MODES:
            raise ValueError(f"serving: prefill must be one of "
                             f"{PREFILL_MODES}, got {self.prefill!r}")
        for name in ("slots", "page_size", "num_pages", "max_seq_len",
                     "prefill_chunk", "world", "kv_shard"):
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
        if not self.disaggregate and self.slots % self.world:
            # disaggregate has its per-replica rule below
            raise ValueError("serving: slots must divide evenly across "
                             "world ranks (the fault-shrink unit)")
        if self.multi_step_n < 1:
            raise ValueError(f"serving: multi_step_n must be >= 1, "
                             f"got {self.multi_step_n}")
        if self.cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"serving: unknown cache_dtype "
                             f"{self.cache_dtype!r} (one of "
                             f"{CACHE_DTYPES})")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"serving: unknown attn_impl "
                             f"{self.attn_impl!r} (one of {ATTN_IMPLS})")
        if self.speculative and self.cache_dtype != "bf16":
            raise ValueError(
                f"serving: speculative decode supports the bf16 cache "
                f"only — cache_dtype={self.cache_dtype!r} re-quantizes "
                f"pages on every draft/verify overwrite and has no "
                f"stated parity bar (docs/SERVING.md 'Cache density')")
        SMP.check_sampling_config(
            temperature=self.temperature, top_k=self.top_k,
            top_p=self.top_p, sample_seed=self.sample_seed,
            grammar=self.grammar, speculative=self.speculative,
            drafter=self.drafter)
        if self.moe_skew < 0:
            raise ValueError(f"serving: moe_skew must be >= 0, got "
                             f"{self.moe_skew}")
        if self.speculative:
            from dlnetbench_tpu_torch.serving.speculative import DRAFTERS
            if self.spec_k < 1:
                raise ValueError(f"serving: spec_k must be >= 1, got "
                                 f"{self.spec_k}")
            if self.drafter not in DRAFTERS:
                raise ValueError(
                    f"serving: unknown drafter {self.drafter!r} "
                    f"(one of {DRAFTERS})")
        if self.disaggregate:
            if self.prefill_ranks < 1 or self.decode_ranks < 1:
                raise ValueError(
                    "serving: disaggregate needs prefill_ranks >= 1 "
                    "and decode_ranks >= 1 — each phase is a replica")
            if self.world != self.prefill_ranks + self.decode_ranks:
                raise ValueError(
                    f"serving: disaggregate splits world into disjoint "
                    f"replica meshes — world {self.world} must equal "
                    f"prefill_ranks {self.prefill_ranks} + decode_ranks "
                    f"{self.decode_ranks}")
            if self.slots % self.prefill_ranks \
                    or self.slots % self.decode_ranks:
                raise ValueError(
                    f"serving: disaggregate needs slots {self.slots} "
                    f"divisible by prefill_ranks {self.prefill_ranks} "
                    f"AND decode_ranks {self.decode_ranks} (each "
                    f"replica's fault-shrink unit is its own rank "
                    f"share)")
            if self.speculative:
                raise ValueError(
                    "serving: speculative + disaggregate is refused — "
                    "the draft/verify ngram state has no stated parity "
                    "story across a page migration")
            if self.prefix_sharing:
                raise ValueError(
                    "serving: prefix_sharing + disaggregate is refused "
                    "— refcounted shared pages live in ONE pool and "
                    "cannot migrate by reference across replicas")
            if self.kv_shard > 1:
                raise ValueError(
                    "serving: kv_shard + disaggregate is refused — the "
                    "migration channel moves single-device pools; a "
                    "sharded pool would need a per-shard wire")
            if self.prefill == "inline":
                raise ValueError(
                    "serving: disaggregate implies separate-phase "
                    "prefill (the prefill replica has no decode slots "
                    "to interleave with) — prefill='inline' is a "
                    "contradiction, not a knob setting")
            if self.migration_chunk_pages < 1:
                raise ValueError(
                    f"serving: migration_chunk_pages must be >= 1, "
                    f"got {self.migration_chunk_pages}")
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
        self.gstate = 0             # grammar state after the last token


class Engine:
    """One serving engine over a fixed slot/page capacity.

    ``devices`` is the engine's device list (``resolve_devices``: the
    first ``max(world, kv_shard)`` cards by default; ``device`` is the
    one-device shorthand, ``"cuda"`` or ``"cpu"``).  The programs run on
    ``devices[0]``; with ``kv_shard > 1`` the pools are split over
    ``devices[:kv_shard]``.  On a card the decode attention runs the
    Hopper kernels K1/K2 (unless ``attn_impl="gather"``), on the CPU
    their plain versions."""

    # a replica that never decodes (serving/disagg._PrefillReplica)
    # builds no decode program
    _decode_needed = True

    def __init__(self, model_cfg: TransformerConfig, cfg: ServingConfig,
                 *, params=None, device=None, devices=None):
        self.model_cfg = D.check_config(model_cfg)
        self.cfg = cfg.validate()
        if cfg.disaggregate:
            raise ValueError(
                "serving: a disaggregated config drives TWO engines — "
                "use serving/disagg.run_disagg, not Engine/run_serving")
        self.devices = resolve_devices(devices, device,
                                       max(cfg.world, cfg.kv_shard))
        if len(self.devices) < cfg.world:
            raise ValueError(
                f"serving: world {cfg.world} needs {cfg.world} devices, "
                f"have {len(self.devices)}")
        if cfg.kv_shard > 1:
            if model_cfg.num_kv_heads % cfg.kv_shard:
                raise ValueError(
                    f"serving: kv_shard {cfg.kv_shard} must divide "
                    f"num_kv_heads {model_cfg.num_kv_heads}")
            # the shards come from THIS engine's devices: a shrink
            # rebuild over the survivors never keeps a dead rank's
            if len(self.devices) < cfg.kv_shard:
                raise ValueError(
                    f"serving: kv_shard {cfg.kv_shard} needs "
                    f"{cfg.kv_shard} devices, engine has "
                    f"{len(self.devices)} — a shrunk world cannot keep "
                    f"the KV shard; lower kv_shard with it")
        self.device = self.devices[0]
        self.cache_cfg = CacheConfig(
            num_layers=model_cfg.num_layers,
            num_kv_heads=model_cfg.num_kv_heads,
            head_dim=model_cfg.head_dim,
            num_pages=cfg.num_pages, page_size=cfg.page_size,
            max_seqs=cfg.slots,
            max_pages_per_seq=cfg.max_seq_len // cfg.page_size,
            dtype=model_cfg.dtype, cache_dtype=cfg.cache_dtype)
        # the fused path: N steps (or rounds) per dispatch over slot
        # state on the device; the classic path builds no loop
        self._loop_mode = cfg.multi_step_n > 1 or cfg.speculative
        self._moe = model_cfg.num_experts > 1
        if self._moe and cfg.speculative:
            raise ValueError(
                "serving: speculative decode covers dense models only "
                "— the draft/verify overwrite cycle has no stated "
                "parity story through the MoE overflow rounds")
        self._moe_bias = None
        if self._moe:
            from dlnetbench_tpu_torch.serving.moe_decode import skew_bias
            self._moe_bias = skew_bias(model_cfg.num_experts, cfg.moe_skew,
                                       cfg.moe_skew_seed, self.device)
        # validate() ran the sampling checks
        scfg = SMP.SamplingConfig(
            temperature=cfg.temperature, top_k=cfg.top_k,
            top_p=cfg.top_p, sample_seed=cfg.sample_seed,
            grammar=cfg.grammar)
        self._sampler = (SMP.DeviceSampler(scfg, model_cfg.vocab_size,
                                           self.device)
                         if scfg.enabled else None)
        self._decode = self._loop = None
        with spans.span("build", what="serving engine"):
            self.params = (tree_to(params, self.device)
                           if params is not None
                           else init_params(model_cfg, seed=0,
                                            device=self.device))
            if cfg.speculative:
                # make_spec_decode_loop checks the knobs against the
                # model's shape
                from dlnetbench_tpu_torch.serving import speculative as SP
                self._loop = SP.make_spec_decode_loop(
                    model_cfg, self.cache_cfg, cfg.multi_step_n,
                    spec_k=cfg.spec_k, drafter=cfg.drafter,
                    drafter_layers=cfg.drafter_layers,
                    attn_impl=cfg.attn_impl, sampler=self._sampler)
            elif self._loop_mode:
                self._loop = D.make_multi_step_decode(
                    model_cfg, self.cache_cfg, cfg.multi_step_n,
                    attn_impl=cfg.attn_impl, moe_bias=self._moe_bias,
                    sampler=self._sampler)
            elif self._decode_needed:
                self._decode = D.make_decode_step(
                    model_cfg, self.cache_cfg, attn_impl=cfg.attn_impl,
                    moe_bias=self._moe_bias, sampler=self._sampler)
            self._prefill = D.make_prefill_chunk(
                model_cfg, self.cache_cfg, cfg.prefill_chunk,
                moe_bias=self._moe_bias, sampler=self._sampler)
        # the live windowed metrics stream (a metrics.LiveMetricsWriter
        # or None): it survives _reset_state, so a warm-up round and the
        # measured run share one stream
        self.live = None
        self._reset_state()

    def _reset_state(self):
        self.cache = PagedKVCache(self.cache_cfg)
        self.pools = (sharded_buffers(self.cache_cfg,
                                      self.devices[:self.cfg.kv_shard])
                      if self.cfg.kv_shard > 1
                      else device_buffers(self.cache_cfg, self.device))
        self.slots: list[_SlotState | None] = [None] * self.cfg.slots
        self.completed: list[M.Completed] = []
        self.queue: deque[Request] = deque()
        self.pending: list[Request] = []
        self.engine_steps = 0
        self.queue_depth_max = 0
        self.concurrent_peak = 0
        self._occupancy_samples: list[int] = []
        self._prompt_memo: dict[int, np.ndarray] = {}
        self.dstate = None
        if self._loop_mode:
            from dlnetbench_tpu_torch.serving.device_state import \
                DeviceDecodeState
            self.dstate = DeviceDecodeState(
                self.cfg.slots, self.cache_cfg.max_pages_per_seq,
                vocab=(self.model_cfg.vocab_size if self.cfg.speculative
                       else None), device=self.device)
        self.token_streams: dict[int, list[int]] = {}
        self._host_dispatch_us: list[float] = []
        self._dispatches = 0
        self._device_steps = 0       # steps (rounds) that had an active
        #                              slot: the JAX loop's trip counts
        self._idle_rounds = 0        # speculative rounds issued after
        #                              every slot was done
        self._device_time_s = 0.0    # every program call, prefill too
        self._decode_device_s = 0.0  # decode dispatches only
        self._tokens_emitted = 0
        self._drafted = 0
        self._accepted = 0
        self._step_ewma_s = 0.0      # measured seconds per device step
        # disaggregation: the engine-clock second the next migrated
        # sequence is expected (serving/disagg.py sets it); None, always
        # on a monolithic engine, leaves _pick_n_steps as it was
        self._migration_eta_s: float | None = None
        # MoE imbalance telemetry: per-expert routed-token totals, the
        # decode dispatches' round counts and the prefill chunks' apart
        # (their capacities differ), the last dispatch's snapshot for
        # the flight ring, and the prefill chunks' loads not yet read
        # (folded at the prompt-completing chunk's fence)
        self._moe_load = (np.zeros(self.model_cfg.num_experts, np.int64)
                          if self._moe else None)
        self._moe_rounds: list[int] = []
        self._moe_prefill_rounds: list[int] = []
        self._moe_pending: list[tuple] = []
        self._moe_last: dict = {}
        # the flight recorder of this run (None, the default, keeps the
        # step allocation-free); a new run is a new step-time baseline
        self._tele = telemetry.current()
        if self._tele is not None:
            self._tele.reset_walls("serving")
        if self.live is not None:
            self.live.reset_run()    # the engine clock restarts at 0

    # ---- the loop ----------------------------------------------------
    def run(self, requests: list[Request], *, injector=None,
            t_origin: float | None = None
            ) -> tuple[list[M.Completed], float]:
        """Drive the engine until every request completes; returns
        ``(completed, wall_s)``.  ``t_origin`` anchors the admission
        clock (a fault-segmented continuation passes the first
        segment's); ``injector`` (``faults.inject.FaultInjector``) runs
        before every engine step, and a scripted ``RankFailure`` /
        ``RankPreempted`` propagates with the progress kept on the
        engine (``drain_unfinished`` hands the leftovers on)."""
        self._reset_state()
        for r in requests:
            if r.prompt_len + r.output_len > self.cfg.max_seq_len:
                raise ValueError(
                    f"serving: request {r.rid} needs "
                    f"{r.prompt_len + r.output_len} tokens > max_seq_len "
                    f"{self.cfg.max_seq_len}")
        self.queue = deque(sorted(requests, key=lambda r: r.arrival_s))
        self._t0 = time.monotonic() if t_origin is None else t_origin
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
            if injector is not None:
                injector.before_step()  # faults land inside the loop
            self._step()
        return self.completed, self._now()

    def drain_unfinished(self) -> list[Request]:
        """Everything not completed, for a fault-segmented continuation:
        in-flight requests lose their decode progress (their cache dies
        with this engine) but keep their arrival stamps.  Slots and
        pages are freed."""
        leftovers = [s.req for s in self.slots if s is not None]
        if self._loop_mode and any(s is not None for s in self.slots):
            # the drain is a sync boundary: deactivate the in-flight
            # slots on the device too
            self.dstate.pull()
        for i, s in enumerate(self.slots):
            if s is not None:
                self.cache.free(i)
                self.slots[i] = None
                if self._loop_mode:
                    self.dstate.evict(i)
        leftovers += self.pending
        leftovers += list(self.queue)
        self.pending, self.queue = [], deque()
        return sorted(leftovers, key=lambda r: r.arrival_s)

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
            prompt = self._prompt_of(req)
            # reserve the WORST CASE (prompt + output) so a running
            # sequence never runs out of pages mid-decode; with prefix
            # sharing the plan charges only the unshared pages (the
            # divergence page's private copy included)
            plan = self.cache.plan_admission(
                self._admission_tokens(req),
                prompt if self.cfg.prefix_sharing else None)
            if plan.need_pages > self.cache.free_pages:
                break  # FIFO: never starve the head
            self.pending.pop(0)
            cow_dst = self.cache.admit(i, plan)
            if cow_dst is not None:
                # copy-on-write at the admission boundary: the shared
                # boundary page's rows land in the private page before
                # any prefill or decode write
                self._cow_copy(plan.cow_src, cow_dst)
            st = _SlotState(req, admitted_s=self._now())
            st.prompt = prompt
            # the shared prefix is cached: prefill resumes after it
            st.prefill_done = plan.shared_tokens
            self.slots[i] = st
            self.concurrent_peak = max(
                self.concurrent_peak,
                sum(1 for s in self.slots if s is not None))
            if self.cfg.prefill == "separate":
                while self.slots[i] is not None \
                        and st.prefill_done < req.prompt_len:
                    self._prefill_one(i, st)

    def _admission_tokens(self, req: Request) -> int:
        """Tokens to reserve pages for at admission: the worst case
        (prompt + output).  The disaggregated prefill replica reserves
        the prompt only (decode happens in the other replica's pool)."""
        return req.prompt_len + req.output_len

    def _prompt_of(self, req: Request) -> np.ndarray:
        """Request -> prompt tokens, memoized: a blocked queue head is
        planned again every engine step."""
        toks = self._prompt_memo.get(req.rid)
        if toks is None:
            toks = D.prompt_tokens_for(req, self.model_cfg.vocab_size)
            self._prompt_memo[req.rid] = toks
        return toks

    def _cow_copy(self, src: int, dst: int) -> None:
        """The admission-time copy-on-write: page ``src``'s rows (and on
        a quantized cache its scales) copied into page ``dst`` of every
        pool, in place, on the pools' stream."""
        copy_page(self.pools, src, dst)

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
        extra = () if self._sampler is None else (st.req.rid,)
        t0 = time.perf_counter()
        outs = self._prefill(self.params, *self.pools, chunk, start, n,
                             row, *extra)
        n_pools = len(self.pools)
        self.pools = list(outs[:n_pools])
        if self._moe:
            # the chunk's load stays on the device until the fence below
            nxt, load, rounds = outs[n_pools:]
            self._moe_pending.append((load, rounds))
        else:
            (nxt,) = outs[n_pools:]
        st.prefill_done += n
        self.cache.append(slot, n)
        if st.prefill_done >= st.req.prompt_len:
            st.last_token = int(nxt)        # the fence
            self._fold_moe_pending()
            dev_s = time.perf_counter() - t0
            st.generated = 1
            if self._sampler is not None:
                # the grammar state after the first token (the device
                # loop or the host picks up from here)
                st.gstate = self._sampler.host_advance(
                    self._sampler.start_state, st.last_token)
            st.first_token_s = self._now()
            self.token_streams.setdefault(st.req.rid, []).append(
                st.last_token)
            if self.cfg.prefix_sharing:
                # the prompt is cached: later arrivals may share it
                self.cache.publish(slot, st.prompt)
            self._maybe_finish(slot, st)
            if self.slots[slot] is st:
                self._activate_decode_slot(slot, st)
        else:
            dev_s = time.perf_counter() - t0
        self._device_time_s += dev_s
        return dev_s

    def _activate_decode_slot(self, slot: int, st: _SlotState) -> None:
        """Fused path: a slot finished prefill — seed its device-resident
        state (flushed, priced, at the next dispatch)."""
        if not self._loop_mode:
            return
        ds = self.dstate
        ds.pull()  # sync boundary: refresh before mutating (priced)
        ngram_row = None
        if ds.ngram_table is not None:
            from dlnetbench_tpu_torch.serving.speculative import \
                seed_ngram_row
            ngram_row = seed_ngram_row(st.prompt, st.last_token,
                                       self.model_cfg.vocab_size)
        ds.admit(slot, last_token=st.last_token,
                 position=int(self.cache.lengths[slot]),
                 remaining=st.req.output_len - st.generated,
                 seq_limit=st.req.prompt_len + st.req.output_len,
                 block_row=self.cache.block_tables[slot],
                 ngram_row=ngram_row, uid=st.req.rid,
                 grammar_state=st.gstate)

    def admit_prefilled(self, req: Request, *, last_token: int,
                        admitted_s: float, first_token_s: float,
                        generated: int, pending_send, channel) -> bool:
        """Disaggregation: admit a sequence whose prompt was prefilled on
        the other replica.  Reserves the worst case like any admission,
        rebuilds the lengths and block table to the monolithic
        post-prefill state (``lengths = prompt_len``; the first
        generated token is not cached — decode writes it at position
        prompt_len, as after ``_prefill_one``), lands the migrated pages
        in this pool's allocation (``channel.scatter``, ordered after
        their arrival on the device) and seeds the decode slot.  The
        stamps travel with the sequence.  False when no slot or pages
        are free (the server retries at the next boundary)."""
        slot = next((i for i, s in enumerate(self.slots) if s is None),
                    None)
        if slot is None:
            return False
        plan = self.cache.plan_admission(req.prompt_len + req.output_len)
        if plan.need_pages > self.cache.free_pages:
            return False
        self.cache.admit(slot, plan)
        self.cache.append(slot, req.prompt_len)
        s = self.cfg.page_size
        n_pages = (req.prompt_len + s - 1) // s
        dst_ids = self.cache.block_tables[slot][:n_pages]
        self.pools = channel.scatter(self.pools, pending_send, dst_ids)
        st = _SlotState(req, admitted_s=admitted_s)
        st.prompt = self._prompt_of(req)
        st.prefill_done = req.prompt_len
        st.generated = generated
        st.last_token = last_token
        st.first_token_s = first_token_s
        if self._sampler is not None:
            # the handoff is at the first-token boundary: the automaton
            # has consumed exactly the first token
            st.gstate = self._sampler.host_advance(
                self._sampler.start_state, st.last_token)
        self.slots[slot] = st
        self.concurrent_peak = max(
            self.concurrent_peak,
            sum(1 for s_ in self.slots if s_ is not None))
        self._maybe_finish(slot, st)
        if self.slots[slot] is st:
            self._activate_decode_slot(slot, st)
        return True

    def _step(self) -> None:
        """One engine step (``_step_dispatch`` then ``_step_complete``),
        sampled into the flight ring when telemetry is on and into the
        live stream when one is attached."""
        if self._tele is None and self.live is None:
            self._step_complete(self._step_dispatch())
            return
        t0 = time.perf_counter()
        sync0 = (self.dstate.sync_total_us() if self.dstate is not None
                 else 0.0)
        self._step_complete(self._step_dispatch())
        self._sample_step((time.perf_counter() - t0) * 1e6, sync0)

    def _sample_step(self, wall_us: float, sync0: float) -> None:
        """One flight-ring sample per engine step: queue depth, active
        slots, KV occupancy and fragmentation beside the step wall (and
        the prefix hit rate, the last dispatch's MoE rounds and
        imbalance, on the fused path the step's sync time and the
        speculative acceptance); the step-time detector and the rolling
        SLO-breach check.  Then the live stream's window check."""
        tele, now, step = self._tele, self._now(), self.engine_steps
        if tele is not None:
            cs = self.cache.stats()
            fields = {"step_wall_us": round(wall_us, 1),
                      "queue_depth": len(self.pending),
                      "active_slots": sum(1 for s in self.slots
                                          if s is not None),
                      "kv_occupancy": cs["occupancy"],
                      "kv_fragmentation": cs["fragmentation"]}
            prefix = cs.get("prefix")
            if prefix:
                fields["prefix_hit_rate"] = prefix["hit_rate"]
            if self.cfg.speculative and self._drafted:
                fields["spec_acceptance"] = round(
                    self._accepted / self._drafted, 4)
            if self._moe and self._moe_last:
                fields.update(self._moe_last)
            if self.dstate is not None:
                fields["sync_us"] = round(
                    self.dstate.sync_total_us() - sync0, 1)
            tele.record("serving", step=step, phase="engine_step",
                        **fields)
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
        if self.live is not None:
            self.live.maybe_emit(self, now)

    # ---- the dispatch / complete split ------------------------------
    # A step is split at the dispatch boundary: _step_dispatch runs the
    # inline prefill chunks, marshals the inputs and launches the decode
    # program without reading anything back; _step_complete reads its
    # outputs (the step's one fence) and does the host bookkeeping.  The
    # monolithic engine calls them back to back; the disaggregated and
    # fleet servers run other devices' work between them.

    def _step_dispatch(self) -> dict | None:
        """Preamble and launch, no fence.  Returns the in-flight step's
        context for ``_step_complete``, or None when no slot is in the
        decode phase (nothing was launched).  ``host_dispatch_us``
        records the step wall minus the program calls' wall (and, fused,
        minus the priced syncs)."""
        t_step = time.perf_counter()
        sync0 = (self.dstate.sync_total_us() if self.dstate is not None
                 else 0.0)
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
            return None
        ctx = (self._dispatch_fused(decode_ix) if self._loop_mode
               else self._dispatch_single(decode_ix))
        ctx.update(t_step=t_step, dev_s=dev_s, sync0=sync0)
        return ctx

    def _step_complete(self, ctx: dict | None) -> float:
        """Fence a dispatched step and run its host bookkeeping; returns
        the decode leg's seconds (dispatch to fence)."""
        if ctx is None:
            return 0.0
        if ctx["fused"]:
            return self._complete_fused(ctx)
        return self._complete_single(ctx)

    def _dispatch_single(self, decode_ix: list[int]) -> dict:
        global decode_dispatches, decode_device_steps
        b = self.cfg.slots
        tokens = np.zeros((b,), np.int32)
        positions = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        for i in decode_ix:
            tokens[i] = self.slots[i].last_token
            positions[i] = int(self.cache.lengths[i])
            active[i] = True
        extra = ()
        if self._sampler is not None:
            uids = np.zeros((b,), np.int32)
            gst = np.zeros((b,), np.int32)
            for i in decode_ix:
                uids[i] = self.slots[i].req.rid
                gst[i] = self.slots[i].gstate
            extra = (self._to_device(uids), self._to_device(gst))
        t0 = time.perf_counter()
        outs = self._decode(
            self.params, *self.pools, self._to_device(tokens),
            self._to_device(positions),
            self._to_device(self.cache.block_tables.copy()),
            self._to_device(active), *extra)
        n_pools = len(self.pools)
        self.pools = tuple(outs[:n_pools])
        decode_dispatches += 1
        decode_device_steps += 1
        return {"fused": False, "t0": t0, "decode_ix": decode_ix,
                "rest": outs[n_pools:]}

    def _complete_single(self, ctx: dict) -> float:
        b = self.cfg.slots
        decode_ix, dev_s = ctx["decode_ix"], ctx["dev_s"]
        if self._moe:
            nxt, load, rounds = ctx["rest"]
            # one read is the fence: the tokens and the step's load
            flat = torch.cat([nxt, load]).cpu().numpy()
            nxt = flat[:b]
            self._record_moe(flat[b:], rounds)
        else:
            (nxt,) = ctx["rest"]
            nxt = nxt.cpu().numpy()         # the fence
        leg = time.perf_counter() - ctx["t0"]
        dev_s += leg
        self._device_time_s += leg
        self._decode_device_s += leg
        self._dispatches += 1
        self._device_steps += 1
        for i in decode_ix:
            st = self.slots[i]
            self.cache.append(i)            # the fed token is now cached
            st.last_token = int(nxt[i])
            if self._sampler is not None:
                # the per-token fence is the grammar transition point
                st.gstate = self._sampler.host_advance(st.gstate,
                                                       st.last_token)
            st.generated += 1
            self._tokens_emitted += 1
            self.token_streams.setdefault(st.req.rid, []).append(
                st.last_token)
            self._maybe_finish(i, st)
        self._host_dispatch_us.append(
            max(0.0, time.perf_counter() - ctx["t_step"] - dev_s) * 1e6)
        return leg

    def _dispatch_fused(self, decode_ix: list[int]) -> dict:
        """Launch one fused dispatch; no fence.  The host knows every
        slot's remaining budget and each trip (round) emits at least one
        token per active slot, so no trip past the largest budget is
        issued: the plain loop then runs exactly the JAX loop's trips,
        and a speculative dispatch's idle rounds are counted."""
        global decode_dispatches, decode_device_steps
        ds = self.dstate
        n = self._pick_n_steps(decode_ix)
        rem_max = max(self.slots[i].req.output_len
                      - self.slots[i].generated for i in decode_ix)
        n = max(1, min(n, rem_max, self.cfg.multi_step_n))
        carries = ds.carries()            # flushes if dirty (priced)
        bt = ds.block_tables_device()
        t0 = time.perf_counter()
        outs = self._loop(self.params, *self.pools, *carries, bt, n)
        n_pools = len(self.pools)
        self.pools = tuple(outs[:n_pools])
        ds.rebind(tuple(outs[n_pools:n_pools + len(carries)]))
        decode_dispatches += 1
        decode_device_steps += n
        return {"fused": True, "t0": t0, "n": n, "decode_ix": decode_ix,
                "extras": outs[n_pools + len(carries):]}

    def _complete_fused(self, ctx: dict) -> float:
        """Fence a fused dispatch (one read of its token block and
        counters) and run the host bookkeeping."""
        dev_s = ctx["dev_s"]
        toks, cnts, *stats = ctx["extras"]
        b, width = toks.shape
        moe_load = moe_rounds = None
        if self._moe:
            *stats, moe_load, moe_rounds = stats
        # one device -> host read is the fence: [t0, t2) is the device
        # leg, priced into device_us only (sync_d2h_us prices pulls)
        flat = torch.cat([toks.reshape(-1), cnts,
                          torch.stack(stats).to(torch.int32),
                          *([] if moe_load is None else [moe_load])]).cpu()
        flat = flat.numpy()
        toks = flat[:b * width].reshape(b, width)
        cnts = flat[b * width:b * width + b]
        steps = int(flat[b * width + b])
        if moe_load is not None:
            self._record_moe(flat[b * width + b + 1:], moe_rounds)
        if self.cfg.speculative:
            self._drafted += int(flat[-2])
            self._accepted += int(flat[-1])
            self._idle_rounds += ctx["n"] - steps
        t2 = time.perf_counter()
        leg = t2 - ctx["t0"]
        dev_s += leg
        self._device_time_s += leg
        self._decode_device_s += leg
        self._dispatches += 1
        self._device_steps += steps
        if steps > 0:
            per_step = leg / steps
            self._step_ewma_s = (per_step if not self._step_ewma_s else
                                 0.5 * self._step_ewma_s + 0.5 * per_step)
        for i in ctx["decode_ix"]:
            st = self.slots[i]
            m = int(cnts[i])
            if m == 0:
                continue
            self.cache.append(i, m)   # all fed tokens, one batched call
            stream = toks[i, :m].tolist()
            st.generated += m
            st.last_token = stream[-1]
            self._tokens_emitted += m
            self.token_streams.setdefault(st.req.rid, []).extend(stream)
            self._maybe_finish(i, st)
        # each crossing counts against the wall once: the priced syncs
        # are left out of host_dispatch_us
        sync_s = (self.dstate.sync_total_us() - ctx["sync0"]) * 1e-6
        self._host_dispatch_us.append(
            max(0.0, time.perf_counter() - ctx["t_step"] - dev_s - sync_s)
            * 1e6)
        return leg

    def _record_moe(self, load, rounds: int) -> None:
        """Fold one DECODE dispatch's MoE stats (read with its tokens)
        into the run's totals and the flight ring's snapshot."""
        load = np.asarray(load, np.int64)
        rounds = int(rounds)
        self._moe_load += load
        self._moe_rounds.append(rounds)
        total = float(load.sum())
        if total > 0:
            frac = load / total
            imb = float(frac.max()) / max(float(frac.mean()), 1e-12)
        else:
            imb = 1.0
        self._moe_last = {"moe_rounds": rounds,
                          "moe_imbalance": round(imb, 4)}

    def _fold_moe_pending(self) -> None:
        """Fold the prefill chunks' MoE stats, under a fence that already
        covers them (the prompt-completing chunk's token, or the
        record's assembly).  Prefill rounds are kept apart from decode
        rounds: their capacity is sized over the chunk."""
        for load, rounds in self._moe_pending:
            self._moe_load += load.cpu().numpy().astype(np.int64)
            self._moe_prefill_rounds.append(int(rounds))
        self._moe_pending.clear()

    def moe_block(self) -> dict | None:
        """The record's MoE block: the per-expert load distribution
        (prefill and decode routing), its imbalance (max / mean), and the
        decode dispatches' overflow rounds (prefill's apart).  None on a
        dense engine."""
        if not self._moe:
            return None
        self._fold_moe_pending()
        total = float(self._moe_load.sum())
        load = (self._moe_load / total if total > 0
                else np.zeros_like(self._moe_load, float))
        rounds = self._moe_rounds
        pf = self._moe_prefill_rounds
        mean = max(float(load.mean()), 1e-12)
        return {
            "num_experts": int(self.model_cfg.num_experts),
            "top_k": int(self.model_cfg.top_k),
            "capacity_factor": float(self.model_cfg.moe_capacity_factor),
            "skew": self.cfg.moe_skew,
            "skew_seed": self.cfg.moe_skew_seed,
            "expert_load": [round(float(v), 6) for v in load],
            "load_imbalance": round(float(load.max()) / mean, 4),
            "rounds_mean": (round(sum(rounds) / len(rounds), 3)
                            if rounds else 0.0),
            "rounds_p99": (round(M.percentile(rounds, 99), 3)
                           if rounds else 0.0),
            "dispatches": len(rounds),
            "prefill_rounds_mean": (round(sum(pf) / len(pf), 3)
                                    if pf else 0.0),
            "prefill_dispatches": len(pf),
        }

    def _pick_n_steps(self, decode_ix: list[int]) -> int:
        """Adaptive N: the fused loop must never starve an admissible
        request.  Work waiting caps N at the shortest remaining output
        among the active slots; an arrival due mid-loop caps it at the
        measured steps until then; a slot mid-prefill (inline) pins 1.
        A disaggregated decode replica has no arrival queue of its own:
        its next arrival is the next migrated sequence, whose ETA the
        server keeps in ``_migration_eta_s``, capped the same way."""
        n = self.cfg.multi_step_n
        if not self.cfg.adaptive_n:
            return max(1, n)
        if any(st is not None and st.prefill_done < st.req.prompt_len
               for st in self.slots):
            return 1
        if n <= 1:
            return max(1, n)
        rem_min = min(self.slots[i].req.output_len
                      - self.slots[i].generated for i in decode_ix)
        eta = self._migration_eta_s
        if eta is not None:
            dt = eta - self._now()
            est = self._step_ewma_s
            if est > 0 and dt < n * est:
                n = max(1, min(n, max(1, int(dt / est) + 1)))
        if self.pending:
            return max(1, min(n, rem_min))
        if self.queue:
            dt = self.queue[0].arrival_s - self._now()
            est = self._step_ewma_s
            if est > 0 and dt < n * est:
                steps_until = max(1, int(dt / est) + 1)
                return max(1, min(n, rem_min, steps_until))
        if eta is not None:
            return max(1, min(n, rem_min))
        return n

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
        """The dispatch decomposition: device steps per dispatch, what
        each host crossing cost, and the speculative acceptance stats
        (with the port's ``rounds_idle``: rounds issued after every slot
        was done)."""
        d = self._dispatches
        hd = self._host_dispatch_us
        block = {
            "multi_step_n": self.cfg.multi_step_n,
            "adaptive_n": self.cfg.adaptive_n,
            "speculative": self.cfg.speculative,
            "dispatches": d,
            "device_steps": self._device_steps,
            "steps_per_dispatch": (round(self._device_steps / d, 3)
                                   if d else 0.0),
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
        if self.dstate is not None:
            block.update(self.dstate.sync_stats())
        if self.cfg.speculative:
            block["spec"] = {
                "k": self.cfg.spec_k,
                "drafter": self.cfg.drafter,
                **({"drafter_layers": self.cfg.drafter_layers}
                   if self.cfg.drafter == "truncated" else {}),
                "drafted": self._drafted,
                "accepted": self._accepted,
                "acceptance_rate": (round(self._accepted
                                          / self._drafted, 4)
                                    if self._drafted else 0.0),
                "rounds_idle": self._idle_rounds,
            }
        return block

    def global_meta(self, plan: ArrivalPlan) -> dict:
        cfg, mc = self.cfg, self.model_cfg
        return {
            "proxy": "serving",
            "framework": "torch",
            "model": (f"decode_d{mc.embed_dim}_l{mc.num_layers}"
                      f"_h{mc.num_heads}kv{mc.num_kv_heads}"
                      f"_v{mc.vocab_size}"),
            # the devices the run holds: a KV shard wider than the world
            # adds its devices, so the record's rank rows match
            "world_size": max(cfg.world, cfg.kv_shard),
            "arrival_plan": plan.to_dict(),
            "kv_cache_dtype": cfg.cache_dtype,
            # a sampled run's draw identity: records with another
            # temperature, filter, seed or grammar never merge
            **({"sampling": {"temperature": cfg.temperature,
                             "top_k": cfg.top_k,
                             "top_p": cfg.top_p,
                             "sample_seed": cfg.sample_seed,
                             "grammar": cfg.grammar}}
               if self._sampler is not None else {}),
            "serving_config": {
                "slots": cfg.slots, "page_size": cfg.page_size,
                "num_pages": cfg.num_pages,
                "max_seq_len": cfg.max_seq_len,
                "pool_bytes": self.cache_cfg.pool_bytes,
                "cache_dtype": cfg.cache_dtype,
                "prefix_sharing": cfg.prefix_sharing,
                "prefill": cfg.prefill,
                "prefill_chunk": cfg.prefill_chunk,
                "kv_shard": cfg.kv_shard,
                "multi_step_n": cfg.multi_step_n,
                "adaptive_n": cfg.adaptive_n,
                "speculative": cfg.speculative,
                **({"spec_k": cfg.spec_k, "drafter": cfg.drafter}
                   if cfg.speculative else {}),
                # the skew knobs are run identity: a skewed run never
                # merges with a balanced one
                **({"moe_experts": mc.num_experts,
                    "moe_top_k": mc.top_k,
                    "moe_capacity_factor": mc.moe_capacity_factor,
                    "moe_skew": cfg.moe_skew,
                    "moe_skew_seed": cfg.moe_skew_seed}
                   if self._moe else {}),
                "attn_impl": cfg.attn_impl,
            },
            "mesh": mesh_info(self.devices),
        }


def mesh_info(devices: list) -> dict:
    """The record's mesh header over a device list, as given: repeats
    stay (one card named twice is two entries of one id)."""
    on_gpu = devices[0].type == "cuda"
    return {
        "axes": {"devices": len(devices)},
        "num_devices": len(devices),
        "platform": "gpu" if on_gpu else "cpu",
        "device_kind": (torch.cuda.get_device_name(devices[0])
                        if on_gpu else "cpu"),
        "num_hosts": 1,
        "fabric": "real",
        "devices": [{"id": d.index or 0, "process": 0} for d in devices],
    }


def warmup_requests(cfg: ServingConfig) -> list[Request]:
    """The synthetic warm-up requests every runner drives (and
    discards) before its measured run."""
    p_len = min(cfg.prefill_chunk + 1, cfg.max_seq_len - 2)
    return [Request(rid=-1 - i, arrival_s=0.0, prompt_len=p_len,
                    output_len=2) for i in range(cfg.warmup_requests)]


def fault_globals(fault_plan, injector) -> dict:
    """The record globals of a faulted run (none without a plan)."""
    if fault_plan is None:
        return {}
    return {"fault_plan": fault_plan.to_dict(),
            "fault_policy": fault_plan.policy,
            "fault_injected_delay_us": round(injector.injected_delay_us, 1)}


def run_serving(model_cfg: TransformerConfig, cfg: ServingConfig,
                plan: ArrivalPlan, *, fault_plan=None, params=None,
                device=None, devices=None, engine: Engine | None = None,
                live_metrics=None):
    """One measured serving run -> ``ProxyResult`` (-> ``metrics.emit``).

    ``cfg.warmup_requests`` synthetic requests run first and are
    discarded.  Pass ``engine`` to keep a handle on the engine (its
    ``token_streams`` after the run are the measured run's).
    ``live_metrics`` (a path or a ``metrics.LiveMetricsWriter``)
    attaches the windowed live stream to the engine.

    With ``fault_plan``: delays and jitter sleep at engine-step
    boundaries inside the measured loop (one ``FaultInjector`` over the
    config's ``world`` ranks); a crash or preemption propagates unless
    the plan's policy is ``shrink``, where the engine is rebuilt over
    the surviving ranks' devices with ``slots // world`` slots each
    (the rebuild priced into ``recovery_ms``), the unfinished requests
    re-queued with their original arrival stamps on the first
    segment's clock, and the record stamps ``degraded_world``,
    ``degraded_slots``, ``detection_ms`` and ``recovery_ms``."""
    if engine is None:
        engine = Engine(model_cfg, cfg, params=params, device=device,
                        devices=devices)
    if live_metrics is not None:
        engine.live = (live_metrics if hasattr(live_metrics, "maybe_emit")
                       else M.LiveMetricsWriter(live_metrics))
    requests = plan.sample()
    if cfg.warmup_requests > 0:
        with spans.span("warmup", what="serving engine",
                        reps=cfg.warmup_requests):
            engine.run(warmup_requests(cfg))
    injector = None
    if fault_plan is not None:
        from dlnetbench_tpu_torch.faults.inject import FaultInjector
        fault_plan.validate()
        injector = FaultInjector(fault_plan, world=cfg.world)
    meta = engine.global_meta(plan)
    extra: dict = {}
    try:
        with spans.span("serving_run", requests=len(requests)):
            completed, wall = engine.run(requests, injector=injector)
        final = engine
    except Exception as e:
        # the shared crash-shrink head: re-raises what is not a
        # shrinkable fault, stamps detection, names the survivors
        detection_ms, survivors = requeue.detect_shrink(
            e, injector=injector, fault_plan=fault_plan,
            world=cfg.world, step=engine.engine_steps)
        if not survivors:
            raise
        leftovers = requeue.requeue_unfinished(engine)
        done0 = list(engine.completed)
        t_origin = engine._t0
        steps0 = engine.engine_steps
        occ0 = list(engine._occupancy_samples)
        qmax0 = engine.queue_depth_max
        t0 = time.monotonic()
        shrunk = dataclasses.replace(
            cfg, world=len(survivors),
            slots=cfg.slots // cfg.world * len(survivors))
        with spans.span("serving_rebuild", survivors=len(survivors)):
            engine2 = Engine(model_cfg, shrunk,
                             params=(params if params is not None
                                     else engine.params),
                             devices=[engine.devices[r]
                                      for r in survivors])
        engine2.live = engine.live  # the stream outlives the shrink
        recovery_ms = (time.monotonic() - t0) * 1e3
        done1, wall = requeue.run_requeued(
            engine2, leftovers, injector=injector, t_origin=t_origin)
        completed = done0 + done1
        final = engine2
        final.engine_steps += steps0
        final._occupancy_samples = occ0 + final._occupancy_samples
        final.queue_depth_max = max(qmax0, final.queue_depth_max)
        final.concurrent_peak = max(engine.concurrent_peak,
                                    final.concurrent_peak)
        meta["mesh"] = mesh_info(engine2.devices)
        extra = {"detection_ms": round(detection_ms, 3),
                 "recovery_ms": round(recovery_ms, 3),
                 "degraded_world": survivors,
                 "degraded_slots": shrunk.slots}
    moe_blk = final.moe_block()
    if moe_blk is not None:
        meta["moe"] = moe_blk
    meta["serving"] = M.serving_block(
        completed, plan, slo_ttft_ms=cfg.slo_ttft_ms,
        slo_tpot_ms=cfg.slo_tpot_ms, wall_s=wall,
        engine_steps=final.engine_steps,
        cache_stats=final.cache.stats(),
        queue_depth_max=final.queue_depth_max,
        batch_occupancy_mean=final.batch_occupancy_mean(),
        decode_loop=final.decode_loop_block(),
        admitted_peak=final.concurrent_peak)
    if cfg.prefix_sharing:
        # volatile at merge: residency at admission depends on arrival
        # times against the engine's speed
        pstats = final.cache.stats().get("prefix", {})
        meta["prefix_hit_rate"] = pstats.get("hit_rate", 0.0)
        meta["prefix_bytes_saved"] = pstats.get("bytes_saved", 0)
    if cfg.speculative and final._sampler is not None:
        # the measured acceptance at this run's temperature (volatile
        # at merge, unlike the sampling identity block)
        meta["spec_acceptance_by_temp"] = M.acceptance_by_temp([
            (cfg.temperature,
             (final._accepted / final._drafted
              if final._drafted else 0.0))])
    meta.update(fault_globals(fault_plan, injector))
    meta.update(extra)
    return M.build_result(completed, plan, meta)
