"""Fleet serving: N engine replicas behind one seeded router (the JAX
package's ``serving/fleet.py``).

A front-end ``Router`` (``serving/router.py``) hands each arriving
request to one of N independent ``Engine`` replicas, each over its own
``world``-device part of one device list with its own page pool, its
own copy of the weights and its own untouched admission control, all
driven by one host loop from one arrival plan and one clock origin.
The loop dispatches every working replica's step before fencing any
(``_step_all``), so the replicas' devices run at once.

Elastic capacity (``FleetConfig.autoscale``): the autoscaler watches the
pooled rolling SLO window (``serving/metrics.rolling_slo_breach``) and
the routed backlog.  Scale-down drains the lightest replica through the
shared re-queue arc (``serving/requeue.py``: its in-flight work rejoins
the fleet queue with the original stamps) and parks it warm; its
retired seconds are chip-seconds saved.  Scale-up revives a parked
replica (a state reset) or rebuilds it, the time priced into the
event's ``scale_up_ms``.  A replica crash (a fault plan's crash or
preemption under ``shrink``, one fault rank a replica) takes the same
drain with no rebuild: the router stops offering the dead replica.

The record's ``fleet`` global is a volatile measurement block (requests
per replica, the load histogram, the affinity hit rate, scale events,
chip-seconds); ``fleet_routing`` and ``fleet_replicas`` are comparable
globals: records of another policy or fleet width never merge.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

from dlnetbench_tpu_torch.metrics import spans
from dlnetbench_tpu_torch.models.transformer import (TransformerConfig,
                                                     init_params)
from dlnetbench_tpu_torch.serving import decode as D
from dlnetbench_tpu_torch.serving import metrics as M
from dlnetbench_tpu_torch.serving import requeue
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan, Request
from dlnetbench_tpu_torch.serving.disagg import device_ctx
from dlnetbench_tpu_torch.serving.router import ROUTING_POLICIES, Router
from dlnetbench_tpu_torch.serving.scheduler import (Engine, ServingConfig,
                                                    fault_globals,
                                                    mesh_info,
                                                    resolve_devices,
                                                    warmup_requests)


@dataclasses.dataclass
class FleetConfig:
    """Fleet-level knobs (the JAX package's names and defaults)."""
    replicas: int = 2            # engine replicas, cfg.world devices each
    routing: str = "round_robin"  # serving/router.ROUTING_POLICIES
    route_seed: int = 0          # the router's splitmix64 stream
    autoscale: bool = False      # elastic capacity
    min_replicas: int = 1        # autoscale floor
    scale_window_s: float = 0.5  # breach window and idle-tick cadence
    scale_idle_frac: float = 0.25  # scale down below this share of the
    #                                slots busy (nothing due waiting)
    scale_cooldown_s: float = 1.0  # seconds between scale actions

    def validate(self) -> "FleetConfig":
        if self.replicas < 1:
            raise ValueError(f"fleet: replicas must be >= 1, got "
                             f"{self.replicas}")
        if self.routing not in ROUTING_POLICIES:
            raise ValueError(f"fleet: unknown routing "
                             f"{self.routing!r} (one of "
                             f"{ROUTING_POLICIES})")
        if not 1 <= self.min_replicas <= self.replicas:
            raise ValueError(
                f"fleet: min_replicas {self.min_replicas} must be in "
                f"[1, replicas={self.replicas}]")
        if self.autoscale and self.replicas < 2:
            raise ValueError(
                "fleet: autoscale needs replicas >= 2 — a one-replica "
                "fleet has nothing to drain or rebuild")
        for name in ("scale_window_s", "scale_cooldown_s"):
            if not getattr(self, name) > 0:
                raise ValueError(f"fleet: {name} must be > 0")
        if not 0.0 < self.scale_idle_frac < 1.0:
            raise ValueError(
                f"fleet: scale_idle_frac must be in (0, 1), got "
                f"{self.scale_idle_frac}")
        return self


class FleetServer:
    """N independent engines, one router, one clock.  Each ``run`` starts
    at full strength (retired replicas revived or rebuilt)."""

    def __init__(self, model_cfg: TransformerConfig, cfg: ServingConfig,
                 fleet: FleetConfig, *, params=None, devices=None):
        self.model_cfg = model_cfg
        self.cfg = cfg.validate()
        self.fleet = fleet.validate()
        if cfg.disaggregate:
            raise ValueError(
                "serving: fleet replicas are monolithic engines — "
                "disaggregate + fleet has no stated device-budget "
                "split (route to run_disagg OR run_fleet, not both)")
        if fleet.routing == "prefix_affinity" and not cfg.prefix_sharing:
            raise ValueError(
                "fleet: prefix_affinity consults each replica's radix "
                "trie — it requires prefix_sharing=True (without "
                "sharing every probe returns 0 and the policy is just "
                "a slower p2c)")
        need = fleet.replicas * cfg.world
        devs = resolve_devices(devices, None, need)
        if len(devs) < need:
            raise ValueError(
                f"fleet: {fleet.replicas} replicas x world {cfg.world} "
                f"need {need} devices, have {len(devs)}")
        self._params = (params if params is not None
                        else init_params(model_cfg, seed=0,
                                         device=devs[0]))
        self._replica_devices = [devs[r * cfg.world:(r + 1) * cfg.world]
                                 for r in range(fleet.replicas)]
        self.devices = devs[:need]
        self.engines: list[Engine | None] = [
            self._build_engine(r) for r in range(fleet.replicas)]
        self.router = Router(fleet.routing, fleet.replicas,
                             seed=fleet.route_seed)
        # one fleet-level live stream, each line stamped with its
        # replica_id (the engines' own .live stays None)
        self.live = None
        self._prompt_memo: dict[int, object] = {}
        # the autoscaler's warm standby: retired engines keep their
        # weights and programs; a crashed replica never parks
        self._parked: dict[int, Engine] = {}
        self.scale_events: list[dict] = []

    def _build_engine(self, r: int) -> Engine:
        """Replica ``r``'s engine on its devices, with its own copy of
        the weights."""
        devs = self._replica_devices[r]
        with device_ctx(devs[0]):
            e = Engine(self.model_cfg, self.cfg, params=self._params,
                       devices=devs)
        e.replica_id = r   # rides the live-metrics stream
        return e

    def _ctx(self, r: int):
        return device_ctx(self._replica_devices[r][0])

    def _active_ix(self) -> list[int]:
        return [r for r, e in enumerate(self.engines) if e is not None]

    # ---- the host loop -----------------------------------------------
    def run(self, requests: list[Request], *, injector=None,
            fault_plan=None, t_origin: float | None = None
            ) -> tuple[list[M.Completed], float]:
        """Drive the fleet until every request completes; returns
        ``(completed, wall_s)``.  ``fault_plan`` rides along for the
        in-loop crash arc (one fault rank a replica)."""
        cfg = self.cfg
        for r in requests:
            if r.prompt_len + r.output_len > cfg.max_seq_len:
                raise ValueError(
                    f"serving: request {r.rid} needs "
                    f"{r.prompt_len + r.output_len} tokens > "
                    f"max_seq_len {cfg.max_seq_len}")
        for r in range(self.fleet.replicas):
            if self.engines[r] is None:
                self.engines[r] = (self._parked.pop(r, None)
                                   or self._build_engine(r))
        for i in self._active_ix():
            with self._ctx(i):
                self.engines[i]._reset_state()
        self.router.reset()
        self._prompt_memo.clear()
        self.scale_events = []
        self._retired_completed: list[M.Completed] = []
        self._retired_streams: dict[int, list[int]] = {}
        self._retired_steps = 0
        self._retired_occupancy: list[int] = []
        self._retired_stats: dict[int, dict] = {}
        self._standby: list[int] = []
        self.queue_depth_max = 0
        self.concurrent_peak = 0
        n_rep = self.fleet.replicas
        self._used_s = [0.0] * n_rep     # serving intervals
        self._saved_s = [0.0] * n_rep    # retired-by-autoscaler intervals
        self._active_from: list[float | None] = [
            0.0 if self.engines[r] is not None else None
            for r in range(n_rep)]
        self._idle_from: list[float | None] = [None] * n_rep
        self._queue: deque[Request] = deque(
            sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        self._t0 = time.monotonic() if t_origin is None else t_origin
        for i in self._active_ix():
            self.engines[i]._t0 = self._t0
        self._last_scale_s = 0.0
        if self.live is not None:
            self.live.reset_run()

        while self._queue or self._any_engine_work():
            now = self._now()
            try:
                if injector is not None:
                    injector.before_step()  # faults land inside the loop
            except Exception as e:
                self._on_fault(e, injector, fault_plan, now)
                continue
            self._autoscale_tick(now)
            self._route_due(now)
            active = self._active_ix()
            for i in active:
                with self._ctx(i):
                    self.engines[i]._admit_arrivals(now)
            self.concurrent_peak = max(
                self.concurrent_peak,
                sum(1 for i in active for s in self.engines[i].slots
                    if s is not None))
            if not self._any_slot_work():
                # idle: sleep to the next arrival, waking at the
                # autoscaler's cadence so a trough still scales down
                if self._queue:
                    dt = self._queue[0].arrival_s - self._now()
                    if self.fleet.autoscale:
                        dt = min(dt, self.fleet.scale_window_s)
                    if dt > 0:
                        time.sleep(dt)
                continue
            self._step_all(active)
            if self.live is not None:
                now2 = self._now()
                for i in self._active_ix():
                    self.live.maybe_emit(self.engines[i], now2)
        wall = self._now()
        for r in range(n_rep):
            if self._active_from[r] is not None:
                self._used_s[r] += wall - self._active_from[r]
                self._active_from[r] = None
            if self._idle_from[r] is not None:
                self._saved_s[r] += wall - self._idle_from[r]
                self._idle_from[r] = None
        completed = sorted(self._all_completed(),
                           key=lambda c: c.finish_s)
        return completed, wall

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _any_engine_work(self) -> bool:
        return any(e.queue or e.pending
                   or any(s is not None for s in e.slots)
                   for e in self.engines if e is not None)

    def _any_slot_work(self) -> bool:
        return any(e.pending or any(s is not None for s in e.slots)
                   for e in self.engines if e is not None)

    def _route_due(self, now: float) -> None:
        """Hand every due arrival to the router's pick; the chosen
        replica's own admission control takes it from there."""
        affinity = self.fleet.routing == "prefix_affinity"
        while self._queue and self._queue[0].arrival_s <= now:
            req = self._queue.popleft()
            toks = self._prompt_of(req) if affinity else None
            r = self.router.pick(req, self.engines, self._active_ix(),
                                 prompt_tokens=toks)
            self.engines[r].queue.append(req)
        backlog = sum(len(e.queue) + len(e.pending)
                      for e in self.engines if e is not None)
        self.queue_depth_max = max(self.queue_depth_max, backlog)

    def _prompt_of(self, req: Request):
        toks = self._prompt_memo.get(req.rid)
        if toks is None:
            toks = D.prompt_tokens_for(req, self.model_cfg.vocab_size)
            self._prompt_memo[req.rid] = toks
        return toks

    def _step_all(self, active: list[int]) -> None:
        """One fleet step: dispatch every working replica's step, then
        fence them in dispatch order, each replica's telemetry sample
        riding its own step."""
        inflight = []
        for i in active:
            e = self.engines[i]
            if not (e.pending or any(s is not None for s in e.slots)):
                continue
            tele_on = e._tele is not None or self.live is not None
            t_w = time.perf_counter()
            sync0 = (e.dstate.sync_total_us()
                     if tele_on and e.dstate is not None else 0.0)
            with self._ctx(i):
                ctx = e._step_dispatch()
            inflight.append((i, e, ctx, tele_on, t_w, sync0))
        for i, e, ctx, tele_on, t_w, sync0 in inflight:
            with self._ctx(i):
                e._step_complete(ctx)
            if tele_on:
                e._sample_step((time.perf_counter() - t_w) * 1e6, sync0)

    # ---- elastic capacity --------------------------------------------
    def _autoscale_tick(self, now: float) -> None:
        """One decision per cooldown: up on a pooled SLO breach or a
        backlog above the active slots (with a standby replica), down
        when the accepted work is under the idle share of the slots and
        nothing due waits."""
        if not self.fleet.autoscale:
            return
        if now - self._last_scale_s < self.fleet.scale_cooldown_s:
            return
        active = self._active_ix()
        if not active:
            return
        cap = sum(self.engines[i].cfg.slots for i in active)
        load = sum(Router.load_score(self.engines[i]) for i in active)
        if self._standby:
            recent: list[M.Completed] = []
            for i in active:
                recent += self.engines[i].completed[-32:]
            recent.sort(key=lambda c: c.finish_s)
            breach = M.rolling_slo_breach(
                recent, slo_ttft_ms=self.cfg.slo_ttft_ms,
                slo_tpot_ms=self.cfg.slo_tpot_ms, now_s=now,
                window_s=self.fleet.scale_window_s)
            if breach is not None or load > cap:
                self._scale_up(now, reason=("slo_breach"
                                            if breach is not None
                                            else "queue_pressure"))
                return
        # only DUE work pins capacity: a trough holds the next peak as
        # future arrivals in the fleet queue
        due = bool(self._queue) and self._queue[0].arrival_s <= now
        if (len(active) > self.fleet.min_replicas and not due
                and load < self.fleet.scale_idle_frac * cap):
            self._scale_down(now)

    def _scale_down(self, now: float) -> None:
        """Drain the lightest replica through the re-queue arc and park
        it; its retired seconds are chip-seconds saved."""
        active = self._active_ix()
        victim = min(active,
                     key=lambda r: (Router.load_score(self.engines[r]),
                                    r))
        t0 = time.perf_counter()
        leftovers = requeue.requeue_unfinished(self.engines[victim])
        drain_ms = (time.perf_counter() - t0) * 1e3
        self._requeue_to_fleet(leftovers)
        self._retire(victim, now, dead=False)
        self._standby.append(victim)
        self.scale_events.append({
            "t_s": round(now, 4), "kind": "scale_down",
            "replica": victim, "requeued": len(leftovers),
            "drain_ms": round(drain_ms, 3)})
        self._last_scale_s = now

    def _scale_up(self, now: float, *, reason: str) -> None:
        """Bring a standby replica back, warm from the parked pool or
        rebuilt; the spin-up is priced into ``scale_up_ms``."""
        r = self._standby.pop(0)
        t0 = time.perf_counter()
        warm = self._parked.pop(r, None)
        with spans.span("fleet_scale_up", replica=r,
                        warm=warm is not None):
            if warm is not None:
                e = warm
                with self._ctx(r):
                    e._reset_state()
            else:
                e = self._build_engine(r)
        scale_up_ms = (time.perf_counter() - t0) * 1e3
        e._t0 = self._t0           # the shared timeline
        self.engines[r] = e
        if self._idle_from[r] is not None:
            self._saved_s[r] += now - self._idle_from[r]
            self._idle_from[r] = None
        self._active_from[r] = now  # the spin-up counts as used
        self.scale_events.append({
            "t_s": round(now, 4), "kind": "scale_up", "replica": r,
            "scale_up_ms": round(scale_up_ms, 3), "reason": reason,
            "warm": warm is not None})
        self._last_scale_s = self._now()

    def _retire(self, r: int, now: float, *, dead: bool) -> None:
        """Take replica ``r`` out, folding its stats into the retired
        accumulators.  A dead replica accrues neither used nor saved
        seconds after; an autoscaler retiree accrues saved seconds and
        parks warm."""
        e = self.engines[r]
        self._retired_completed += e.completed
        for rid, toks in e.token_streams.items():
            self._retired_streams.setdefault(rid, []).extend(toks)
        self._retired_steps += e.engine_steps
        self._retired_occupancy += e._occupancy_samples
        self._retired_stats[r] = e.cache.stats()
        if self._active_from[r] is not None:
            self._used_s[r] += now - self._active_from[r]
            self._active_from[r] = None
        self._idle_from[r] = None if dead else now
        if not dead:
            self._parked[r] = e
        self.engines[r] = None

    # ---- fault segmentation ------------------------------------------
    def _on_fault(self, e: BaseException, injector, fault_plan,
                  now: float) -> None:
        """A crash or preemption under ``shrink`` takes whole replicas
        (one fault rank a replica): they drain through the re-queue arc
        and the survivors absorb the work.  Re-raises when no active
        replica survives or the fault is not this arc's."""
        detection_ms, survivors = requeue.detect_shrink(
            e, injector=injector, fault_plan=fault_plan,
            world=self.fleet.replicas, step=self.engine_steps(),
            detail={"scope": "fleet"})
        surv = set(survivors)
        if not any(r in surv for r in self._active_ix()):
            raise e
        for v in range(self.fleet.replicas):
            if v in surv:
                continue
            if v in self._standby:
                self._standby.remove(v)   # dead chips never scale up
            if self.engines[v] is None:
                continue
            leftovers = requeue.requeue_unfinished(self.engines[v])
            self._requeue_to_fleet(leftovers)
            self._retire(v, now, dead=True)
            self.scale_events.append({
                "t_s": round(now, 4), "kind": "replica_crash",
                "replica": v, "requeued": len(leftovers),
                "detection_ms": round(detection_ms, 3)})

    def _requeue_to_fleet(self, leftovers: list[Request]) -> None:
        """Drained requests rejoin the fleet queue with their original
        stamps; the next ``_route_due`` offers them to the survivors."""
        self._queue = deque(sorted(
            list(leftovers) + list(self._queue),
            key=lambda r: (r.arrival_s, r.rid)))

    # ---- record assembly ---------------------------------------------
    @property
    def token_streams(self) -> dict:
        """Per-request streams across replicas (a request lives on one
        replica at a time)."""
        out = {rid: list(toks)
               for rid, toks in self._retired_streams.items()}
        for e in self.engines:
            if e is None:
                continue
            for rid, toks in e.token_streams.items():
                out.setdefault(rid, []).extend(toks)
        return out

    def _all_completed(self) -> list[M.Completed]:
        done = list(self._retired_completed)
        for e in self.engines:
            if e is not None:
                done += e.completed
        return done

    def engine_steps(self) -> int:
        return self._retired_steps + sum(
            e.engine_steps for e in self.engines if e is not None)

    def batch_occupancy_mean(self) -> float:
        samples = list(self._retired_occupancy)
        for e in self.engines:
            if e is not None:
                samples += e._occupancy_samples
        if not samples:
            return 0.0
        return sum(samples) / len(samples)

    def replica_cache_stats(self) -> list[dict | None]:
        """Final per-replica pool stats (a retired replica's taken at
        its retirement)."""
        out: list[dict | None] = []
        for r in range(self.fleet.replicas):
            e = self.engines[r]
            out.append(e.cache.stats() if e is not None
                       else self._retired_stats.get(r))
        return out

    def chip_seconds(self) -> tuple[float, float]:
        """(used, saved), weighted by a replica's device count."""
        ndev = len(self._replica_devices[0])
        return sum(self._used_s) * ndev, sum(self._saved_s) * ndev

    def fleet_block(self, completed: list[M.Completed]) -> dict:
        """The record's ``fleet`` global (volatile at merge)."""
        used, saved = self.chip_seconds()
        slo_ok = sum(1 for c in completed
                     if M.meets_slo(c, self.cfg.slo_ttft_ms,
                                    self.cfg.slo_tpot_ms))
        rstats = self.replica_cache_stats()
        block = {
            "replicas": self.fleet.replicas,
            "routing": self.fleet.routing,
            "route_seed": self.fleet.route_seed,
            "requests_per_replica": list(self.router.counts),
            "load_histogram": self.router.load_histogram(),
            "scale_events": list(self.scale_events),
            "chip_seconds_used": round(used, 4),
            "chip_seconds_saved": round(saved, 4),
            "slo_goodput_per_chip_s": (round(slo_ok / used, 4)
                                       if used > 0 else 0.0),
            "queue_depth_max": self.queue_depth_max,
        }
        if self.fleet.routing == "prefix_affinity":
            block["affinity_hit_rate"] = self.router.affinity_hit_rate()
            block["affinity_bounces"] = self.router.affinity_bounces
            # prefix tokens served off the pages a request was routed to
            block["prefix_reuse_tokens"] = \
                self.router.prefix_reuse_tokens
            block["replica_prefix_hit_rate"] = [
                (s.get("prefix", {}).get("hit_rate", 0.0)
                 if s else None) for s in rstats]
        return block

    def global_meta(self, plan: ArrivalPlan) -> dict:
        first = next(e for e in self.engines if e is not None)
        meta = first.global_meta(plan)
        meta["world_size"] = self.fleet.replicas * self.cfg.world
        meta["mesh"] = mesh_info(self.devices)
        # comparable: another policy or fleet width never merges
        meta["fleet_routing"] = self.fleet.routing
        meta["fleet_replicas"] = self.fleet.replicas
        return meta


def run_fleet(model_cfg: TransformerConfig, cfg: ServingConfig,
              plan: ArrivalPlan, fleet: FleetConfig | None = None, *,
              fault_plan=None, params=None, devices=None,
              live_metrics=None):
    """One measured fleet run -> ``ProxyResult``.  Every replica is
    warmed directly (its own discarded warm-up requests), never through
    the router, whose seeded stream the measured run starts from."""
    fleet = (fleet if fleet is not None else FleetConfig()).validate()
    server = FleetServer(model_cfg, cfg, fleet, params=params,
                         devices=devices)
    if live_metrics is not None:
        server.live = (live_metrics if hasattr(live_metrics, "maybe_emit")
                       else M.LiveMetricsWriter(live_metrics))
    requests = plan.sample()
    if cfg.warmup_requests > 0:
        with spans.span("warmup", what="serving fleet",
                        reps=cfg.warmup_requests * fleet.replicas):
            for i in server._active_ix():
                with server._ctx(i):
                    server.engines[i].run(warmup_requests(cfg))
    injector = None
    if fault_plan is not None:
        from dlnetbench_tpu_torch.faults.inject import FaultInjector
        fault_plan.validate()
        # one fault rank a replica: crash rank r takes replica r
        injector = FaultInjector(fault_plan, world=fleet.replicas)
    meta = server.global_meta(plan)
    with spans.span("serving_run", requests=len(requests)):
        completed, wall = server.run(requests, injector=injector,
                                     fault_plan=fault_plan)
    meta["serving"] = M.serving_block(
        completed, plan, slo_ttft_ms=cfg.slo_ttft_ms,
        slo_tpot_ms=cfg.slo_tpot_ms, wall_s=wall,
        engine_steps=server.engine_steps(),
        queue_depth_max=server.queue_depth_max,
        batch_occupancy_mean=server.batch_occupancy_mean(),
        admitted_peak=server.concurrent_peak)
    meta["fleet"] = server.fleet_block(completed)
    if cfg.prefix_sharing:
        # pooled across replicas (per-pool rates: the fleet block's
        # replica_prefix_hit_rate)
        hits = admits = saved = 0
        for s in server.replica_cache_stats():
            if not s:
                continue
            p = s.get("prefix", {})
            hits += p.get("hits", 0)
            saved += p.get("bytes_saved", 0)
            admits += s.get("admissions", 0)
        meta["prefix_hit_rate"] = round(hits / max(admits, 1), 4)
        meta["prefix_bytes_saved"] = saved
    meta.update(fault_globals(fault_plan, injector))
    return M.build_result(completed, plan, meta)
