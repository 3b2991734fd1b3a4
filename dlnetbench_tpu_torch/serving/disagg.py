"""Disaggregated prefill/decode serving (the JAX package's
``serving/disagg.py``): the DistServe/Splitwise split in one process.

The monolithic engine interleaves bursty, compute-bound prefill with
steady, memory-bound decode on one device, and every admitted prompt
steals decode steps.  ``DisaggServer`` splits the run into two engines
on disjoint parts of one device list:

* ranks ``[0, prefill_ranks)`` — a prefill replica that admits from the
  shared arrival queue, reserves prompt-only pages and prefills each
  prompt into its own pool (its first token stamped there, the TTFT);
* ranks ``[prefill_ranks, world)`` — a decode replica that receives the
  finished sequences over the page-migration channel
  (``ops/page_migration.py``: pages and scales in their stored dtype,
  chunk transfers on side streams) and decodes them to completion.

Each replica is built on its own first device with its own copy of the
weights.  The overlap is measured, not assumed: the decode replica's
program is dispatched without a fence (``Engine._step_dispatch``), the
prefill replica's chunks are pumped and the next handoff's send issued
while it runs, then the decode step is fenced (``_step_complete``) and
the send waited for — the comm-solo, compute-solo and together legs
reduced through ``stats.overlap_fraction``.  The decode replica's
adaptive N is capped at the next migration's expected arrival
(``Engine._pick_n_steps``).  Greedy output is token-identical to
``run_serving``'s per cache dtype: the same programs over the same
weights, pages moved bit for bit, and the decode replica's lengths and
block tables rebuilt to the monolithic post-prefill state.

A crash under policy ``shrink`` takes one replica's rank share: a dead
prefill rank re-queues the prefill side's requests (original arrival
stamps kept, ``serving/requeue.py``) onto a rebuilt server while
decode keeps streaming, so TTFT blows up while TPOT holds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import deque

import torch

from dlnetbench_tpu_torch.metrics import spans
from dlnetbench_tpu_torch.models.transformer import (TransformerConfig,
                                                     init_params)
from dlnetbench_tpu_torch.ops.page_migration import MigrationChannel
from dlnetbench_tpu_torch.serving import metrics as M
from dlnetbench_tpu_torch.serving import requeue
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan, Request
from dlnetbench_tpu_torch.serving.scheduler import (Engine, ServingConfig,
                                                    fault_globals,
                                                    mesh_info,
                                                    resolve_devices,
                                                    warmup_requests)


def device_ctx(device: torch.device):
    """The device a replica's host work runs under (its current device
    on a card; nothing on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _PrefillReplica(Engine):
    """The prefill-phase engine: prompt-only page reservations (its pool
    never decodes), and where the monolithic engine would start decoding
    a slot it queues the finished sequence for a migration send.  It
    builds no decode program."""

    _decode_needed = False

    def _reset_state(self):
        super()._reset_state()
        # (slot, _SlotState) whose prompt is cached, awaiting a send;
        # the slot (its pages are the payload) stays held until then
        self._handoff: list = []

    def _admission_tokens(self, req: Request) -> int:
        return req.prompt_len

    def _activate_decode_slot(self, slot, st) -> None:
        self._handoff.append((slot, st))

    def pump(self, budget: int = 2) -> None:
        """One loop iteration's prefill work: up to ``budget`` chunks,
        oldest admission first.  Intermediate chunks never read back,
        so their compute runs under the decode trips the server
        overlaps them with; the budget keeps an admission backlog from
        queueing all of its prefill at once in front of decode's
        fences."""
        mids = [(st.admitted_s, i, st)
                for i, st in enumerate(self.slots)
                if st is not None
                and st.prefill_done < st.req.prompt_len]
        mids.sort(key=lambda m: (m[0], m[1]))
        for _, i, st in mids:
            while budget and st.prefill_done < st.req.prompt_len:
                self._prefill_one(i, st)
                budget -= 1
            if not budget:
                break


class DisaggServer:
    """One disaggregated serving run: a prefill replica, a decode
    replica and the migration channel between their pools, driven from
    one host thread."""

    def __init__(self, model_cfg: TransformerConfig, cfg: ServingConfig,
                 *, params=None, devices=None,
                 prefill_slots: int | None = None,
                 decode_slots: int | None = None):
        cfg.validate()
        if not cfg.disaggregate:
            raise ValueError("disagg: DisaggServer needs "
                             "cfg.disaggregate=True — a monolithic "
                             "config belongs to run_serving")
        self.model_cfg = model_cfg
        self.cfg = cfg
        devs = resolve_devices(devices, None, cfg.world)
        if len(devs) < cfg.world:
            raise ValueError(
                f"disagg: world {cfg.world} "
                f"(prefill {cfg.prefill_ranks} + decode "
                f"{cfg.decode_ranks}) needs {cfg.world} devices, have "
                f"{len(devs)} — the replica meshes must be disjoint")
        self.devices = devs[:cfg.world]
        self.prefill_devices = self.devices[:cfg.prefill_ranks]
        self.decode_devices = self.devices[cfg.prefill_ranks:]
        if params is None:
            params = init_params(model_cfg, seed=0,
                                 device=self.prefill_devices[0])
        p_slots = cfg.slots if prefill_slots is None else prefill_slots
        d_slots = cfg.slots if decode_slots is None else decode_slots
        # inline on the prefill replica: admission must not drain a
        # whole prompt (it would stall the shared host thread); the
        # server pumps chunks under the decode window instead
        pcfg = dataclasses.replace(
            cfg, disaggregate=False, world=cfg.prefill_ranks,
            slots=p_slots, multi_step_n=1, prefill="inline")
        dcfg = dataclasses.replace(
            cfg, disaggregate=False, world=cfg.decode_ranks,
            slots=d_slots, prefill="separate")
        with self._pctx():
            self.prefill = _PrefillReplica(model_cfg, pcfg, params=params,
                                           devices=self.prefill_devices)
        with self._dctx():
            self.decode = Engine(model_cfg, dcfg, params=params,
                                 devices=self.decode_devices)
        self.channel = MigrationChannel(
            self.decode.cache_cfg, self.decode_devices[0],
            chunk_pages=cfg.migration_chunk_pages)
        # sent payloads awaiting a free decode slot: (PendingSend, meta)
        self._ready: deque = deque()
        self._handoff_ewma_s = 0.0

    def _pctx(self):
        return device_ctx(self.prefill_devices[0])

    def _dctx(self):
        return device_ctx(self.decode_devices[0])

    # ---- the host loop -----------------------------------------------
    def run(self, requests: list[Request], *, injector=None,
            t_origin: float | None = None
            ) -> tuple[list[M.Completed], float]:
        """Drive both replicas until every request completes; returns
        ``(completed, wall_s)`` on the shared clock (``Engine.run``'s
        contract: ``t_origin``, ``injector``, a scripted fault
        propagating with the progress kept)."""
        pe, de = self.prefill, self.decode
        for r in requests:
            if r.prompt_len + r.output_len > self.cfg.max_seq_len:
                raise ValueError(
                    f"serving: request {r.rid} needs "
                    f"{r.prompt_len + r.output_len} tokens > "
                    f"max_seq_len {self.cfg.max_seq_len}")
        with self._pctx():
            pe._reset_state()
        with self._dctx():
            de._reset_state()
        self.channel.reset()
        self._ready.clear()
        pe.queue = deque(sorted(requests, key=lambda r: r.arrival_s))
        t0 = time.monotonic() if t_origin is None else t_origin
        pe._t0 = t0
        de._t0 = t0
        while (pe.queue or pe.pending or pe._handoff or self._ready
               or any(s is not None for s in pe.slots)
               or any(s is not None for s in de.slots)):
            now = pe._now()
            if injector is not None:
                injector.before_step()  # faults land inside the loop
            with self._pctx():
                pe._admit_arrivals(now)
            if any(s is not None for s in de.slots):
                self._decode_step()
            else:
                # decode idle: nothing to hide behind — the chunks run
                # unoverlapped and the fenced send is the comm-solo leg
                with self._pctx():
                    pe.pump()
                if pe._handoff:
                    self._ready.append(self._send_next(overlapped=False))
            # land arrived payloads at the sync boundary
            while self._ready:
                pending, meta = self._ready[0]
                with self._dctx():
                    ok = de.admit_prefilled(
                        meta["req"], last_token=meta["last_token"],
                        admitted_s=meta["admitted_s"],
                        first_token_s=meta["first_token_s"],
                        generated=meta["generated"],
                        pending_send=pending, channel=self.channel)
                if not ok:
                    break  # no slot or pages: retry at the next one
                self._ready.popleft()
            self._update_eta()
            if (not pe.pending and not pe._handoff and not self._ready
                    and not any(s is not None for s in pe.slots)
                    and not any(s is not None for s in de.slots)
                    and pe.queue):
                # idle: sleep to the next arrival (open loop)
                dt = pe.queue[0].arrival_s - pe._now()
                if dt > 0:
                    time.sleep(dt)
        wall = pe._now()
        return pe.completed + de.completed, wall

    def _decode_step(self) -> None:
        """One decode-replica step with the migration window: dispatch
        the decode program (no fence), pump the prefill replica's chunks
        and issue the next handoff's send while it runs, then fence
        both; the overlap legs land in the channel and the engine's
        telemetry sample rides the step as in ``Engine._step``."""
        pe, de, ch = self.prefill, self.decode, self.channel
        tele_on = de._tele is not None or de.live is not None
        t_w = time.perf_counter()
        sync0 = (de.dstate.sync_total_us()
                 if tele_on and de.dstate is not None else 0.0)
        with self._dctx():
            ctx = de._step_dispatch()
        with self._pctx():
            pe.pump()   # chunk dispatches ride under the decode trip
        sent = None
        if ctx is not None and pe._handoff:
            sent = self._send_next(overlapped=True)
        with self._dctx():
            de._step_complete(ctx)
        if sent is not None:
            sent[0].wait()  # decode fenced first: the together window
            ch.note_both(time.perf_counter() - t_w)
            self._ready.append(sent)
        elif ctx is not None:
            ch.note_compute_solo(time.perf_counter() - t_w)
        if tele_on:
            de._sample_step((time.perf_counter() - t_w) * 1e6, sync0)

    def _send_next(self, *, overlapped: bool):
        """Send the oldest handoff's pages.  The slot's pages return to
        the prefill allocator at once: the channel orders the prefill
        stream's later writes after the send's read."""
        pe, de = self.prefill, self.decode
        slot, st = pe._handoff.pop(0)
        s = pe.cfg.page_size
        n_pages = (st.req.prompt_len + s - 1) // s
        ids = [int(p) for p in pe.cache.block_tables[slot][:n_pages]]
        with self._pctx():
            pending = self.channel.send(pe.pools, ids,
                                        fence=not overlapped,
                                        overlapped=overlapped)
        pe.cache.free(slot)
        pe.slots[slot] = None
        lat = max(0.0, pe._now() - st.admitted_s)
        self._handoff_ewma_s = (lat if not self._handoff_ewma_s
                                else 0.5 * self._handoff_ewma_s
                                + 0.5 * lat)
        if de._tele is not None:
            # the handoff in the flight ring, beside the decode steps
            de._tele.record(
                "migration", step=de.engine_steps, pages=len(ids),
                bytes=self.channel.bytes_for_pages(len(ids)),
                overlapped=overlapped, queue_depth=len(pe._handoff))
        meta = {"req": st.req, "last_token": st.last_token,
                "admitted_s": st.admitted_s,
                "first_token_s": st.first_token_s,
                "generated": st.generated}
        return pending, meta

    def _update_eta(self) -> None:
        """The decode replica's migration ETA: now when a payload waits
        and a decode slot is free to land it (inf when every slot is
        taken: the shortest-remaining cap times that boundary already);
        the measured handoff latency after an admitted prompt or after
        the next arrival; None when nothing more will come."""
        pe, de = self.prefill, self.decode
        now = pe._now()
        if self._ready or pe._handoff:
            eta = (now if any(s is None for s in de.slots)
                   else math.inf)
        elif pe.pending or any(s is not None for s in pe.slots):
            eta = now + self._handoff_ewma_s
        elif pe.queue:
            eta = pe.queue[0].arrival_s + self._handoff_ewma_s
        else:
            eta = None
        de._migration_eta_s = eta

    # ---- fault segmentation ------------------------------------------
    def drain_unfinished(self) -> list[Request]:
        """Everything not completed, across both replicas and the
        channel (sent but unadmitted payloads are abandoned and redone),
        arrival stamps kept."""
        pe, de = self.prefill, self.decode
        left = pe.drain_unfinished()
        pe._handoff.clear()
        left += [meta["req"] for _p, meta in self._ready]
        self._ready.clear()
        left += de.drain_unfinished()
        return sorted(left, key=lambda r: r.arrival_s)

    # ---- record assembly ---------------------------------------------
    @property
    def token_streams(self) -> dict:
        """Per-request streams, the prefill-side first token first."""
        out = {rid: list(toks)
               for rid, toks in self.prefill.token_streams.items()}
        for rid, toks in self.decode.token_streams.items():
            out.setdefault(rid, []).extend(toks)
        return out

    def engine_steps(self) -> int:
        return self.prefill.engine_steps + self.decode.engine_steps

    def global_meta(self, plan: ArrivalPlan) -> dict:
        cfg = self.cfg
        meta = self.decode.global_meta(plan)
        meta["world_size"] = cfg.world
        # comparable: a disaggregated record never merges with a
        # monolithic one
        meta["disaggregated"] = True
        meta["serving_config"].update({
            "slots": cfg.slots,
            "disaggregate": True,
            "prefill_ranks": cfg.prefill_ranks,
            "decode_ranks": cfg.decode_ranks,
            "prefill_slots": self.prefill.cfg.slots,
            "decode_slots": self.decode.cfg.slots,
            "migration_chunk_pages": cfg.migration_chunk_pages,
        })
        meta["mesh"] = mesh_info(self.devices)
        return meta


def run_disagg(model_cfg: TransformerConfig, cfg: ServingConfig,
               plan: ArrivalPlan, *, fault_plan=None, params=None,
               devices=None, live_metrics=None):
    """One measured disaggregated run -> ``ProxyResult``: the
    ``run_serving`` contract (warm-up, fault segmentation, record)
    over the two-replica server.  A crash under ``shrink`` names its
    replica by rank range; the whole server is rebuilt over the
    survivors with the dead rank's slot share taken from its replica
    only, the leftovers re-queued with their stamps, and both
    segments' migrations folded into one block."""
    cfg.validate()
    devs = resolve_devices(devices, None, cfg.world)
    if params is None and devs:
        params = init_params(model_cfg, seed=0, device=devs[0])
    server = DisaggServer(model_cfg, cfg, params=params, devices=devs)
    if live_metrics is not None:
        server.decode.live = (
            live_metrics if hasattr(live_metrics, "maybe_emit")
            else M.LiveMetricsWriter(live_metrics))
    requests = plan.sample()
    if cfg.warmup_requests > 0:
        with spans.span("warmup", what="disagg engines",
                        reps=cfg.warmup_requests):
            server.run(warmup_requests(cfg))
    injector = None
    if fault_plan is not None:
        from dlnetbench_tpu_torch.faults.inject import FaultInjector
        fault_plan.validate()
        injector = FaultInjector(fault_plan, world=cfg.world)
    meta = server.global_meta(plan)
    extra: dict = {}
    try:
        with spans.span("serving_run", requests=len(requests)):
            completed, wall = server.run(requests, injector=injector)
        final = server
    except Exception as e:
        detection_ms, survivors = requeue.detect_shrink(
            e, injector=injector, fault_plan=fault_plan,
            world=cfg.world, step=server.engine_steps(),
            detail={"replica": ("prefill"
                                if (getattr(e, "rank", 0) or 0)
                                < cfg.prefill_ranks else "decode")})
        p_surv = [r for r in survivors if r < cfg.prefill_ranks]
        d_surv = [r for r in survivors if r >= cfg.prefill_ranks]
        if not p_surv or not d_surv:
            # both phases must live: a whole replica lost is fatal
            raise
        leftovers = requeue.requeue_unfinished(server)
        done0 = server.prefill.completed + server.decode.completed
        t_origin = server.prefill._t0
        steps0 = server.engine_steps()
        occ0 = list(server.decode._occupancy_samples)
        qmax0 = server.prefill.queue_depth_max
        peak0 = server.decode.concurrent_peak
        sends0 = list(server.channel._sends)
        legs0 = (list(server.channel._compute_solo_s),
                 list(server.channel._both_s))
        p_slots = (server.prefill.cfg.slots // cfg.prefill_ranks
                   * len(p_surv))
        d_slots = (server.decode.cfg.slots // cfg.decode_ranks
                   * len(d_surv))
        t0 = time.monotonic()
        shrunk = dataclasses.replace(
            cfg, world=len(survivors), prefill_ranks=len(p_surv),
            decode_ranks=len(d_surv), slots=d_slots)
        with spans.span("serving_rebuild", survivors=len(survivors)):
            server2 = DisaggServer(
                model_cfg, shrunk, params=params,
                devices=[server.devices[r] for r in survivors],
                prefill_slots=p_slots, decode_slots=d_slots)
        server2.decode.live = server.decode.live
        recovery_ms = (time.monotonic() - t0) * 1e3
        done1, wall = requeue.run_requeued(
            server2, leftovers, injector=injector, t_origin=t_origin)
        completed = done0 + done1
        final = server2
        final.decode.engine_steps += steps0
        final.decode._occupancy_samples = \
            occ0 + final.decode._occupancy_samples
        final.prefill.queue_depth_max = max(
            qmax0, final.prefill.queue_depth_max)
        final.decode.concurrent_peak = max(
            peak0, final.decode.concurrent_peak)
        # both segments' migrations are one run's wire traffic
        final.channel._sends[:0] = sends0
        final.channel._compute_solo_s[:0] = legs0[0]
        final.channel._both_s[:0] = legs0[1]
        meta["mesh"] = mesh_info(server2.devices)
        extra = {"detection_ms": round(detection_ms, 3),
                 "recovery_ms": round(recovery_ms, 3),
                 "degraded_world": survivors,
                 "degraded_slots": d_slots}
    moe_blk = final.decode.moe_block()
    if moe_blk is not None:
        meta["moe"] = moe_blk
    meta["serving"] = M.serving_block(
        completed, plan, slo_ttft_ms=cfg.slo_ttft_ms,
        slo_tpot_ms=cfg.slo_tpot_ms, wall_s=wall,
        engine_steps=final.engine_steps(),
        cache_stats=final.decode.cache.stats(),
        queue_depth_max=final.prefill.queue_depth_max,
        batch_occupancy_mean=final.decode.batch_occupancy_mean(),
        decode_loop=final.decode.decode_loop_block(),
        admitted_peak=final.decode.concurrent_peak,
        migration=final.channel.stats_block())
    meta.update(fault_globals(fault_plan, injector))
    meta.update(extra)
    return M.build_result(completed, plan, meta)
