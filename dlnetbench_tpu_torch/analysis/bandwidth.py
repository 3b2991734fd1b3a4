"""Effective collective bandwidth (the port's copy of the JAX package's
``analysis/bandwidth.py``).

Every proxy declares, in its record's ``global.comm_model``, exactly how
many bytes each timed region moves per iteration (one or more components
of {kind, bytes, group}); this module turns that plus the per-rank
timer arrays into the standard nccl-tests figures:

    algbw = bytes_per_iteration / time          [GB/s, bytes not bits]
    busbw = sum_i bytes_i * factor(kind_i, group_i) / time

with NCCL's correction factors — allreduce 2(n-1)/n, allgather /
reduce-scatter / all-to-all (n-1)/n, p2p 1 — so numbers are comparable
across world sizes and against link speed.  Declaring the totals at the
proxy (which knows its schedule) keeps multi-op timers honest; nothing
here guesses op counts from column names.
"""
from __future__ import annotations


def transport_of(rec: dict) -> str:
    """Transport provenance of a record's timed bytes — the column that
    stops a loopback row from reading as fabric physics.

    Schema-v2 records stamp ``global.transport`` directly (the port's
    ``local``, ``nccl``, ``nccl+network``, ``virtual-host``; the JAX
    package's ``ici``, ``shm``, ``tcp:loopback``, ``host``, ...).
    Older records are classified from the identity they do carry — the
    native tier's backend/executor keys, or the mesh header — and only a
    record carrying nothing classifiable is ``unknown``."""
    g = rec.get("global", {})
    t = g.get("transport")
    if t:
        return str(t)
    backend = g.get("backend")
    if backend == "shm":
        return "shm"
    if backend == "tcp":
        return "tcp"  # pre-stamp records don't say loopback vs ethernet
    if backend == "pjrt":
        # HostExecutor moves host memory; the plugin's collectives ride
        # the real interconnect.  A hier run composes a TCP DCN leg.
        execu = g.get("pjrt_executor")
        local = "host" if execu == "host" else "ici"
        return f"{local}+tcp" if g.get("dcn_transport") == "tcp" else local
    mesh = rec.get("mesh", {})
    if mesh.get("platform") == "gpu":
        # mirror the port's emit.transport_label
        if mesh.get("num_devices", 1) <= 1:
            return "local"
        return "nccl+network" if mesh.get("num_hosts", 1) > 1 else "nccl"
    if mesh.get("platform") == "cpu":
        return "virtual-host"
    if mesh.get("platform") == "tpu":
        # mirror emit.transport_label: a multi-host record's collectives
        # have a DCN leg and must not be classified as pure ICI
        return "ici+dcn" if mesh.get("num_hosts", 1) > 1 else "ici"
    return "unknown"


def _plan_of(rec: dict):
    """The record's fault plan as a ``faults.plan.FaultPlan`` — ONE
    implementation of the window/delay arithmetic for both the harness
    and this analysis layer.  None when absent or unparseable (a
    malformed plan must degrade to 'no fault columns', never crash an
    unrelated bandwidth report)."""
    raw = rec.get("global", {}).get("fault_plan")
    if not raw or not raw.get("events"):
        return None
    from dlnetbench_tpu_torch.faults.plan import FaultPlan
    try:
        return FaultPlan.from_dict(raw)
    except (ValueError, KeyError, TypeError):
        return None


def _fault_run_window(rec: dict):
    """``(start_step, end_step, steps_per_sample)`` for the record's
    fault plan (``global.fault_plan``, faults/plan.py schema): the
    MEASURED-step window [start, end) with any live event (``end``
    None = open) plus how many harness steps each timer sample spans
    (``reps_per_fence`` — one fence chain contributes one sample for K
    steps on the python tier; native records are always 1).  Plan
    triggers count every step INCLUDING warmup, so the warmup length
    (``warmup_times``; the first process's entry on merged records)
    rebases step units onto the measured region.  None = no plan."""
    plan = _plan_of(rec)
    window = plan.fault_window() if plan is not None else None
    if window is None:
        return None
    start, end = window
    warm = rec.get("warmup_times")
    if warm is None:
        by_proc = rec.get("warmup_times_by_process") or {}
        warm = next(iter(by_proc.values()), [])
    w = len(warm)
    k = max(int(rec.get("global", {}).get("reps_per_fence", 1) or 1), 1)
    return (max(0, start - w), None if end is None else max(0, end - w), k)


def _run_faulted(window, run: int) -> bool:
    """Sample ``run`` covers measured steps [run*k, (run+1)*k); it is
    faulted when that range intersects the window — a chain with ANY
    faulted step carries injected latency and must not pass as clean."""
    if window is None:
        return False
    s, e, k = window
    lo, hi = run * k, (run + 1) * k
    return hi > s and (e is None or lo < e)


def straggler_amplification(rec: dict) -> float:
    """How much ONE straggler's injected delay cost the whole step:

        (median faulted runtime - median clean runtime) / injected delay

    ~1.0 means the collective gated exactly on the straggler (the delay
    passed straight through); > 1 means amplification (the delay also
    broke overlap/pipelining); < 1 means partial hiding.  Computed
    entirely in-record: the runs before the fault window are the clean
    baseline, the plan's declared per-step delay (delay magnitude +
    jitter/2, max over target ranks, step-scoped events) is the
    denominator.  NaN when the record has no delay fault, no clean
    runs, or a crash (a shrunk world has no comparable baseline)."""
    plan = _plan_of(rec)
    if plan is None:
        return float("nan")
    kinds = {e.kind for e in plan.events}
    if not kinds & {"delay", "jitter"} or kinds & {"crash", "partition"}:
        return float("nan")
    # per-step injected delay (faults/plan.py: max over target ranks —
    # parallel sleeps gate on the slowest rank, never on the sum)
    injected = plan.delay_per_step_us()
    window = _fault_run_window(rec)
    clean, faulted, measured_inj = [], [], []
    for row in rec.get("ranks", []):
        fd = row.get("fault_delay_us")
        for i, v in enumerate(row.get("runtimes", [])):
            if _run_faulted(window, i):
                faulted.append(v)
                if fd is not None and i < len(fd):
                    measured_inj.append(fd[i])
            else:
                clean.append(v)
    import statistics
    # prefer the MEASURED per-sample injected delay (the python tier's
    # fault_delay_us timer — already per-iteration, correct even when a
    # fence chain mixes clean and faulted steps) over the plan-declared
    # figure (exact on the native tier, where one sample = one step)
    if measured_inj and max(measured_inj) > 0:
        injected = statistics.median(measured_inj)
    if injected <= 0 or not clean or not faulted:
        return float("nan")
    return (statistics.median(faulted) - statistics.median(clean)) / injected


def bus_factor(kind: str, n: int) -> float:
    n = max(int(n), 1)
    if kind == "allreduce":
        return 2 * (n - 1) / n
    if kind in ("allgather", "reduce_scatter", "alltoall"):
        return (n - 1) / n
    if kind == "p2p":
        return 1.0
    raise ValueError(f"unknown collective kind {kind!r}")


def effective_bandwidth(records: list[dict]):
    """JSON run records (metrics/emit.py schema) -> one row per
    (section, model, rank, run, timer) with time_us, msg_bytes,
    algbw_GBps, busbw_GBps.  Records without a ``comm_model`` (or timers
    that never ran / zero times) contribute nothing."""
    import pandas as pd

    rows = []
    for rec in records:
        g = rec.get("global", {})
        model = g.get("comm_model")
        if not model:
            continue
        transport = transport_of(rec)
        # fault provenance (faults/, native fault_plan.hpp): runs inside
        # the plan's live window get busbw REFUSED (bound "faulted",
        # like the fullmesh refusal — a step serialized behind an
        # injected sleep, or running on a shrunken group the declared
        # comm_model no longer describes, prices recovery, not fabric
        # bandwidth); the recovery-cost and straggler-amplification
        # figures ride every row so the summary can state them
        fault_window = _fault_run_window(rec)
        detection_ms = float(g.get("detection_ms", float("nan")))
        recovery_ms = float(g.get("recovery_ms", float("nan")))
        straggler_amp = straggler_amplification(rec)
        # elastic-recovery columns (faults/policy.py run_faulted with a
        # CheckpointPolicy): what periodic saves cost, what the
        # eviction's restore cost, how much work was redone, and the
        # arc's bottom line — useful steps per wall second.  NaN on
        # records that never checkpointed.
        ckpt_cols = {
            "checkpoint_ms": float(g.get("checkpoint_ms", float("nan"))),
            "restore_ms": float(g.get("restore_ms", float("nan"))),
            "lost_steps": float(g.get("lost_steps", float("nan"))),
            "goodput": float(g.get("goodput", float("nan"))),
        }
        # attribution verdict + fractions (analysis/attribution.py,
        # stamped by emit/merge): every bandwidth row says what bound
        # the run it came from; records without a block get NaN/"n/a"
        attr = g.get("attribution") or {}
        attr_fr = attr.get("fractions") or {}
        attr_bound = attr.get("bound") or "n/a"
        attr_cols = {
            "attr_bound": attr_bound,
            "attr_compute": float(attr_fr.get("compute", float("nan"))),
            "attr_hbm": float(attr_fr.get("hbm", float("nan"))),
            "attr_comm": float(attr_fr.get("comm_exposed", float("nan"))),
            "attr_host": float(attr_fr.get("host", float("nan"))),
        }
        # tuning provenance: "hits/consults" of the tuned-
        # config consult map the run recorded (metrics/emit), "-" on
        # untuned/v1 records — every bandwidth row says whether the run
        # it came from executed DB-tuned configs, like transport says
        # what moved its bytes
        tun = g.get("tuning")
        tuned = (f"{int(tun.get('hits', 0))}/"
                 f"{int(tun.get('hits', 0)) + int(tun.get('misses', 0))}"
                 if isinstance(tun, dict) else "-")
        # MoE imbalance columns: measured expert-load
        # imbalance (max/mean of the routed-load fractions) and drop
        # rate of the run's routing — NaN on dense records, so a MoE
        # run's bandwidth rows always say how skewed its dispatch was
        moe = g.get("moe") or {}
        moe_cols = {
            "expert_imbalance": float(
                moe.get("load_imbalance", float("nan"))),
            "moe_drop_rate": float(
                moe.get("drop_rate", float("nan"))),
        }
        # critical-path blame (analysis/critical_path.py):
        # which rank's clock carried the excess, and how much of it —
        # per-rank signal exists only on records with genuinely
        # per-rank step series (native/merged multi-process runs);
        # single-controller records degrade to "-"/NaN
        from dlnetbench_tpu_torch.analysis.critical_path import blame_columns
        blame = blame_columns(rec)
        for rank_row in rec.get("ranks", []):
            # measured comm–compute overlap fraction (schema v2+,
            # proxies/base.py): one dimensionless sample per run, riding
            # every bandwidth row of that run so the summary can say how
            # much of the declared traffic was actually hidden
            ov = rank_row.get("overlap_fraction")
            for timer, components in model.items():
                times = rank_row.get(timer)
                if not times:
                    continue
                total = sum(c["bytes"] for c in components)
                bus_total = sum(c["bytes"] * bus_factor(c["kind"],
                                                        c["group"])
                                for c in components)
                # a component may declare its figure a lower bound (e.g.
                # the native engine's pp_comm: middle stages bracket both
                # their recv and send in the timer, so busbw reads ~2x
                # low there) — surfaced as a column, not a code comment
                bound = ("lower" if any(c.get("bound") == "lower"
                                        for c in components) else "exact")
                # Records from the legacy gather-based hierarchical DCN
                # legs moved padded member blocks / all-G-block AR legs
                # — bytes no real DCN algorithm moves — so NO correction
                # factor describes them: refuse busbw outright.  Current
                # hier records stamp dcn_algo "blocked" (bandwidth-true
                # direct exchange, hier_fabric.hpp header) and stay
                # admissible.
                dcn_algo = g.get("dcn_algo")
                if dcn_algo == "hierarchical":
                    bound = "hierarchical"
                # TCP-tier allreduces below the ring threshold ran the
                # pairwise FULL MESH — (n-1) x count on the wire, an
                # algorithm no real fabric runs — so the ring-model
                # busbw correction does not describe them: refuse the
                # figure instead of publishing a wrong one.  The
                # threshold is per MESSAGE, so aggregated multi-op
                # timers divide by their declared op count; 2-rank
                # meshes are exempt (mesh and ring wire cost coincide
                # at n=2, which is also why the fabric never rings
                # there).  On hier records the mesh in question is the
                # DCN leg among the PROCESSES (same element count as the
                # group op): components stamped with their split's real
                # spanning process count ("span", axis_span_procs in
                # schedule.hpp) use it directly — a group contained in
                # one process (span 1) never touches the DCN and is
                # never refused; older records without the stamp fall
                # back to the record-global num_processes, which can
                # only over-refuse, never admit a wrong figure.
                ring_thr = g.get("tcp_ring_threshold_bytes")
                if ring_thr is not None and bound != "hierarchical":
                    def _mesh_n(c):
                        if dcn_algo != "blocked":
                            return int(c["group"])
                        # last-resort group fallback: a blocked record
                        # stripped of num_processes must stay refused
                        # (over-refuse, never admit)
                        return int(c.get("span")
                                   or g.get("num_processes", 0)
                                   or c["group"])
                    fullmesh = any(
                        c["kind"] == "allreduce"
                        and _mesh_n(c) > 2
                        and c["bytes"] / max(int(c.get("ops", 1)),
                                             1) < ring_thr
                        for c in components)
                    if fullmesh:
                        bound = "fullmesh"
                for run, t_us in enumerate(times):
                    if not t_us > 0:
                        continue
                    run_bound = ("faulted"
                                 if _run_faulted(fault_window, run)
                                 else bound)
                    rows.append({
                        "section": rec.get("section"),
                        "model": g.get("model"),
                        "rank": rank_row.get("rank"),
                        "run": run,
                        "collective": timer.removesuffix("_time"),
                        "group_size": max(int(c["group"])
                                          for c in components),
                        "msg_bytes": float(total),
                        "time_us": float(t_us),
                        "algbw_GBps": total / (t_us * 1e-6) / 1e9,
                        "busbw_GBps": (float("nan")
                                       if run_bound in ("fullmesh",
                                                        "hierarchical",
                                                        "faulted")
                                       else bus_total / (t_us * 1e-6)
                                       / 1e9),
                        "bound": run_bound,
                        "transport": transport,
                        "tuned": tuned,
                        "overlap": (float(ov[run])
                                    if ov is not None and run < len(ov)
                                    else float("nan")),
                        "detection_ms": detection_ms,
                        "recovery_ms": recovery_ms,
                        "straggler_amp": straggler_amp,
                        **ckpt_cols,
                        **attr_cols,
                        **moe_cols,
                        **blame,
                    })
    return pd.DataFrame(rows)


def serving_summary(records: list[dict]):
    """One row per SERVING record (serving/, record global ``serving``):
    the latency-vs-offered-load table — offered/measured request rates,
    tokens/s, TTFT/TPOT/e2e percentiles, goodput-at-SLO — with the same
    provenance discipline as the bandwidth table: ``transport`` says
    what moved the bytes, the fault columns (``straggler_amp`` via the
    plan's declared delay against the e2e medians is NOT computable
    here — serving latency is queue-coupled — so the plan's injected
    delay and the recovery costs ride raw), and records without a
    serving block contribute nothing.  Training records flow through
    ``effective_bandwidth``/``bandwidth_summary`` unchanged; this is
    the serving tier's summary in the same module so one analysis
    import covers both."""
    import pandas as pd

    rows = []
    for rec in records:
        g = rec.get("global", {})
        srv = g.get("serving")
        if not isinstance(srv, dict):
            continue
        plan = g.get("fault_plan") or {}
        kinds = "+".join(sorted({e.get("kind", "?")
                                 for e in plan.get("events", [])}))
        row = {
            "section": rec.get("section"),
            "model": g.get("model"),
            "transport": transport_of(rec),
            "world": len(rec.get("ranks", [])),
            "offered_rps": srv.get("offered_rps"),
            "measured_rps": srv.get("measured_rps"),
            "completed": srv.get("completed"),
            "tokens_per_s": srv.get("tokens_per_s"),
            "goodput_rps": srv.get("goodput_rps"),
            "goodput_frac": srv.get("goodput_frac"),
            "queue_depth_max": srv.get("queue_depth_max"),
            "batch_occupancy_mean": srv.get("batch_occupancy_mean"),
            "fault": kinds or "-",
            "detection_ms": float(g.get("detection_ms", float("nan"))),
            "recovery_ms": float(g.get("recovery_ms", float("nan"))),
            "injected_delay_us": float(
                g.get("fault_injected_delay_us", float("nan"))),
        }
        for base in ("ttft_ms", "tpot_ms", "e2e_ms"):
            pcts = srv.get(base) or {}
            for p in ("p50", "p95", "p99"):
                row[f"{base[:-3]}_{p}_ms"] = float(
                    pcts.get(p, float("nan")))
        # MoE decode provenance: the skew knob + measured
        # imbalance and overflow-round cost ride every serving row —
        # the columns the latency-vs-imbalance study grids by.  NaN /
        # "-" on dense engines.
        moe = g.get("moe") or {}
        cfg_srv = g.get("serving_config") or {}
        row["moe_skew"] = float(cfg_srv.get("moe_skew", float("nan")))
        row["expert_imbalance"] = float(
            moe.get("load_imbalance", float("nan")))
        row["moe_rounds_mean"] = float(
            moe.get("rounds_mean", float("nan")))
        # disaggregation provenance: the replica split and
        # the migration wire cost ride every serving row — a Pareto
        # table must say which rows paid a migration channel and which
        # ran monolithic.  False / 0-ranks / NaN on monolithic and
        # pre-disagg records.
        row["disaggregated"] = bool(g.get("disaggregated", False))
        row["prefill_ranks"] = int(cfg_srv.get("prefill_ranks", 0))
        row["decode_ranks"] = int(cfg_srv.get("decode_ranks", 0))
        mig = srv.get("migration") or {}
        row["migration_bytes"] = float(
            mig.get("bytes", float("nan")))
        row["migration_bytes_ratio"] = float(
            mig.get("bytes_ratio_vs_bf16", float("nan")))
        ms = mig.get("ms") or {}
        row["migration_ms_p50"] = float(ms.get("p50", float("nan")))
        row["migration_overlap"] = float(
            mig.get("overlap", float("nan")))
        # fleet provenance: the routing policy, fleet width
        # and chip-second-normalized goodput ride every serving row —
        # an equal-chips policy A/B grids by these next to the latency
        # axes.  "-" / 1 / NaN on single-engine and pre-fleet records.
        flt = g.get("fleet") or {}
        row["routing"] = str(g.get("fleet_routing", "-"))
        row["replicas"] = int(g.get("fleet_replicas", 1))
        row["goodput_per_chip_s"] = float(
            flt.get("slo_goodput_per_chip_s", float("nan")))
        row["chip_seconds_saved"] = float(
            flt.get("chip_seconds_saved", float("nan")))
        rows.append(row)
    return pd.DataFrame(rows)


def bandwidth_summary(records: list[dict]):
    """Mean per (section, model, collective): the north-star table.
    Carries the ``bound`` marker so lower-bound rows stay labeled, the
    ``transport`` provenance so a loopback/virtual-mesh mean can never
    be averaged into (or mistaken for) a fabric figure, the mean
    measured ``overlap`` fraction (NaN where the record's run didn't
    measure the A/B decomposition) so every bandwidth figure says how
    much of that traffic compute actually hid, and the fault columns —
    ``straggler_amp`` (observed inflation / injected delay),
    ``detection_ms`` / ``recovery_ms`` (the priced crash-recovery path)
    and the elastic-recovery set ``checkpoint_ms`` / ``restore_ms`` /
    ``lost_steps`` / ``goodput`` (analysis/goodput.py reads the same
    fields) — NaN on clean records.  Faulted runs group under
    bound="faulted" with busbw refused, keeping the clean runs' mean
    uncontaminated."""
    bw = effective_bandwidth(records)
    if bw.empty:
        return bw
    return (bw.groupby(["section", "model", "collective", "group_size",
                        "bound", "transport", "tuned", "attr_bound",
                        "blame_rank"])
            [["time_us", "msg_bytes", "algbw_GBps", "busbw_GBps",
              "overlap", "straggler_amp", "detection_ms", "recovery_ms",
              "checkpoint_ms", "restore_ms", "lost_steps", "goodput",
              "attr_compute", "attr_hbm", "attr_comm", "attr_host",
              "expert_imbalance", "moe_drop_rate",
              "blame_frac"]]
            .mean().reset_index())
