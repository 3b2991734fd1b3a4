"""Bottleneck attribution: what bound this run — the card's SMs, HBM,
NVLink, the network, the host? (The port's copy of the JAX package's
``analysis/attribution.py``, with a GPU vocabulary.)

The block (rides ``global.attribution`` on records and
``line["attribution"]`` on bench JSON lines)::

    {"fractions": {"compute": .., "hbm": .., "comm_exposed": .., "host": ..},
     "bound": "sm"|"mxu"|"hbm"|"nvlink"|"network"|"ici"|"dcn"|"host"
              |"faulted",
     "achieved": {"sm": {...}, "hbm": {...}, "comm": {...}},    # vs roofline
     "top_ops": [{"op": .., "total_us": ..}, ...],              # device trace
     "inputs": {...}}                                           # provenance

Fraction semantics (they sum to 1 by construction, each a share of the
measured wall-clock):

* ``compute``       — time the work would take at the compute peak
  (``flops / peak``), or the measured compute-only leg where nothing
  prices the work (``inputs.compute_basis = "measured"``).
* ``hbm``           — modeled HBM busy time NOT hidden behind compute
  (``max(0, bytes/BW - flops/peak)``).
* ``comm_exposed``  — MEASURED exposed communication (the decomposition
  channel's ``barrier_time``), never a model.
* ``host``          — the residual nothing above explains: dispatch,
  fences, host-side work.

The verdict word follows the hardware that ran the work: a card's
compute is ``sm`` and a TPU's ``mxu`` (each preset's ``compute_unit``);
NCCL between the cards of one host is ``nvlink``, NCCL across hosts
``network``; a TPU record keeps ``ici`` and ``dcn``; one device alone
(``local``), loopback between CPU processes (``virtual-host``, gloo) and
shared memory are ``host``.  ``achieved`` is keyed by the same compute
word.  So on the JAX package's records and bench lines the blocks equal
its own, key for key.

The port's records carry no compiler cost analysis, so a card record is
priced from its measured compute leg: ``compute_basis: "measured"``,
compute-bound verdict ``sm`` (a CPU record's is ``host``).  A one-device
record (transport ``local``) moved no bytes over any wire and carries no
``achieved.comm``.

CLI::

    python -m dlnetbench_tpu_torch.analysis.attribution explain PATH [--top N]

renders a per-run bottleneck report from a bench capture (a JSON object
with ``parsed``/``tail``), a bench stdout JSONL, or a records JSONL.
"""
from __future__ import annotations

import json
import re
import statistics
import sys
from pathlib import Path

from dlnetbench_tpu_torch.core.hardware import (HARDWARE, HardwareSpec,
                                                hw_key_for_device)

RESOURCES = ("compute", "hbm", "comm_exposed", "host")
BOUNDS = ("sm", "mxu", "hbm", "nvlink", "network", "ici", "dcn", "host",
          "faulted")
COMM_BOUNDS = ("nvlink", "network", "ici", "dcn")

# Assumed per-host DCN NIC peak for achieved-vs-peak on tcp/dcn
# transports: 100 GbE.  A stated assumption, not a measurement — it
# rides the block as ``achieved.comm.peak_GBps`` so a reader sees what
# the fraction was computed against.
DCN_PEAK_BYTES_S = 12.5e9
# The same stated NIC assumption for NCCL across hosts (``network``).
NETWORK_PEAK_BYTES_S = 12.5e9

# f32 buffers execute on the bf16 MXU path (no TPU f32 matmul peak in
# the table); the approximation is recorded in ``inputs.dtype``
_DTYPE_PEAK_FALLBACK = {"float32": "bfloat16"}


def comm_resource(transport: str | None) -> str:
    """Verdict name for comm-bound time on a transport: the network leg
    binds NCCL across hosts (``nccl+network``), NVLink binds NCCL inside
    one host; a TPU's DCN leg binds a composed ici+dcn path; one device
    alone (``local``), shm, loopback and virtual-host bytes are host
    memory, never fabric."""
    t = (transport or "").lower()
    if "network" in t:
        return "network"
    if "nccl" in t:
        return "nvlink"
    if "dcn" in t or t.startswith("tcp"):
        return "dcn"
    if "ici" in t:
        return "ici"
    return "host"


def transport_peak_bytes_s(transport: str | None,
                           hw: HardwareSpec | None) -> float | None:
    """Peak bytes/s of the transport's binding wire; None when there is
    no physical wire to compare against (loopback, shm, virtual mesh,
    a card without NVLink)."""
    res = comm_resource(transport)
    if res == "network":
        return NETWORK_PEAK_BYTES_S
    if res == "dcn":
        return DCN_PEAK_BYTES_S
    if res == "nvlink" and hw is not None and hw.nvlink_bandwidth:
        return hw.nvlink_bandwidth
    if res == "ici" and hw is not None and hw.ici_bandwidth:
        return hw.ici_bandwidth
    return None


def compute_unit(hw: HardwareSpec | None = None,
                 platform: str | None = None) -> str:
    """The verdict word for compute on the hardware that ran the work:
    the preset's own (``sm`` for a card, ``mxu`` for a TPU), else the
    mesh platform's (``gpu`` -> ``sm``); ``mxu`` otherwise, as in the
    JAX package."""
    if hw is not None:
        return hw.compute_unit
    return "sm" if platform == "gpu" else "mxu"


def _peak(hw: HardwareSpec, dtype_key: str) -> float | None:
    key = _DTYPE_PEAK_FALLBACK.get(dtype_key, dtype_key)
    try:
        return hw.peak(key)
    except ValueError:
        return None


def _assemble(*, time_us: float, mxu_us: float | None, hbm_us: float | None,
              comm_us: float, measured_compute_us: float | None,
              transport: str | None, faulted: bool,
              achieved: dict | None, top_ops: list | None,
              inputs: dict | None, on_accelerator: bool = False,
              unit: str = "mxu") -> dict | None:
    """Fractions + verdict from busy-time estimates.  ``mxu_us``/
    ``hbm_us`` are roofline-ideal busy times (None = unpriced),
    ``comm_us`` is measured exposed comm, the residual is ``host``.
    A compute-dominant run maps to ``unit`` (``sm``, ``mxu``) only when
    it ran on real accelerator silicon (priced by a roofline, or
    ``on_accelerator``); a virtual/host mesh's compute time is host
    cores and says so."""
    T = float(time_us)
    if not T > 0:
        return None
    priced = mxu_us is not None or hbm_us is not None
    if priced:
        compute = (mxu_us or 0.0) / T
        hbm = max(0.0, (hbm_us or 0.0) - (mxu_us or 0.0)) / T
        basis = "roofline"
    elif measured_compute_us is not None:
        compute = max(0.0, measured_compute_us) / T
        hbm = 0.0
        basis = "measured"
    else:
        compute = hbm = 0.0
        basis = "none"
    comm = max(0.0, comm_us) / T
    total = compute + hbm + comm
    if total > 1.0:
        # the model over-explains the measurement (e.g. an above-peak
        # short-chain reading): scale the explained shares down instead
        # of shipping fractions that don't sum to 1
        compute, hbm, comm = (v / total for v in (compute, hbm, comm))
        host = 0.0
    else:
        host = 1.0 - total
    fractions = {"compute": round(compute, 4), "hbm": round(hbm, 4),
                 "comm_exposed": round(comm, 4), "host": round(host, 4)}
    if faulted:
        bound = "faulted"
    else:
        top = max(fractions, key=fractions.get)
        bound = {"compute": (unit if basis == "roofline" or on_accelerator
                             else "host"),
                 "hbm": "hbm",
                 "comm_exposed": comm_resource(transport),
                 "host": "host"}[top]
    out: dict = {"fractions": fractions, "bound": bound}
    if achieved:
        out["achieved"] = achieved
    if top_ops:
        out["top_ops"] = top_ops
    inputs = dict(inputs or {})
    inputs.setdefault("time_us", round(T, 1))
    inputs["compute_basis"] = basis
    if transport:
        inputs.setdefault("transport", transport)
    out["inputs"] = inputs
    return out


def attribute_kernel(time_s: float, flops: float, nbytes: float,
                     hw: HardwareSpec, dtype_key: str, *,
                     comm_us: float = 0.0, transport: str | None = None,
                     faulted: bool = False, peak_flops: float | None = None,
                     source: str = "model",
                     extra_inputs: dict | None = None) -> dict | None:
    """Attribution for a measured kernel/step with an explicit FLOP and
    HBM-byte model (the bench lines).  ``peak_flops`` overrides the
    dtype-table peak for mixed-precision steps (the int8-step split
    roofline)."""
    peak = peak_flops if peak_flops else _peak(hw, dtype_key)
    if peak is None or not time_s > 0:
        return None
    t_us = time_s * 1e6
    mxu_us = float(flops) / peak * 1e6
    hbm_us = float(nbytes) / hw.hbm_bandwidth * 1e6
    achieved = {
        hw.compute_unit: {"rate_tflops": round(flops / time_s / 1e12, 2),
                "peak_tflops": round(peak / 1e12, 1),
                "frac": round(flops / time_s / peak, 4)},
        "hbm": {"rate_GBps": round(nbytes / time_s / 1e9, 2),
                "peak_GBps": round(hw.hbm_bandwidth / 1e9, 1),
                "frac": round(nbytes / time_s / hw.hbm_bandwidth, 4)},
    }
    inputs = {"flops": float(flops), "bytes": float(nbytes),
              "dtype": dtype_key, "hw": hw.name, "source": source,
              **(extra_inputs or {})}
    return _assemble(time_us=t_us, mxu_us=mxu_us, hbm_us=hbm_us,
                     comm_us=comm_us, measured_compute_us=None,
                     transport=transport, faulted=faulted,
                     achieved=achieved, top_ops=None, inputs=inputs,
                     unit=hw.compute_unit)


# -- bench JSON lines --------------------------------------------------

_METRIC_HW_RE = re.compile(r"\((tpu_\w+?|b200|h100_sxm|h100_pcie)[,)]")


def _line_dtype(metric: str) -> str:
    m = metric.lower()
    if m.startswith("fp8"):
        return "float8"
    if m.startswith("int8 matmul"):
        return "int8"
    return "bfloat16"


def attribute_line(line: dict) -> dict | None:
    """Attribution for a bench JSON line from its OWN keys — the legacy
    pathway for committed artifacts that predate stamping (BENCH_r01-05).

    The line states its achieved rate (``tflops_achieved`` /
    ``tops_achieved``) and how much of its time the roofline model
    explains (``vs_baseline`` = roofline time / measured time); the hw
    key and peak ride the metric text.  ``rate/peak`` is the compute
    share, ``max(0, vs_baseline - rate/peak)`` the memory share the
    model priced beyond what the MXU hides, and ``1 - vs_baseline`` the
    share the roofline cannot explain — host.  New lines carry a
    stamped block (preferred, returned verbatim)."""
    metric = str(line.get("metric", ""))
    value = line.get("value")
    if line.get("unit") != "ms" or not isinstance(value, (int, float)):
        # non-ms lines (the straggler amplification ratio) may carry a
        # stamped block for readers, but they have no wall-clock for
        # the explain report to render against
        return None
    if isinstance(line.get("attribution"), dict):
        return line["attribution"]
    m = _METRIC_HW_RE.search(metric)
    hw = HARDWARE.get(m.group(1)) if m else None
    rate = line.get("tflops_achieved", line.get("tops_achieved"))
    vsb = line.get("vs_baseline")
    if hw is None or rate is None or vsb is None:
        return None
    dtype_key = _line_dtype(metric)
    peak = _peak(hw, dtype_key)
    if not peak:
        return None
    t_us = float(value) * 1e3
    mxu_frac = min(float(rate) * 1e12 / peak, 1.0)
    model_frac = float(vsb)
    hbm_frac = max(0.0, model_frac - mxu_frac)
    achieved = {hw.compute_unit: {"rate_tflops": float(rate),
                        "peak_tflops": round(peak / 1e12, 1),
                        "frac": round(mxu_frac, 4)}}
    if hbm_frac > 0:
        achieved["hbm"] = {"frac": round(min(model_frac, 1.0), 4),
                           "peak_GBps": round(hw.hbm_bandwidth / 1e9, 1)}
    return _assemble(time_us=t_us, mxu_us=mxu_frac * t_us,
                     hbm_us=(mxu_frac + hbm_frac) * t_us, comm_us=0.0,
                     measured_compute_us=None, transport=None,
                     faulted=bool(line.get("fault_plan")),
                     achieved=achieved, top_ops=None,
                     inputs={"dtype": dtype_key, "hw": hw.name,
                             "source": "line"}, unit=hw.compute_unit)


def straggler_block(clean_ms: float, faulted_ms: float,
                    injected_ms: float) -> dict | None:
    """Attribution for a faulted-vs-clean A/B line: the clean step time
    is the compute share of the faulted wall, the injected-stall
    inflation is host time, the verdict is ``faulted`` by scripting."""
    if not faulted_ms > 0:
        return None
    compute = min(clean_ms / faulted_ms, 1.0)
    block = {
        "fractions": {"compute": round(compute, 4), "hbm": 0.0,
                      "comm_exposed": 0.0,
                      "host": round(max(0.0, 1.0 - compute), 4)},
        "bound": "faulted",
        "inputs": {"time_us": round(faulted_ms * 1e3, 1),
                   "injected_us": round(injected_ms * 1e3, 1),
                   "compute_basis": "measured", "source": "straggler_ab"},
    }
    return block


def attribute_decomposition(full_s: list[float], compute_s: list[float],
                            comm_s: list[float] | None = None,
                            transport: str | None = None,
                            on_accelerator: bool = False,
                            unit: str = "mxu") -> dict | None:
    """Attribution from a measured full/compute/comm A/B decomposition
    alone (matched samples in seconds, proxies/base.py protocol):
    exposed comm is the matched-sample median of ``full - compute``,
    compute is measured, the residual is host; ``unit`` names the
    compute of an ``on_accelerator`` run (``sm`` on a card)."""
    if not full_s or not compute_s:
        return None
    T = statistics.median(full_s) * 1e6
    exposed = [max(0.0, f - c) for f, c in zip(full_s, compute_s)]
    comm_us = statistics.median(exposed) * 1e6 if exposed else 0.0
    inputs = {"source": "decomposition"}
    if comm_s:
        inputs["comm_wire_us"] = round(statistics.median(comm_s) * 1e6, 1)
    return _assemble(time_us=T, mxu_us=None, hbm_us=None, comm_us=comm_us,
                     measured_compute_us=statistics.median(compute_s) * 1e6,
                     transport=transport, faulted=False, achieved=None,
                     top_ops=None, inputs=inputs,
                     on_accelerator=on_accelerator, unit=unit)


# -- serving decode-loop dispatch decomposition -------------

def serving_host_us(decode_loop: dict,
                    dispatch_floor_us: float = 0.0) -> float:
    """The host side of a serving run's wall from its priced
    crossings: per-dispatch host overhead + both sync directions,
    plus ``dispatches * dispatch_floor_us`` when a measured per-
    dispatch floor is available (``dispatch_decomposition``) — the
    fold that makes decode steps-per-dispatch a first-class host-
    fraction lever: N fused steps pay ONE floor."""
    h = float((decode_loop.get("host_dispatch_us") or {})
              .get("total", 0.0))
    h += float((decode_loop.get("sync_h2d_us") or {}).get("total", 0.0))
    h += float((decode_loop.get("sync_d2h_us") or {}).get("total", 0.0))
    return h + float(decode_loop.get("dispatches", 0)) \
        * dispatch_floor_us


def dispatch_decomposition(one_step: dict,
                           multi_step: dict) -> dict | None:
    """Solve the per-dispatch overhead out of a PAIRED 1-step vs
    N-step measurement (the serving A/B's two-point system):
    per-device-step wall in 1-step mode is ``silicon + floor``, in
    fused mode ``silicon + floor / steps_per_dispatch`` — the fused
    loop IS the measurement instrument for dispatch cost (the same
    idea as the r6 chained-fence timing, applied to serving).
    Returns ``{dispatch_us, silicon_us_per_step, steps_per_dispatch}``
    or None when the pair is degenerate (no fused amortization, or
    missing fields).  Divides by the DECODE-only device leg
    (``decode_device_us``) so prefill calls — device time but not
    decode steps — cannot inflate the solve; ``device_us`` (which
    includes prefill) is the fallback for blocks that predate the
    split.  Caveat: on an ASYNC backend, inline-mode prefill chunks
    are dispatch-acknowledged, not fenced (scheduler._prefill_one), so
    their queued compute can complete inside the next decode window —
    feed this solver separate-prefill rounds (the bench A/B does)."""
    def _per_step(block: dict) -> float:
        dev = block.get("decode_device_us") or block["device_us"]
        return float(dev["total"]) / block["device_steps"]

    try:
        d1 = _per_step(one_step)
        dn = _per_step(multi_step)
        spd = float(multi_step["steps_per_dispatch"])
    except (KeyError, TypeError, ZeroDivisionError):
        return None
    if spd <= 1.0:
        return None
    floor = max(0.0, (d1 - dn) / (1.0 - 1.0 / spd))
    return {"dispatch_us": round(floor, 1),
            "silicon_us_per_step": round(max(0.0, d1 - floor), 1),
            "steps_per_dispatch": round(spd, 3)}


def attribute_serving(rec: dict) -> dict | None:
    """Attribution for a serving record from its own dispatch
    decomposition: the engine prices every host<->device
    crossing — per-dispatch host overhead (``host_dispatch_us``, wall
    minus the compiled-call leg) and the admission syncs — and
    measures the device-program leg, so ``compute`` is the measured
    device share of the wall and the residual (dispatch overhead,
    syncs, admission bookkeeping, queue idle) is ``host``.  The
    compute basis is MEASURED: a virtual/CPU mesh can never verdict
    ``sm`` or ``mxu`` (``on_accelerator`` only on a ``gpu`` or ``tpu``
    platform).  Single records carry no dispatch floor."""
    g = rec.get("global", {})
    srv = g.get("serving") or {}
    dl = srv.get("decode_loop")
    wall_s = srv.get("wall_s")
    if not isinstance(dl, dict) or not wall_s:
        return None
    T = float(wall_s) * 1e6
    host_us = serving_host_us(dl)
    dev_us = float((dl.get("device_us") or {}).get("total", 0.0))
    inputs = {"source": "serving_dispatch",
              "multi_step_n": dl.get("multi_step_n"),
              "dispatches": dl.get("dispatches"),
              "steps_per_dispatch": dl.get("steps_per_dispatch"),
              "tokens_per_sync": dl.get("tokens_per_sync"),
              "host_dispatch_us": round(host_us, 1)}
    spec = dl.get("spec")
    if isinstance(spec, dict):
        inputs["spec_acceptance_rate"] = spec.get("acceptance_rate")
    faulted = bool((g.get("fault_plan") or {}).get("events"))
    mesh = rec.get("mesh", {})
    hw_key = hw_key_for_device(mesh.get("device_kind"))
    return _assemble(time_us=T, mxu_us=None, hbm_us=None, comm_us=0.0,
                     measured_compute_us=dev_us, transport=None,
                     faulted=faulted, achieved=None, top_ops=None,
                     inputs=inputs,
                     on_accelerator=mesh.get("platform") in ("tpu", "gpu"),
                     unit=compute_unit(HARDWARE.get(hw_key),
                                       mesh.get("platform")))


# -- proxy / sweep / native records ------------------------------------

def _pooled(rows: list[dict], timer: str) -> list[float]:
    vals: list[float] = []
    for r in rows:
        v = r.get(timer)
        if isinstance(v, list):
            vals.extend(float(x) for x in v)
    return vals


def attribute_record(rec: dict) -> dict | None:
    """Attribution for one run record (metrics/emit.py schema, either
    tier): joins the AOT ``cost_analysis`` with the chip preset where
    the mesh names one, the measured decomposition timers, the declared
    ``comm_model`` bytes against the transport's peak, and the device-
    trace occupancy when ``--profile`` captured one.  Returns None when
    the record carries no usable runtime samples.  Serving records
    attribute from their dispatch decomposition instead —
    their per-rank timers are request latencies, not step runtimes."""
    g = rec.get("global", {})
    if isinstance(g.get("serving"), dict):
        return attribute_serving(rec)
    rows = rec.get("ranks") or []
    runtimes = _pooled(rows, "runtimes")
    if not runtimes:
        return None
    T = statistics.median(runtimes)
    if not T > 0:
        return None
    barrier = _pooled(rows, "barrier_time")
    comm_us = statistics.median(barrier) if barrier else 0.0
    compute_t = _pooled(rows, "compute_time")
    measured_compute = statistics.median(compute_t) if compute_t else None

    mesh = rec.get("mesh", {})
    hw_key = hw_key_for_device(mesh.get("device_kind"))
    hw = HARDWARE.get(hw_key) if hw_key else None
    unit = compute_unit(hw, mesh.get("platform"))
    cost = ((g.get("aot") or {}).get("full") or {}).get("cost_analysis") or {}
    flops = cost.get("flops")
    nbytes = cost.get("bytes_accessed")
    dtype_key = str(g.get("buffer_dtype") or "bfloat16")

    mxu_us = hbm_us = None
    achieved: dict = {}
    source = "timers"
    if hw is not None and flops:
        peak = _peak(hw, dtype_key)
        if peak:
            mxu_us = float(flops) / peak * 1e6
            achieved[unit] = {
                "rate_tflops": round(flops / (T * 1e-6) / 1e12, 3),
                "peak_tflops": round(peak / 1e12, 1),
                "frac": round(flops / (T * 1e-6) / peak, 4)}
            source = "cost_analysis"
    if hw is not None and nbytes:
        hbm_us = float(nbytes) / hw.hbm_bandwidth * 1e6
        achieved["hbm"] = {
            "rate_GBps": round(nbytes / (T * 1e-6) / 1e9, 3),
            "peak_GBps": round(hw.hbm_bandwidth / 1e9, 1),
            "frac": round(nbytes / (T * 1e-6) / hw.hbm_bandwidth, 4)}
        source = "cost_analysis"

    from dlnetbench_tpu_torch.analysis.bandwidth import transport_of
    transport = transport_of(rec)

    # achieved fabric bandwidth vs the transport's peak, from the
    # proxy-declared comm_model bytes over the directly-timed comm leg;
    # a one-device run (``local``) moved nothing over any wire
    model = (g.get("comm_model") or {}).get("comm_time")
    comm_times = _pooled(rows, "comm_time")
    if model and comm_times and transport != "local":
        t_comm = statistics.median(comm_times)
        if t_comm > 0:
            total_bytes = sum(float(c.get("bytes", 0)) for c in model)
            rate = total_bytes / (t_comm * 1e-6)
            comm_ach = {"rate_GBps": round(rate / 1e9, 3),
                        "transport": transport}
            peak_bw = transport_peak_bytes_s(transport, hw)
            if peak_bw:
                comm_ach["peak_GBps"] = round(peak_bw / 1e9, 2)
                comm_ach["frac"] = round(rate / peak_bw, 4)
            achieved["comm"] = comm_ach

    # per-op names when --profile stamped them (metrics/profiling.py
    # top_device_ops); the kind-level occupancy summary as fallback for
    # records that predate the per-op channel
    top_ops = None
    device_top = g.get("device_top_ops")
    profile = g.get("profile")
    if isinstance(device_top, list) and device_top:
        top_ops = device_top[:5]
    elif isinstance(profile, dict) and profile:
        top_ops = [{"op": kind, "total_us": round(s.get("total_us", 0.0), 1),
                    "count": s.get("count", 0)}
                   for kind, s in sorted(profile.items(),
                                         key=lambda kv: -kv[1].get(
                                             "total_us", 0.0))][:5]

    faulted = bool((g.get("fault_plan") or {}).get("events"))
    # checkpoint stalls ride INSIDE the timed window (faults/policy.py
    # wires the save after the step, on purpose) and are neither
    # compute, HBM, nor fabric time — they land in the host residual by
    # construction.  Stamp the measured per-save stall so the block
    # SAYS what part of that host share is checkpointing, instead of
    # leaving it to read as unexplained dispatch overhead.
    ckpt_inputs = {}
    if isinstance(g.get("checkpoint_stall_ms"), (int, float)):
        ckpt_inputs["checkpoint_stall_us"] = round(
            float(g["checkpoint_stall_ms"]) * 1e3, 1)
        if g.get("checkpoint_every"):
            ckpt_inputs["checkpoint_every"] = int(g["checkpoint_every"])
    inputs = {"source": source, "hw": hw_key, **ckpt_inputs,
              **({"flops": float(flops)} if flops else {}),
              **({"bytes": float(nbytes)} if nbytes else {}),
              **({"dtype": dtype_key} if hw is not None else {}),
              **({"host_rtt_us": g["host_rtt_us"]}
                 if "host_rtt_us" in g else {})}
    return _assemble(time_us=T, mxu_us=mxu_us, hbm_us=hbm_us,
                     comm_us=comm_us, measured_compute_us=measured_compute,
                     transport=transport, faulted=faulted,
                     achieved=achieved or None, top_ops=top_ops,
                     inputs=inputs,
                     on_accelerator=mesh.get("platform") in ("tpu", "gpu"),
                     unit=unit)


# -- explain CLI -------------------------------------------------------

def load_artifact(path: str | Path) -> tuple[list[dict], dict | None]:
    """All top-level JSON objects in ``path`` (file order) plus the
    bench capture's ``parsed`` object when present.  The ONE place
    that knows the three artifact shapes — a bench capture (.json
    carrying ``parsed``/``tail``), a stdout/records JSONL, a single
    JSON object — so the explain CLI and the regression sentinel
    (sentinel.bench_lines) can never disagree about what an artifact
    contains; each applies its own headline/record selection on top."""
    text = Path(path).read_text()
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        obj = None
    if isinstance(obj, dict) and ("parsed" in obj or "tail" in obj):
        objs: list[dict] = []
        for raw in (obj.get("tail") or "").splitlines():
            raw = raw.strip()
            if not raw.startswith("{"):
                continue
            try:
                objs.append(json.loads(raw))
            except json.JSONDecodeError:
                continue
        parsed = obj.get("parsed")
        return objs, parsed if isinstance(parsed, dict) else None
    if isinstance(obj, dict):
        return [obj], None
    objs = []
    for raw in text.splitlines():
        raw = raw.strip()
        if not raw:
            continue
        try:
            item = json.loads(raw)
        except json.JSONDecodeError:  # truncated/killed mid-write
            continue
        if isinstance(item, dict):
            objs.append(item)
    return objs, None


def _artifact_items(path: str | Path) -> tuple[list[dict], list[dict]]:
    """(bench lines, run records) found in ``path``."""
    objs, parsed = load_artifact(path)
    lines = [o for o in objs if "ranks" not in o]
    records = [o for o in objs if "ranks" in o]
    if parsed is not None and parsed.get("metric") not in {
            ln.get("metric") for ln in lines}:
        lines.append(parsed)
    # a headline line embeds its aux lines — surface the ones not
    # already printed standalone (old bench captures truncate tails)
    seen = {ln.get("metric") for ln in lines}
    for ln in list(lines):
        for v in ln.values():
            if (isinstance(v, dict) and v.get("metric") not in seen
                    and isinstance(v.get("value"), (int, float))
                    and v.get("unit") == "ms"):
                lines.append(v)
                seen.add(v.get("metric"))
    return lines, records


def _bar(frac: float, width: int = 24) -> str:
    n = max(0, min(width, round(frac * width)))
    return "#" * n + "." * (width - n)


def _render_block(out, label: str, time_us: float | None, attr: dict) -> None:
    fr = attr["fractions"]
    t = f"{time_us / 1e3:.3f} ms" if time_us else "?"
    print(f"\n- {label}", file=out)
    print(f"    time {t} | bound: {attr['bound'].upper()}", file=out)
    for r in RESOURCES:
        print(f"    {r:<13}{fr.get(r, 0.0):>7.2%}  [{_bar(fr.get(r, 0.0))}]",
              file=out)
    for res, a in (attr.get("achieved") or {}).items():
        parts = []
        if "rate_tflops" in a:
            parts.append(f"{a['rate_tflops']:.1f} TF/s"
                         f" / {a.get('peak_tflops', '?')} peak")
        if "rate_GBps" in a:
            parts.append(f"{a['rate_GBps']:.1f} GB/s"
                         + (f" / {a['peak_GBps']} peak"
                            if "peak_GBps" in a else ""))
        if "frac" in a:
            parts.append(f"= {a['frac']:.2f} of roofline")
        if "transport" in a:
            parts.append(f"({a['transport']})")
        if parts:
            print(f"    {res}: " + "  ".join(parts), file=out)
    for op in attr.get("top_ops") or []:
        print(f"    op {op['op']}: {op['total_us']} us "
              f"x{op.get('count', '?')}", file=out)
    ck = (attr.get("inputs") or {}).get("checkpoint_stall_us")
    if ck:
        print(f"    checkpoint stall: {ck / 1e3:.3f} ms per save "
              f"(every {attr['inputs'].get('checkpoint_every', '?')} "
              f"steps) — inside the host share", file=out)
    bound, host = attr["bound"], fr.get("host", 0.0)
    if bound == "host" and host > 0.3:
        print(f"    -> {host:.0%} of wall-clock unexplained by the "
              f"compute/memory roofline: host/dispatch/residency "
              f"overhead binds this run, not silicon", file=out)
    elif bound == "mxu":
        print("    -> compute-bound: the MXU is the binding resource",
              file=out)
    elif bound == "sm":
        print("    -> compute-bound: the SMs are the binding resource",
              file=out)
    elif bound == "hbm":
        print("    -> memory-bound: HBM traffic is the binding resource",
              file=out)
    elif bound in COMM_BOUNDS:
        print(f"    -> communication-bound: exposed {bound.upper()} time "
              f"is the binding resource", file=out)
    elif bound == "faulted":
        print("    -> faulted run: injected faults bind it; no resource "
              "verdict applies", file=out)


def explain(path: str | Path, out=None, top: int = 0) -> int:
    """Render the per-run bottleneck report for a committed artifact."""
    out = out or sys.stdout
    lines, records = _artifact_items(path)
    print(f"== bottleneck attribution: {path} ==", file=out)
    shown = 0
    for ln in lines:
        attr = attribute_line(ln)
        if attr is None:
            continue
        _render_block(out, str(ln.get("metric", "?")),
                      float(ln["value"]) * 1e3, attr)
        shown += 1
        if top and shown >= top:
            break
    for rec in records:
        attr = (rec.get("global", {}).get("attribution")
                or attribute_record(rec))
        if attr is None:
            continue
        g = rec.get("global", {})
        label = (f"{rec.get('section', '?')} / {g.get('model', '?')} "
                 f"(world {g.get('world_size', len(rec.get('ranks', [])))})")
        _render_block(out, label, attr.get("inputs", {}).get("time_us"),
                      attr)
        shown += 1
        if top and shown >= top:
            break
    if not shown:
        print("no attributable lines or records found", file=out)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m dlnetbench_tpu_torch.analysis.attribution",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    pe = sub.add_parser("explain", help="per-run bottleneck report")
    pe.add_argument("path", help="BENCH_r*.json bench capture, bench "
                                 "stdout JSONL, or records JSONL")
    pe.add_argument("--top", type=int, default=0,
                    help="show at most N entries (0 = all)")
    args = p.parse_args(argv)
    return explain(args.path, top=args.top)


if __name__ == "__main__":
    raise SystemExit(main())
