"""The port's serving at scale held against the JAX package on the CPU:
the config and device-count refusals, the migration-ETA cap of the
adaptive trip count, ``kv_shard`` engines, fault plans in
``run_serving`` (delays, fail_fast, crash + shrink), the shared re-queue
arc, and ``cli serve``'s scale flags.  JAX runs on its virtual CPU
devices (tests/conftest.py), the port on a repeated CPU device list;
every comparison of streams or fault timelines runs on
``scripted_clock.scripted``, so both packages admit and fault at the
same steps."""
from __future__ import annotations

import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch

import scripted_clock as SC
from dlnetbench_tpu.faults.inject import RankFailure as JRankFailure
from dlnetbench_tpu.faults.plan import FaultEvent as JEvent
from dlnetbench_tpu.faults.plan import FaultPlan as JFaultPlan
from dlnetbench_tpu.models import transformer as jtfm
from dlnetbench_tpu.serving import requeue as JRQ
from dlnetbench_tpu.serving import scheduler as JS
from dlnetbench_tpu.serving.arrivals import ArrivalPlan as JPlan
from dlnetbench_tpu.serving.arrivals import Request as JRequest
from dlnetbench_tpu_torch import cli as tcli
from dlnetbench_tpu_torch.faults.inject import RankFailure
from dlnetbench_tpu_torch.faults.plan import FaultEvent, FaultPlan
from dlnetbench_tpu_torch.models import transformer as ttfm
from dlnetbench_tpu_torch.serving import requeue as TRQ
from dlnetbench_tpu_torch.serving import scheduler as TS
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan as TPlan
from dlnetbench_tpu_torch.serving.arrivals import Request

CPU = torch.device("cpu")
MODEL = dict(vocab_size=64, embed_dim=32, num_heads=4, num_kv_heads=2,
             ff_dim=64, num_layers=2, seq_len=32)
SERVING = dict(slots=4, page_size=8, num_pages=16, max_seq_len=32,
               slo_ttft_ms=200.0, slo_tpot_ms=100.0, warmup_requests=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_model(**over):
    return jtfm.TransformerConfig(**{**MODEL, **over}, gated=True,
                                  max_positions=0, dtype="float32")


def torch_model(**over):
    return ttfm.TransformerConfig(**{**MODEL, **over}, dtype="float32")


@pytest.fixture(scope="module")
def weights():
    jp = jtfm.init_params(jax.random.key(0), jax_model())
    tp = ttfm.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def both_cfg(**over):
    kw = {**SERVING, **over}
    return JS.ServingConfig(**kw), TS.ServingConfig(**kw)


# ---------------------------------------------------------------------
# refusals: every config, fleet and device-count check, JAX's message

def _serving(pkg, **over):
    mod = JS if pkg == "jax" else TS
    return lambda: mod.ServingConfig(**{**SERVING, **over}).validate()


def _fleet(pkg, **over):
    if pkg == "jax":
        from dlnetbench_tpu.serving.fleet import FleetConfig
    else:
        from dlnetbench_tpu_torch.serving.fleet import FleetConfig
    return lambda: FleetConfig(**over).validate()


def _devices(pkg, n):
    return jax.devices()[:n] if pkg == "jax" else [CPU] * n


def _engine(pkg, n_dev, model=None, **over):
    def build():
        if pkg == "jax":
            JS.Engine(jax_model(**(model or {})),
                      JS.ServingConfig(**{**SERVING, **over}),
                      devices=_devices(pkg, n_dev))
        else:
            TS.Engine(torch_model(**(model or {})),
                      TS.ServingConfig(**{**SERVING, **over}),
                      devices=_devices(pkg, n_dev))
    return build


def _disagg(pkg, n_dev, **over):
    def build():
        if pkg == "jax":
            from dlnetbench_tpu.serving.disagg import DisaggServer
            DisaggServer(jax_model(), JS.ServingConfig(**{**SERVING,
                                                          **over}),
                         devices=_devices(pkg, n_dev))
        else:
            from dlnetbench_tpu_torch.serving.disagg import DisaggServer
            DisaggServer(torch_model(), TS.ServingConfig(**{**SERVING,
                                                            **over}),
                         devices=_devices(pkg, n_dev))
    return build


def _fleet_server(pkg, n_dev, fleet: dict, **over):
    def build():
        if pkg == "jax":
            from dlnetbench_tpu.serving.fleet import (FleetConfig,
                                                      FleetServer)
            FleetServer(jax_model(), JS.ServingConfig(**{**SERVING,
                                                         **over}),
                        FleetConfig(**fleet), devices=_devices(pkg, n_dev))
        else:
            from dlnetbench_tpu_torch.serving.fleet import (FleetConfig,
                                                            FleetServer)
            FleetServer(torch_model(), TS.ServingConfig(**{**SERVING,
                                                           **over}),
                        FleetConfig(**fleet), devices=_devices(pkg, n_dev))
    return build


DIS = dict(world=2, disaggregate=True, prefill_ranks=1, decode_ranks=1)
REFUSALS = {
    "world_zero": (_serving, dict(world=0)),
    "kv_shard_zero": (_serving, dict(kv_shard=0)),
    "slots_over_world": (_serving, dict(slots=3, world=2)),
    "dis_phase": (_serving, dict(DIS, prefill_ranks=0, world=1)),
    "dis_world": (_serving, dict(DIS, world=4)),
    "dis_divisible": (_serving, dict(DIS, slots=3, world=3,
                                     prefill_ranks=2)),
    "dis_speculative": (_serving, dict(DIS, speculative=True)),
    "dis_prefix": (_serving, dict(DIS, prefix_sharing=True)),
    "dis_kv_shard": (_serving, dict(DIS, kv_shard=2)),
    "dis_inline": (_serving, dict(DIS, prefill="inline")),
    "dis_chunk": (_serving, dict(DIS, migration_chunk_pages=0)),
    "fleet_replicas": (_fleet, dict(replicas=0)),
    "fleet_routing": (_fleet, dict(routing="sticky")),
    "fleet_min": (_fleet, dict(replicas=2, min_replicas=3)),
    "fleet_autoscale": (_fleet, dict(replicas=1, autoscale=True)),
    "fleet_window": (_fleet, dict(scale_window_s=0.0)),
    "fleet_cooldown": (_fleet, dict(scale_cooldown_s=0.0)),
    "fleet_idle": (_fleet, dict(scale_idle_frac=1.0)),
    "engine_world_devices": (lambda p: _engine(p, 1, world=2), None),
    "engine_kv_devices": (lambda p: _engine(p, 1, kv_shard=2), None),
    "engine_kv_heads": (lambda p: _engine(p, 4, model=dict(
        embed_dim=48, num_heads=6, num_kv_heads=3), kv_shard=2), None),
    "engine_disagg": (lambda p: _engine(p, 2, **DIS), None),
    "disagg_devices": (lambda p: _disagg(p, 1, **DIS), None),
    "disagg_monolithic": (lambda p: _disagg(p, 2), None),
    "fleet_devices": (lambda p: _fleet_server(p, 1, dict(replicas=2)),
                      None),
    "fleet_affinity": (lambda p: _fleet_server(
        p, 2, dict(replicas=2, routing="prefix_affinity")), None),
    "fleet_disagg": (lambda p: _fleet_server(
        p, 4, dict(replicas=2), **DIS), None),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_scale_refusals_match_jax(case):
    """Every refusal of the serving config, the fleet config and the
    device-count checks: the port raises a ValueError with the JAX
    package's message word for word."""
    make, over = REFUSALS[case]
    msgs = {}
    for pkg in ("jax", "torch"):
        fn = make(pkg, **over) if over is not None else make(pkg)
        with pytest.raises(ValueError) as e:
            fn()
        msgs[pkg] = str(e.value)
    assert msgs["torch"] == msgs["jax"]


def test_default_devices_and_normalization(monkeypatch):
    """The default device list is the first cards; too few is the JAX
    package's error, never a silent one-device run; a bare ``cuda``
    names the current card by index."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert TS.resolve_devices(None, None, 2) == [torch.device("cuda", 0)]
    assert TS.normalize_device("cuda") == torch.device("cuda", 0)
    assert TS.resolve_devices(["cpu", "cpu"]) == [CPU, CPU]
    with pytest.raises(ValueError, match="world 2 needs 2 devices, have 1"):
        TS.Engine(torch_model(), TS.ServingConfig(**SERVING, world=2))


# ---------------------------------------------------------------------
# the migration-ETA cap

def _bare(mod, cfg):
    eng = object.__new__(mod.Engine)
    eng.cfg = cfg
    eng.pending = []
    eng.queue = []
    eng._now = lambda: 0.0
    eng._step_ewma_s = 0.010
    eng._migration_eta_s = None
    st = mod._SlotState(Request(rid=0, arrival_s=0.0, prompt_len=8,
                                output_len=100), admitted_s=0.0)
    st.prefill_done = 8
    eng.slots = [st, None, None, None]
    return eng


@pytest.mark.parametrize("adaptive", [True, False])
def test_pick_n_steps_eta_cap_matches_jax(adaptive):
    """``_pick_n_steps`` gives the JAX package's N on the same state for
    every ETA: none, now, a few step averages out, far away — and on a
    queue-head arrival and pending work beside it."""
    kw = dict(slots=4, page_size=8, num_pages=16, max_seq_len=32,
              multi_step_n=8, adaptive_n=adaptive)
    got = {}
    for name, mod in (("jax", JS), ("torch", TS)):
        eng = _bare(mod, mod.ServingConfig(**kw))
        out = []
        for eta in (None, 0.0, 0.025, 0.07, 10.0, float("inf")):
            eng._migration_eta_s = eta
            out.append(eng._pick_n_steps([0]))
            eng.queue = [Request(rid=1, arrival_s=0.03, prompt_len=4,
                                 output_len=4)]
            out.append(eng._pick_n_steps([0]))
            eng.queue, eng.pending = [], [object()]
            out.append(eng._pick_n_steps([0]))
            eng.pending = []
        got[name] = out
    assert got["torch"] == got["jax"]
    if adaptive:
        assert got["torch"][:6] == [8, 4, 8, 1, 1, 1]


# ---------------------------------------------------------------------
# kv_shard

def _streams(eng, requests):
    eng.run(requests)
    return {rid: list(t) for rid, t in eng.token_streams.items()}


def test_kv_shard_engine_matches_unsharded_and_jax(weights):
    """A kv_shard=2 engine (pools split over two devices, attention once
    a shard) gives the unsharded engine's greedy streams and the JAX
    package's sharded engine's, over two runs of one engine."""
    jp, tp = weights
    plan = JPlan(kind="poisson", rate_rps=100.0, num_requests=5, seed=4,
                 prompt_len=[4, 8], output_len=3)
    jcfg, tcfg = both_cfg(kv_shard=2)
    with SC.scripted("dlnetbench_tpu"):
        jeng = JS.Engine(jax_model(), jcfg, params=jp)
        jref = _streams(jeng, plan.sample())
    tplan = TPlan.from_dict(plan.to_dict())
    with SC.scripted("dlnetbench_tpu_torch"):
        eng = TS.Engine(torch_model(), tcfg, params=tp,
                        devices=[CPU, CPU])
        assert all(isinstance(p, TS.__dict__["sharded_buffers"]
                              .__globals__["HeadShards"])
                   for p in eng.pools)
        first = _streams(eng, tplan.sample())
        second = _streams(eng, tplan.sample())
        one = _streams(TS.Engine(torch_model(),
                                 dataclasses.replace(tcfg, kv_shard=1),
                                 params=tp, device="cpu"), tplan.sample())
    assert first == second == one == jref
    assert len(first) == 5


@pytest.mark.parametrize("cache_dtype,n", [("int8", 1), ("fp8", 4),
                                           ("bf16", 4)])
def test_kv_shard_streams_equal_unsharded(weights, cache_dtype, n):
    """Quantized pools (scales split with their heads) and the fused
    loop: kv_shard=2 gives the kv_shard=1 streams."""
    _, tp = weights
    plan = TPlan(kind="poisson", rate_rps=200.0, num_requests=6, seed=2,
                 prompt_len=[4, 11], output_len=[3, 6])
    cfg = TS.ServingConfig(**SERVING, cache_dtype=cache_dtype,
                           multi_step_n=n)
    with SC.scripted("dlnetbench_tpu_torch"):
        one = _streams(TS.Engine(torch_model(), cfg, params=tp,
                                 device="cpu"), plan.sample())
        two = _streams(TS.Engine(torch_model(),
                                 dataclasses.replace(cfg, kv_shard=2),
                                 params=tp, devices=[CPU, CPU]),
                       plan.sample())
    assert two == one and len(one) == 6


def test_dispatch_reads_nothing_back(weights):
    """The step split: ``_step_dispatch`` pulls nothing from the device,
    and the dispatched step's tokens are read only at its
    completion."""
    _, tp = weights
    eng = TS.Engine(torch_model(), TS.ServingConfig(**SERVING,
                                                    multi_step_n=4),
                    params=tp, device="cpu")
    eng._reset_state()
    eng._t0 = 0.0
    eng._now = lambda: 0.0
    eng.pending = [Request(rid=0, arrival_s=0.0, prompt_len=5,
                           output_len=6)]
    eng._admit_arrivals(0.0)
    pulls = eng.dstate.sync_stats()["sync_d2h_us"]["n"]
    ctx = eng._step_dispatch()
    assert ctx is not None and ctx["fused"]
    # the dispatch uploads the admitted slot (a priced flush) and pulls
    # nothing back
    assert eng.dstate.sync_stats()["sync_d2h_us"]["n"] == pulls
    assert eng.token_streams[0] == eng.token_streams[0][:1]
    eng._step_complete(ctx)
    assert len(eng.token_streams[0]) > 1


# ---------------------------------------------------------------------
# fault plans in run_serving

def _plans(events, policy="fail_fast"):
    return (JFaultPlan(events=[JEvent(**e) for e in events], policy=policy),
            FaultPlan(events=[FaultEvent(**e) for e in events],
                      policy=policy))


CRASH_TRACE = ([{"t": 0.01 * i, "prompt_len": 6, "output_len": 4}
                for i in range(10)]
               + [{"t": 4.0 + 0.05 * i, "prompt_len": 6, "output_len": 4}
                  for i in range(6)])


def _faulted(jp, tp, plan_dict, events, policy, **over):
    jfp, tfp = _plans(events, policy)
    jcfg, tcfg = both_cfg(**over)
    with SC.scripted("dlnetbench_tpu"):
        jres = JS.run_serving(jax_model(), jcfg, JPlan.from_dict(plan_dict),
                              fault_plan=jfp, params=jp,
                              devices=jax.devices()[:jcfg.world])
    with SC.scripted("dlnetbench_tpu_torch"):
        tres = TS.run_serving(torch_model(), tcfg,
                              TPlan.from_dict(plan_dict), fault_plan=tfp,
                              params=tp, devices=[CPU] * tcfg.world)
    return jres, tres


def test_delay_fault_inflates_latency_as_jax(weights):
    """A 20 ms delay on every engine step inflates every latency; the
    faulted timers equal the JAX package's on the same scripted clock,
    and the record stamps the plan and the injected delay."""
    jp, tp = weights
    plan = {"kind": "poisson", "rate_rps": 100.0, "num_requests": 8,
            "seed": 3, "prompt_len": [4, 8], "output_len": [3, 5]}
    _, clean = _faulted(jp, tp, plan, [], "fail_fast")
    jres, tres = _faulted(jp, tp, plan, [{"kind": "delay",
                                          "magnitude_us": 20000,
                                          "iteration": 0}], "fail_fast")
    assert tres.timers_us == jres.timers_us
    g, c = tres.global_meta["serving"], clean.global_meta["serving"]
    assert g["e2e_ms"]["p99"] > c["e2e_ms"]["p99"] + 15.0
    assert g["e2e_ms"]["p50"] > c["e2e_ms"]["p50"]
    tg, jg = tres.global_meta, jres.global_meta
    for key in ("fault_plan", "fault_policy", "fault_injected_delay_us"):
        assert tg[key] == jg[key], key
    assert tg["fault_injected_delay_us"] > 0


def test_fail_fast_crash_propagates(weights):
    _, tp = weights
    plan = TPlan(kind="poisson", rate_rps=200.0, num_requests=8, seed=0,
                 prompt_len=4, output_len=4)
    _, fp = _plans([{"kind": "crash", "ranks": [0], "iteration": 2}])
    with pytest.raises(RankFailure):
        TS.run_serving(torch_model(), TS.ServingConfig(**SERVING), plan,
                       fault_plan=fp, params=tp, device="cpu")


def test_crash_shrink_matches_jax(weights):
    """crash + shrink at world 2: the engine is rebuilt over rank 0 with
    half the slots, every request completes with its original arrival
    stamp, the goodput timeline dips and recovers — timers, timeline
    and stamps equal to the JAX package's run on the same clock — and
    the record passes both parsers with the survivor's row only."""
    from dlnetbench_tpu.metrics.parser import validate_record as jvalid
    from dlnetbench_tpu_torch.metrics.emit import result_to_record
    from dlnetbench_tpu_torch.metrics.parser import validate_record
    jp, tp = weights
    plan = {"kind": "replay", "trace": CRASH_TRACE}
    jres, tres = _faulted(jp, tp, plan, [{"kind": "crash", "ranks": [1],
                                          "iteration": 4}], "shrink",
                          world=2, slo_ttft_ms=25.0, warmup_requests=2)
    g, jg = tres.global_meta, jres.global_meta
    assert g["degraded_world"] == jg["degraded_world"] == [0]
    assert g["degraded_slots"] == jg["degraded_slots"] == 2
    assert g["detection_ms"] >= 0 and g["recovery_ms"] >= 0
    assert tres.num_runs == len(CRASH_TRACE)
    assert tres.timers_us == jres.timers_us
    tl = g["serving"]["goodput_timeline"]
    assert tl == jg["serving"]["goodput_timeline"]
    fracs = [w["goodput_frac"] for w in tl if w["completed"]]
    assert min(fracs) < 1.0 and fracs[-1] == 1.0
    rec = result_to_record(tres)
    validate_record(rec)
    jvalid(rec)
    assert [r["rank"] for r in rec["ranks"]] == [0]


# ---------------------------------------------------------------------
# the re-queue arc

def test_requeue_keeps_original_stamps_and_orders_by_arrival():
    reqs = [(2, 0.7), (0, 0.1), (1, 0.1)]
    outs = {}
    for name, mod, R in (("jax", JRQ, JRequest), ("torch", TRQ, Request)):
        src = types.SimpleNamespace(drain_unfinished=lambda R=R: [
            R(rid=rid, arrival_s=t, prompt_len=4, output_len=2)
            for rid, t in reqs])
        outs[name] = [(r.rid, r.arrival_s)
                      for r in mod.requeue_unfinished(src)]
    assert outs["torch"] == outs["jax"] == [(0, 0.1), (1, 0.1), (2, 0.7)]


def test_detect_shrink_classifies_and_reraises():
    inj = types.SimpleNamespace(crash_raised_at=0.0)
    jfp, tfp = _plans([{"kind": "crash", "ranks": [0], "iteration": 1}],
                      "shrink")
    with SC.scripted("dlnetbench_tpu_torch"):
        det, surv = TRQ.detect_shrink(RankFailure(0, 1), injector=inj,
                                      fault_plan=tfp, world=2, step=3)
    with SC.scripted("dlnetbench_tpu"):
        jdet, jsurv = JRQ.detect_shrink(JRankFailure(0, 1), injector=inj,
                                        fault_plan=jfp, world=2, step=3)
    assert (det, surv) == (jdet, jsurv) == (0.0, [1])
    with pytest.raises(ValueError, match="boom"):
        TRQ.detect_shrink(ValueError("boom"), injector=inj,
                          fault_plan=tfp, world=2, step=3)
    _, ff = _plans([{"kind": "crash", "ranks": [0], "iteration": 1}])
    with pytest.raises(RankFailure):
        TRQ.detect_shrink(RankFailure(0, 1), injector=inj, fault_plan=ff,
                          world=2, step=3)


# ---------------------------------------------------------------------
# cli serve's scale flags

PLAN = {"kind": "poisson", "rate_rps": 100.0, "num_requests": 5, "seed": 0,
        "prompt_len": [3, 8], "output_len": [2, 5]}
CLI_MODEL = ["--embed", "32", "--heads", "4", "--kv_heads", "2", "--ff",
             "64", "--layers", "2", "--vocab", "64"]
CRASH = json.dumps({"policy": "shrink", "events": [
    {"kind": "crash", "ranks": [1], "iteration": 3}]})
CLI_CASES = {
    "world": (["--world", "2"], {"world_size": 2}),
    "kv_shard": (["--kv_shard", "2", "--cache_dtype", "int8"],
                 {"world_size": 2}),
    "disagg": (["--world", "2", "--disaggregate", "--multi_step_n", "4"],
               {"world_size": 2, "disaggregated": True}),
    "fleet": (["--replicas", "2", "--routing", "p2c", "--route_seed", "3"],
              {"world_size": 2, "fleet_routing": "p2c",
               "fleet_replicas": 2}),
    "crash": (["--world", "2", "--fault", CRASH],
              {"world_size": 2, "degraded_world": [0],
               "fault_policy": "shrink"}),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_serve_scale_flags_reach_the_record(tmp_path, case):
    """Each scale flag runs its path on a repeated CPU device list and
    the record loads through both packages' parsers with the JAX
    package's globals."""
    from dlnetbench_tpu.metrics.parser import load_records
    from dlnetbench_tpu_torch.metrics.parser import \
        load_records as tload
    argv, want = CLI_CASES[case]
    out = tmp_path / "s.jsonl"
    rc = tcli.main(["serve", "--platform", "cpu", "--arrival",
                    json.dumps(PLAN), *CLI_MODEL, "--out", str(out),
                    *argv])
    assert rc == 0
    rec = load_records(str(out))[-1]
    assert tload(str(out))[-1]["global"] == rec["global"]
    g = rec["global"]
    for k, v in want.items():
        assert g[k] == v, k
    assert g["serving"]["completed"] == PLAN["num_requests"]
    assert len(rec["ranks"]) == len(g.get("degraded_world")
                                    or range(g["world_size"]))
    if case == "disagg":
        assert g["serving"]["migration"]["sends"] == PLAN["num_requests"]
    if case == "fleet":
        assert sum(g["fleet"]["requests_per_replica"]) == 5


@pytest.mark.parametrize("argv,message", [
    (["--world", "3"], "slots must divide evenly"),
    (["--disaggregate"], "world 1 must equal"),
    (["--replicas", "2", "--routing", "prefix_affinity", "--autoscale",
      "--fault", "{not json"], "--fault"),
    (["--replicas", "1", "--autoscale"], None),
])
def test_cli_serve_scale_usage_errors(capsys, argv, message):
    """Bad scale flags are usage errors with the JAX package's words;
    ``--autoscale`` on one replica is ignored, as in the JAX CLI (the
    fleet path is taken from two replicas on)."""
    full = ["serve", "--platform", "cpu", "--arrival", json.dumps(PLAN),
            *CLI_MODEL, *argv]
    if message is None:
        assert tcli.main(full + ["--out", "/dev/null"]) == 0
        return
    with pytest.raises(SystemExit) as e:
        tcli.main(full)
    assert e.value.code == 2
    assert message in capsys.readouterr().err
