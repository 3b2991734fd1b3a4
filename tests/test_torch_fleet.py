"""The port's fleet serving held against the JAX package on the CPU: the
router's picks, load histogram and affinity accounting on the same
replica states and seed; fleet streams and the request -> replica
assignment against a single engine and the JAX package's fleet,
replayed; the fleet record through the port's parser and merge; the
autoscaler's drain and revival and a replica crash under shrink; and
the ``fleet_ab`` line.  Fleet runs compare on
``scripted_clock.scripted``."""
from __future__ import annotations

import copy
import json
import types

import jax
import numpy as np
import pytest
import torch

import bench as JBENCH
import scripted_clock as SC
from dlnetbench_tpu.models import transformer as jtfm
from dlnetbench_tpu.serving import fleet as JF
from dlnetbench_tpu.serving import kv_cache as JKV
from dlnetbench_tpu.serving import router as JR
from dlnetbench_tpu.serving import scheduler as JS
from dlnetbench_tpu.serving.arrivals import ArrivalPlan as JPlan
from dlnetbench_tpu_torch import bench as TBENCH
from dlnetbench_tpu_torch.models import transformer as ttfm
from dlnetbench_tpu_torch.serving import fleet as TF
from dlnetbench_tpu_torch.serving import kv_cache as TKV
from dlnetbench_tpu_torch.serving import router as TR
from dlnetbench_tpu_torch.serving import scheduler as TS
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan as TPlan

CPU = torch.device("cpu")
MODEL = dict(vocab_size=64, embed_dim=32, num_heads=4, num_kv_heads=2,
             ff_dim=64, num_layers=2, seq_len=32)
FLEET = dict(slots=2, page_size=8, num_pages=32, max_seq_len=32,
             slo_ttft_ms=250.0, slo_tpot_ms=100.0, attn_impl="gather",
             warmup_requests=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jmc = jtfm.TransformerConfig(**MODEL, gated=True, max_positions=0,
                                 dtype="float32")
    jp = jtfm.init_params(jax.random.key(0), jmc)
    tp = ttfm.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jmc, jp, ttfm.TransformerConfig(**MODEL, dtype="float32"), tp


def _fake(queued=0, pending=0, occupied=0, slots=2, cache=None):
    return types.SimpleNamespace(
        queue=[object()] * queued, pending=[object()] * pending,
        slots=[object()] * occupied + [None] * (slots - occupied),
        cfg=types.SimpleNamespace(slots=slots), cache=cache)


def _req(rid):
    return types.SimpleNamespace(rid=rid)


def _routers(policy, n, seed=0):
    return JR.Router(policy, n, seed=seed), TR.Router(policy, n, seed=seed)


def _state(r):
    return (list(r.assignments), list(r.counts), r.load_histogram(),
            r.affinity_hit_rate(), r.affinity_bounces,
            r.prefix_reuse_tokens)


# ---------------------------------------------------------------------
# the router

def test_router_refusals_match_jax():
    assert TR.ROUTING_POLICIES == JR.ROUTING_POLICIES
    for args in (("random", 2), ("round_robin", 0)):
        msgs = []
        for mod in (JR, TR):
            with pytest.raises(ValueError) as e:
                mod.Router(*args)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(RuntimeError, match="no active replica"):
        TR.Router("round_robin", 2).pick(_req(0), [_fake(), _fake()], [])


def test_round_robin_skips_inactive_as_jax():
    engines = [_fake() for _ in range(3)]
    for r in _routers("round_robin", 3):
        for i in range(6):
            r.pick(_req(i), engines, [0, 1, 2])
        for i in range(4):
            r.pick(_req(6 + i), engines, [0, 2])
    jr, tr = _routers("round_robin", 3)
    for r in (jr, tr):
        for i in range(10):
            r.pick(_req(i), engines, [0, 1, 2] if i < 6 else [0, 2])
    assert _state(tr) == _state(jr)
    assert tr.counts == [4, 2, 4]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_p2c_picks_equal_jax(seed):
    """The same seeded draws over the same load scores: every pick, the
    counts and the load histogram equal; a lone active replica consumes
    no draw."""
    rng = np.random.RandomState(seed)
    loads = [[int(x) for x in rng.randint(0, 4, size=4)]
             for _ in range(24)]
    jr, tr = _routers("p2c", 4, seed)
    for r in (jr, tr):
        for i, ld in enumerate(loads):
            engines = [_fake(queued=q, slots=4) for q in ld]
            active = [0, 1, 2, 3] if i % 5 else [0, 2, 3]
            r.pick(_req(i), engines, active)
        state0 = r._rng.state
        r.pick(_req(99), engines, [1])
        assert r._rng.state == state0
    assert _state(tr) == _state(jr)
    light, heavy = _fake(), _fake(queued=3)
    tr2 = TR.Router("p2c", 2, seed=seed)
    assert {tr2.pick(_req(i), [light, heavy], [0, 1])
            for i in range(8)} == {0}


def _caches(mod, prompts):
    """Two replicas' page allocators in package ``mod``, replica r
    holding ``prompts[r]`` published."""
    out = []
    for toks in prompts:
        c = mod.PagedKVCache(mod.CacheConfig(
            num_layers=2, num_kv_heads=2, head_dim=16, num_pages=16,
            page_size=4, max_seqs=2, max_pages_per_seq=4).validate())
        if toks is not None:
            c.allocate(0, len(toks))
            c.publish(0, np.asarray(toks))
        out.append(c)
    return out


def test_prefix_affinity_picks_equal_jax():
    """Affinity over real tries in both packages: a match routes to its
    replica (counted as a hit with its reused tokens), a full replica
    bounces to p2c, no match falls back to p2c; the read-only probe
    leaves the pools' hit-rate counters alone."""
    a, b = list(range(12)), list(range(40, 52))
    prompts = [a[:8] + [60, 61], b[:9] + [62], list(range(20, 30)),
               a[:8] + [63, 1]]
    states = []
    for kv, R in ((JKV, JR), (TKV, TR)):
        caches = _caches(kv, [a, b])
        r = R.Router("prefix_affinity", 2, seed=5)
        for i, p in enumerate(prompts):
            occ = 2 if i == 3 else 0
            engines = [_fake(occupied=occ, cache=caches[0]),
                       _fake(cache=caches[1])]
            r.pick(_req(i), engines, [0, 1], prompt_tokens=np.asarray(p))
        assert all(c.prefix_lookups == 0 and c.prefix_hits == 0
                   for c in caches)
        states.append(_state(r))
    assert states[1] == states[0]
    assigned, _, _, hit_rate, bounces, reuse = states[1]
    assert [x for _, x in assigned[:2]] == [0, 1]
    assert bounces == 1 and hit_rate == 0.5 and reuse == 8 + 9


def test_load_histogram_and_score():
    engines = [_fake(queued=2), _fake()]
    r = TR.Router("round_robin", 2)
    r.pick(_req(0), engines, [0, 1])
    r.pick(_req(1), engines, [0, 1])
    assert r.load_samples == [2, 0] and r.load_histogram() == [1, 0, 1]
    assert TR.Router.load_score(_fake(queued=2, pending=1,
                                      occupied=2)) == 5
    assert TR.Router._is_full(_fake(queued=2, slots=2))
    assert not TR.Router._is_full(_fake(occupied=1, slots=2))


# ---------------------------------------------------------------------
# fleet runs against a single engine and the JAX package's fleet

def burst(n, prompt=6, output=3):
    return {"kind": "replay", "trace": [
        {"t": 0.0, "prompt_len": prompt + (i % 3),
         "output_len": output + (i % 2)} for i in range(n)]}


@pytest.mark.parametrize("policy", ["round_robin", "p2c",
                                    "prefix_affinity"])
def test_fleet_parity_and_assignment_replay_as_jax(weights, policy):
    """Routing is lossless placement: a 2-replica fleet's streams equal
    a single engine's; the assignment equals the JAX package's fleet's
    on the same plan, seed and clock, and replays run over run."""
    jmc, jp, tmc, tp = weights
    kw = dict(FLEET, prefix_sharing=True)
    plan = burst(8)
    with SC.scripted("dlnetbench_tpu"):
        jsrv = JF.FleetServer(jmc, JS.ServingConfig(**kw),
                              JF.FleetConfig(replicas=2, routing=policy,
                                             route_seed=4),
                              params=jp, devices=jax.devices()[:2])
        jsrv.run(JPlan.from_dict(plan).sample())
    with SC.scripted("dlnetbench_tpu_torch"):
        single = TS.Engine(tmc, TS.ServingConfig(**kw), params=tp,
                           device="cpu")
        single.run(TPlan.from_dict(plan).sample())
        srv = TF.FleetServer(tmc, TS.ServingConfig(**kw),
                             TF.FleetConfig(replicas=2, routing=policy,
                                            route_seed=4),
                             params=tp, devices=[CPU, CPU])
        completed, _ = srv.run(TPlan.from_dict(plan).sample())
        first = list(srv.router.assignments)
        completed2, _ = srv.run(TPlan.from_dict(plan).sample())
    assert len(completed) == len(completed2) == 8
    assert srv.token_streams == dict(single.token_streams) \
        == jsrv.token_streams
    assert first == list(srv.router.assignments) \
        == list(jsrv.router.assignments)
    blk = srv.fleet_block(completed2)
    jblk = jsrv.fleet_block(sorted(jsrv._all_completed(),
                                   key=lambda c: c.finish_s))
    for key in ("requests_per_replica", "load_histogram", "replicas",
                "routing", "route_seed"):
        assert blk[key] == jblk[key], key
    assert blk["chip_seconds_used"] > 0 and blk["chip_seconds_saved"] == 0
    if policy == "round_robin":
        assert srv.router.counts == [4, 4]


def test_fleet_record_parser_and_merge(weights, tmp_path):
    """``run_fleet``'s record through the port's emit, parser, merge and
    serving summary: the fleet columns populated; the ``fleet`` block
    volatile at merge, ``fleet_routing``/``fleet_replicas`` identity."""
    from dlnetbench_tpu.metrics.parser import validate_record as jvalid
    from dlnetbench_tpu_torch.analysis.bandwidth import serving_summary
    from dlnetbench_tpu_torch.metrics.emit import emit_result
    from dlnetbench_tpu_torch.metrics.merge import merge_records
    from dlnetbench_tpu_torch.metrics.parser import (load_records,
                                                     records_to_dataframe)
    _, _, tmc, tp = weights
    out = tmp_path / "f.jsonl"
    plan = {"kind": "poisson", "rate_rps": 100.0, "num_requests": 10,
            "seed": 1, "prompt_len": [4, 8], "output_len": [2, 5]}
    res = TF.run_fleet(tmc, TS.ServingConfig(**FLEET), TPlan.from_dict(plan),
                       TF.FleetConfig(replicas=2, routing="p2c"),
                       params=tp, devices=[CPU, CPU])
    emit_result(res, path=str(out))
    base = load_records(str(out))[0]
    jvalid(base)
    g = base["global"]
    assert g["fleet_routing"] == "p2c" and g["fleet_replicas"] == 2
    assert sum(g["fleet"]["requests_per_replica"]) == 10
    df = records_to_dataframe([base])
    assert df["fleet_replica_req_max"].iloc[0] == \
        max(g["fleet"]["requests_per_replica"])
    row = serving_summary([merge_records([base])]).iloc[0]
    assert row["routing"] == "p2c" and row["replicas"] == 2
    a, b = copy.deepcopy(base), copy.deepcopy(base)
    a["global"]["num_processes"] = b["global"]["num_processes"] = 2
    b["process"] = 1
    a["ranks"] = [r for r in a["ranks"] if r["rank"] == 0]
    b["ranks"] = [dict(r, process_index=1) for r in b["ranks"]
                  if r["rank"] == 1]
    b["global"]["fleet"] = dict(b["global"]["fleet"],
                                chip_seconds_used=99.0,
                                load_histogram=[0, 1])
    merged = merge_records([a, b])
    assert sorted(r["rank"] for r in merged["ranks"]) == [0, 1]
    for key, value in (("fleet_routing", "round_robin"),
                       ("fleet_replicas", 4)):
        c = copy.deepcopy(b)
        c["global"][key] = value
        with pytest.raises(ValueError, match=key):
            merge_records([a, c])


# ---------------------------------------------------------------------
# elastic capacity and the crash arc

def test_autoscale_drains_trough_and_revives_as_jax(weights):
    """Two bursts and a dead trough: the autoscaler drains a replica in
    the trough (chip-seconds saved) and revives it warm for the second
    burst; every request completes, and the scale events, chip-seconds
    and timers equal the JAX package's on the same clock."""
    jmc, jp, tmc, tp = weights
    trace = [{"t": 0.002 * i, "prompt_len": 6, "output_len": 3}
             for i in range(4)]
    trace += [{"t": 2.2, "prompt_len": 6, "output_len": 8}
              for _ in range(8)]
    plan = {"kind": "replay", "trace": trace}
    fkw = dict(replicas=2, autoscale=True, min_replicas=1,
               scale_window_s=0.15, scale_idle_frac=0.5,
               scale_cooldown_s=0.3)
    with SC.scripted("dlnetbench_tpu"):
        jsrv = JF.FleetServer(jmc, JS.ServingConfig(**FLEET),
                              JF.FleetConfig(**fkw), params=jp,
                              devices=jax.devices()[:2])
        jdone, _ = jsrv.run(JPlan.from_dict(plan).sample())
    with SC.scripted("dlnetbench_tpu_torch"):
        srv = TF.FleetServer(tmc, TS.ServingConfig(**FLEET),
                             TF.FleetConfig(**fkw), params=tp,
                             devices=[CPU, CPU])
        done, _ = srv.run(TPlan.from_dict(plan).sample())
    assert len(done) == len(trace)
    kinds = [e["kind"] for e in srv.scale_events]
    assert "scale_down" in kinds and "scale_up" in kinds
    up = next(e for e in srv.scale_events if e["kind"] == "scale_up")
    assert up["warm"] is True and up["reason"] in ("queue_pressure",
                                                   "slo_breach")
    strip = [{k: v for k, v in e.items()
              if k not in ("drain_ms", "scale_up_ms")}
             for e in srv.scale_events]
    jstrip = [{k: v for k, v in e.items()
               if k not in ("drain_ms", "scale_up_ms")}
              for e in jsrv.scale_events]
    assert strip == jstrip
    used, saved = srv.chip_seconds()
    assert saved > 0 and used > 0
    assert (used, saved) == pytest.approx(jsrv.chip_seconds())
    assert [c.finish_s for c in done] == [c.finish_s for c in jdone]


def test_replica_crash_reroutes_to_survivor_as_jax(weights):
    """Crash replica 0 under shrink: its in-flight work re-queues with
    the original stamps, the router stops offering it, the survivor
    absorbs the rest; the record stamps the crash event — equal to the
    JAX package's run on the same clock."""
    from dlnetbench_tpu.faults.plan import FaultEvent as JEvent
    from dlnetbench_tpu.faults.plan import FaultPlan as JFP
    from dlnetbench_tpu_torch.faults.plan import FaultEvent, FaultPlan
    from dlnetbench_tpu_torch.metrics.emit import result_to_record
    from dlnetbench_tpu_torch.metrics.parser import validate_record
    jmc, jp, tmc, tp = weights
    trace = [{"t": 0.01 * i, "prompt_len": 6, "output_len": 4}
             for i in range(10)]
    plan = {"kind": "replay", "trace": trace}
    crash = {"kind": "crash", "ranks": [0], "iteration": 4}
    with SC.scripted("dlnetbench_tpu"):
        jres = JF.run_fleet(jmc, JS.ServingConfig(**FLEET),
                            JPlan.from_dict(plan),
                            JF.FleetConfig(replicas=2), params=jp,
                            devices=jax.devices()[:2],
                            fault_plan=JFP(events=[JEvent(**crash)],
                                           policy="shrink"))
    with SC.scripted("dlnetbench_tpu_torch"):
        res = TF.run_fleet(tmc, TS.ServingConfig(**FLEET),
                           TPlan.from_dict(plan),
                           TF.FleetConfig(replicas=2), params=tp,
                           devices=[CPU, CPU],
                           fault_plan=FaultPlan(
                               events=[FaultEvent(**crash)],
                               policy="shrink"))
    assert res.num_runs == len(trace)
    g, jg = res.global_meta, jres.global_meta
    assert g["fault_policy"] == "shrink"
    crashes = [e for e in g["fleet"]["scale_events"]
               if e["kind"] == "replica_crash"]
    assert len(crashes) == 1 and crashes[0]["replica"] == 0
    per = g["fleet"]["requests_per_replica"]
    assert per == jg["fleet"]["requests_per_replica"] and per[1] > per[0]
    assert res.timers_us == jres.timers_us
    validate_record(result_to_record(res))


# ---------------------------------------------------------------------
# the fleet_ab line

def _arm(ttft, tps, hit=None, reuse=None):
    out = {"serving": {"ttft_ms": {"p50": ttft, "p99": ttft * 2},
                       "tokens_per_s": tps},
           "fleet": {"replicas": 2}}
    if hit is not None:
        out["fleet"].update(affinity_hit_rate=hit,
                            prefix_reuse_tokens=reuse)
    return out


@pytest.mark.parametrize("disjoint", [True, False])
def test_fleet_line_equals_bench_py(disjoint):
    pa = 3.0 if disjoint else 9.0
    rounds = {
        "round_robin": [_arm(9.0 + i, 800.0 + i) for i in range(3)],
        "p2c": [_arm(8.0 + i, 810.0 + i) for i in range(3)],
        "prefix_affinity": [_arm(pa + 0.1 * i, 850.0 + i, 0.5 + 0.1 * i,
                                 64 + i) for i in range(3)]}
    got = TBENCH.fleet_line(rounds, ", test", token_parity=True)
    assert got == JBENCH._fleet_line(rounds, ", test", token_parity=True)
    assert got["ttft_band_disjoint_drop"] is disjoint
    assert json.dumps(got)


def test_fleet_ab_on_two_cpu_devices(capsys):
    assert TBENCH.bench_fleet_ab("cpu", CPU) is None
    line = TBENCH.bench_fleet_ab("cpu", CPU, devices=[CPU, CPU])
    assert line["token_parity"] is True
    assert line["prefix_affinity"]["affinity_hit_rate"]["value"] >= 0
