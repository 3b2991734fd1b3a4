"""The port's disaggregated prefill/decode held against the JAX package
on the CPU: the page-migration channel's stored-dtype payload (bit for
bit against JAX's channel), its closed-form bytes, refusals and overlap
legs; greedy streams of the disaggregated server against the port's
monolithic engine and the JAX package's server, int8 and bf16; a
prefill-rank crash under shrink; the record; and the ``disagg_ab``
line's assembler.  Stream and fault comparisons run on
``scripted_clock.scripted``."""
from __future__ import annotations

import contextlib
import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as JBENCH
import scripted_clock as SC
from dlnetbench_tpu.models import transformer as jtfm
from dlnetbench_tpu.ops import page_migration as JPM
from dlnetbench_tpu.serving import kv_cache as JKV
from dlnetbench_tpu.serving import scheduler as JS
from dlnetbench_tpu.serving.arrivals import ArrivalPlan as JPlan
from dlnetbench_tpu_torch import bench as TBENCH
from dlnetbench_tpu_torch.metrics import telemetry
from dlnetbench_tpu_torch.models import transformer as ttfm
from dlnetbench_tpu_torch.ops import page_migration as TPM
from dlnetbench_tpu_torch.serving import kv_cache as TKV
from dlnetbench_tpu_torch.serving import scheduler as TS
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan as TPlan

CPU = torch.device("cpu")
MODEL = dict(vocab_size=64, embed_dim=32, num_heads=4, num_kv_heads=2,
             ff_dim=64, num_layers=2, seq_len=32)
# page_size 8: the int8 wire's scales amortize under the 0.55x bar
DISAGG = dict(slots=4, page_size=8, num_pages=16, max_seq_len=32,
              slo_ttft_ms=200.0, slo_tpot_ms=100.0, world=2,
              disaggregate=True, prefill_ranks=1, decode_ranks=1,
              multi_step_n=4, adaptive_n=True, warmup_requests=0)
CHAN = dict(num_layers=2, num_kv_heads=2, head_dim=16, num_pages=16,
            page_size=8, max_seqs=2, max_pages_per_seq=4)


@pytest.fixture(autouse=True)
def _clean_recorder():
    telemetry.disable()
    yield
    telemetry.disable()


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


def _pools(cache_dtype: str, seed: int = 0):
    """The same random pools in both packages' stored dtypes: (JAX
    arrays, port tensors, the port's cache config)."""
    jcfg = JKV.CacheConfig(**CHAN, cache_dtype=cache_dtype).validate()
    tcfg = TKV.CacheConfig(**CHAN, cache_dtype=cache_dtype).validate()
    rng = np.random.RandomState(seed)
    jout, tout = [], []
    for pool in JKV.device_buffers(jcfg):
        if pool.dtype == jnp.int8:
            a = rng.randint(-127, 128, pool.shape).astype(np.int8)
        else:
            a = np.asarray(jnp.asarray(
                rng.randn(*pool.shape).astype(np.float32), pool.dtype))
        jout.append(jnp.asarray(a))
        if a.dtype == jnp.float8_e4m3fn:
            tout.append(torch.from_numpy(a.view(np.uint8).copy())
                        .view(torch.float8_e4m3fn))
        else:
            tout.append(torch.from_numpy(np.array(a)))
    return tuple(jout), tuple(tout), jcfg, tcfg


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn
                else a).numpy()
    a = np.array(a)
    return a.view(np.uint8) if a.dtype == jnp.float8_e4m3fn else a


# ---------------------------------------------------------------------
# the channel

@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
def test_migration_payload_bit_exact_against_jax(cache_dtype):
    """send -> scatter moves the pages (and scales) in the stored dtype,
    never widened, and lands them bit for bit at the destination ids —
    the same bytes JAX's channel lands from the same pools."""
    jsrc, tsrc, jcfg, tcfg = _pools(cache_dtype)
    src_ids, dst_ids = [5, 1, 7, 2], [0, 3, 9, 11]
    jch = JPM.MigrationChannel(jcfg, jax.devices()[1], chunk_pages=3)
    jout = jch.scatter(JKV.device_buffers(jcfg),
                       jch.send(jsrc, src_ids), dst_ids)
    tch = TPM.MigrationChannel(tcfg, CPU, chunk_pages=3)
    tout = tch.scatter(TKV.device_buffers(tcfg, "cpu"),
                       tch.send(tsrc, src_ids), dst_ids)
    for got, want, src in zip(tout, jout, tsrc):
        assert got.dtype == src.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))
        for s, d in zip(src_ids, dst_ids):
            np.testing.assert_array_equal(_bits(got[:, :, d]),
                                          _bits(src[:, :, s]))
    rec = tch._sends[0]
    assert (rec.pages, rec.chunks, rec.overlapped) == (4, 2, False)
    assert rec.bytes == 4 * tcfg.page_bytes == jch._sends[0].bytes


def test_migration_bytes_closed_form():
    """n * page_bytes with the f32 scales included, the bf16 equivalent
    beside it, the int8 ratio under 0.55 at page 8 — JAX's numbers."""
    _, _, jcfg, tcfg = _pools("int8")
    tch = TPM.MigrationChannel(tcfg, CPU)
    jch = JPM.MigrationChannel(jcfg, jax.devices()[1])
    assert tcfg.page_bytes == jcfg.page_bytes
    assert tch.bytes_for_pages(3) == jch.bytes_for_pages(3) \
        == 3 * tcfg.page_bytes
    assert tch.bf16_equiv_bytes(3) == jch.bf16_equiv_bytes(3) \
        == 3 * TPM.bf16_equiv_page_bytes(tcfg)
    s_dh = tcfg.page_size * tcfg.head_dim
    ratio = tch.bytes_for_pages(3) / tch.bf16_equiv_bytes(3)
    assert ratio == pytest.approx((s_dh + 4) / (2 * s_dh)) and ratio <= 0.55


def test_migration_channel_refusals_match_jax():
    _, tsrc, jcfg, tcfg = _pools("int8")
    msgs = []
    for mod, cfg, dev, bufs in (
            (JPM, jcfg, jax.devices()[1], lambda: JKV.device_buffers(jcfg)),
            (TPM, tcfg, CPU, lambda: TKV.device_buffers(tcfg, "cpu"))):
        got = []
        with pytest.raises(ValueError) as e:
            mod.MigrationChannel(cfg, dev, chunk_pages=0)
        got.append(str(e.value))
        ch = mod.MigrationChannel(cfg, dev)
        with pytest.raises(ValueError) as e:
            ch.send(bufs(), [])
        got.append(str(e.value))
        pending = ch.send(bufs(), [0, 1], fence=True)
        with pytest.raises(ValueError) as e:
            ch.scatter(bufs(), pending, [4])
        got.append(str(e.value))
        msgs.append(got)
    assert msgs[1] == msgs[0]


def test_migration_overlap_nan_unless_all_legs():
    _, _, _, cfg = _pools("int8")
    ch = TPM.MigrationChannel(cfg, CPU)
    assert ch.stats_block() is None
    src = TKV.device_buffers(cfg, "cpu")
    p = ch.send(src, [0], fence=False, overlapped=True)
    assert p._record is None      # unfenced: not recorded yet
    r1 = p.wait()
    assert p.wait() is r1 and r1.overlapped
    ch.note_compute_solo(0.010)
    ch.note_both(0.012)
    assert math.isnan(ch.overlap())     # no solo send yet
    ch.send(src, [1], fence=True)
    assert not math.isnan(ch.overlap())
    blk = ch.stats_block()
    assert blk["sends"] == 2 and blk["overlapped_sends"] == 1
    assert blk["pages"] == 2 and blk["bytes"] == 2 * cfg.page_bytes
    ch2 = TPM.MigrationChannel(cfg, CPU)
    ch2.send(TKV.device_buffers(cfg, "cpu"), [0], fence=True)
    assert math.isnan(ch2.overlap())
    assert math.isnan(ch2.stats_block()["overlap"])


# ---------------------------------------------------------------------
# token parity (the tentpole bar)

PARITY_PLAN = {"kind": "poisson", "rate_rps": 200.0, "num_requests": 8,
               "seed": 7, "prompt_len": [4, 9], "output_len": 5}


def _parity(weights, cache_dtype):
    from dlnetbench_tpu.serving.disagg import DisaggServer as JDis
    from dlnetbench_tpu_torch.serving.disagg import DisaggServer
    jmc, jp, tmc, tp = weights
    kw = dict(DISAGG, cache_dtype=cache_dtype)
    with SC.scripted("dlnetbench_tpu"):
        jsrv = JDis(jmc, JS.ServingConfig(**kw), params=jp)
        jsrv.run(JPlan.from_dict(PARITY_PLAN).sample())
    plan = TPlan.from_dict(PARITY_PLAN)
    with SC.scripted("dlnetbench_tpu_torch"):
        mono = TS.Engine(tmc, TS.ServingConfig(**dict(
            kw, disaggregate=False)), params=tp, devices=[CPU, CPU])
        mono.run(plan.sample())
        srv = DisaggServer(tmc, TS.ServingConfig(**kw), params=tp,
                           devices=[CPU, CPU])
        completed, _ = srv.run(plan.sample())
    return jsrv.token_streams, dict(mono.token_streams), srv, completed


@pytest.mark.parametrize("cache_dtype", ["int8", "bf16"])
def test_disagg_streams_equal_monolithic_and_jax(weights, cache_dtype):
    """Disaggregated greedy streams equal the port's monolithic engine's
    and the JAX package's disaggregated server's; every request crossed
    the wire, stamped prefill-side; int8 moves under 0.55x of the bf16
    bytes."""
    jstreams, mono, srv, completed = _parity(weights, cache_dtype)
    assert srv.token_streams == mono == jstreams
    assert len(completed) == 8
    assert all(c.first_token_s is not None
               and c.first_token_s <= c.finish_s for c in completed)
    blk = srv.channel.stats_block()
    assert blk["sends"] == 8
    assert blk["bytes"] == blk["pages"] * srv.decode.cache_cfg.page_bytes
    if cache_dtype == "int8":
        assert blk["bytes_ratio_vs_bf16"] <= 0.55
    assert blk["ms"]["n"] == 8


def test_disagg_record_through_both_parsers(weights, tmp_path):
    """``run_disagg``'s record: the migration block, the comparable
    ``disaggregated`` global and the replica config, through the port's
    emit and both parsers."""
    from dlnetbench_tpu.metrics.parser import validate_record as jvalid
    from dlnetbench_tpu_torch.metrics.emit import emit_result
    from dlnetbench_tpu_torch.metrics.parser import load_records
    from dlnetbench_tpu_torch.serving.disagg import run_disagg
    _, _, tmc, tp = weights
    out = tmp_path / "d.jsonl"
    res = run_disagg(tmc, TS.ServingConfig(**dict(DISAGG,
                                                  cache_dtype="int8",
                                                  warmup_requests=2)),
                     TPlan.from_dict(PARITY_PLAN), params=tp,
                     devices=[CPU, CPU])
    emit_result(res, path=str(out))
    rec = load_records(str(out))[-1]
    jvalid(rec)
    g = rec["global"]
    assert g["disaggregated"] is True and g["world_size"] == 2
    sc = g["serving_config"]
    assert (sc["prefill_ranks"], sc["decode_ranks"],
            sc["migration_chunk_pages"]) == (1, 1, 8)
    assert g["serving"]["migration"]["sends"] == 8
    assert g["serving"]["completed"] == 8
    assert [r["device_id"] for r in rec["ranks"]] == [0, 0]


# ---------------------------------------------------------------------
# a prefill-rank crash under shrink

REBUILD_S = 0.5


@contextlib.contextmanager
def _priced_rebuild(package: str, clock):
    """A server built after the first in the block costs ``REBUILD_S``
    of scripted time (the rebuild a crash under shrink pays on a real
    device), the same in both packages."""
    mod = importlib.import_module(f"{package}.serving.disagg")
    cls = mod.DisaggServer
    init, built = cls.__init__, []

    def priced(self, *a, **kw):
        init(self, *a, **kw)
        if built:
            clock.t += REBUILD_S
        built.append(self)

    cls.__init__ = priced
    try:
        yield
    finally:
        cls.__init__ = init


CRASH_TRACE = ([{"t": 0.01 * i, "prompt_len": 6, "output_len": 4}
                for i in range(10)]
               + [{"t": 4.0 + 0.05 * i, "prompt_len": 6, "output_len": 4}
                  for i in range(6)])


def test_prefill_crash_blows_ttft_keeps_tpot(weights, tmp_path):
    """Crash prefill rank 0 of a 2p+1d world under shrink: the server is
    rebuilt over ranks [1, 2] with the decode share untouched, every
    request completes, TTFT p99 rises over the clean run while TPOT
    holds its SLO, the timers equal the JAX package's on the same
    clock, the fault trigger names the prefill replica and the flight
    ring holds the migrations."""
    from dlnetbench_tpu.faults.plan import FaultEvent as JEvent
    from dlnetbench_tpu.faults.plan import FaultPlan as JFP
    from dlnetbench_tpu.serving.disagg import run_disagg as jrun
    from dlnetbench_tpu_torch.faults.plan import FaultEvent, FaultPlan
    from dlnetbench_tpu_torch.metrics.emit import result_to_record
    from dlnetbench_tpu_torch.metrics.parser import validate_record
    from dlnetbench_tpu_torch.serving.disagg import run_disagg
    jmc, jp, tmc, tp = weights
    kw = dict(DISAGG, world=3, prefill_ranks=2, decode_ranks=1,
              cache_dtype="int8", slo_ttft_ms=30.0)
    plan = {"kind": "replay", "trace": CRASH_TRACE}
    crash = {"kind": "crash", "ranks": [0], "iteration": 4}
    with SC.scripted("dlnetbench_tpu") as clock, \
            _priced_rebuild("dlnetbench_tpu", clock):
        jres = jrun(jmc, JS.ServingConfig(**kw), JPlan.from_dict(plan),
                    params=jp, devices=jax.devices()[:3],
                    fault_plan=JFP(events=[JEvent(**crash)],
                                   policy="shrink"))
    with SC.scripted("dlnetbench_tpu_torch") as clock:
        clean = run_disagg(tmc, TS.ServingConfig(**kw),
                           TPlan.from_dict(plan), params=tp,
                           devices=[CPU] * 3).global_meta["serving"]
        rec = telemetry.enable(capacity=256, dump_dir=tmp_path)
        with _priced_rebuild("dlnetbench_tpu_torch", clock):
            res = run_disagg(
                tmc, TS.ServingConfig(**kw), TPlan.from_dict(plan),
                params=tp, devices=[CPU] * 3,
                fault_plan=FaultPlan(events=[FaultEvent(**crash)],
                                     policy="shrink"))
    g = res.global_meta
    assert g["degraded_world"] == jres.global_meta["degraded_world"] \
        == [1, 2]
    assert g["degraded_slots"] == 4
    assert res.num_runs == len(CRASH_TRACE)
    assert res.timers_us == jres.timers_us
    srv = g["serving"]
    assert g["recovery_ms"] == pytest.approx(REBUILD_S * 1e3)
    # re-queued requests kept their arrival stamps: the rebuild lands in
    # their TTFT, far past the SLO, while decode holds its TPOT
    assert srv["ttft_ms"]["p99"] > 10 * kw["slo_ttft_ms"] \
        > clean["ttft_ms"]["p99"]
    assert srv["tpot_ms"]["p50"] <= kw["slo_tpot_ms"]
    assert srv["migration"]["sends"] >= len(CRASH_TRACE)
    kinds = {a["trigger"]: a for a in rec.anomalies}
    assert kinds["fault"]["detail"]["replica"] == "prefill"
    mig = [s for s in rec.samples() if s["source"] == "migration"]
    assert mig and all("queue_depth" in s and "bytes" in s for s in mig)
    record = result_to_record(res)
    validate_record(record)
    assert record["global"]["disaggregated"] is True


# ---------------------------------------------------------------------
# the disagg_ab line

def _round(ttft, tpot, p99, tps, mig=None):
    r = {"ttft_ms": {"p50": ttft, "p99": ttft * 3},
         "tpot_ms": {"p50": tpot}, "e2e_ms": {"p99": p99},
         "tokens_per_s": tps}
    if mig is not None:
        r["migration"] = mig
    return r


@pytest.mark.parametrize("disjoint", [True, False])
def test_disagg_line_equals_bench_py(disjoint):
    mono = [_round(5.0 + i, 2.0 + 0.01 * i, 40.0 + i, 900.0 + i)
            for i in range(3)]
    tp = (1.0 if disjoint else 2.0)
    dis = [_round(6.0 + i, tp + 0.01 * i, 38.0 + i, 950.0 + i,
                  mig={"bytes": 4352 * (i + 1), "ms": {"p50": 0.2 + i},
                       "bytes_ratio_vs_bf16": 0.5312})
           for i in range(3)]
    got = TBENCH.disagg_line(mono, dis, ", test", token_parity=True)
    assert got == JBENCH._disagg_line(mono, dis, ", test",
                                      token_parity=True)
    assert got["tpot_band_disjoint_drop"] is disjoint
    assert json.dumps(got)


def test_disagg_ab_on_two_cpu_devices(capsys):
    """The line on a repeated CPU device list: token parity holds and
    the quantized wire is stamped, with the JAX line's keys (and a
    ``note`` when its wall-clock rounds read bimodal); absent below two
    devices."""
    assert TBENCH.bench_disagg_ab("cpu", CPU) is None
    line = TBENCH.bench_disagg_ab("cpu", CPU, devices=[CPU, CPU])
    assert line["token_parity"] is True
    assert line["disaggregated"]["migration_bytes_ratio"] <= 0.55
    assert set(line) - {"note"} == set(JBENCH._disagg_line(
        [_round(1, 1, 1, 1)] * 3,
        [_round(1, 1, 1, 1, {"bytes": 1, "ms": {"p50": 1.0},
                             "bytes_ratio_vs_bf16": 0.5})] * 3,
        token_parity=True))
