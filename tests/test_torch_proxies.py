"""The port's proxies against the JAX package's, on the CPU: the burn,
the A/B harness (scripted times, no sleeps), the collectives and the
DP / FSDP schedules over four gloo processes against JAX's on four
virtual CPU devices, the records through JAX's parser, the CLI at
world 1 and the NVML sampler against a stub library.

The four ranks run ``_gloo_worker`` in spawned processes, which import
this module: jax and the JAX package are imported inside the tests and
fixtures only, never at module level, so the workers load neither."""
from __future__ import annotations

import ctypes
import json
import multiprocessing
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch import cli
from dlnetbench_tpu_torch.metrics import energy as T_energy
from dlnetbench_tpu_torch.proxies import base as T_base
from dlnetbench_tpu_torch.proxies import burn as T_burn
from dlnetbench_tpu_torch.utils.net import free_port

REPO = Path(__file__).resolve().parent.parent
PORT_STATS = REPO / "dlnetbench_tpu_torch" / "data" / "model_stats"
MODEL = "gpt2_l_16_bfloat16"
TINY = dict(size_scale=1e-5, time_scale=2e-4)
WORLD = 4
# per rank: 24 values a small integer over 8 — exact in bf16, and every
# sum of four exact in any order, so the backends' summation order
# cannot separate them
COLL_DTYPES = ("float32", "bfloat16", "int8")


def _coll_inputs(dtype_name: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if dtype_name == "int8":
        return rng.integers(-30, 31, (WORLD, 24)).astype(np.int8)
    return (rng.integers(-64, 65, (WORLD, 24)) / 8).astype(np.float32)


# ------------------------------------------------------------ gloo ranks
def _gloo_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of the 4-process world: collectives on seeded inputs,
    the DP and FSDP bundles' meta and one step's collective counts, and
    rank 0's records of a DP and an FSDP (2 x 2) run."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.metrics.emit import emit_result
    from dlnetbench_tpu_torch.parallel import collectives as col
    from dlnetbench_tpu_torch.parallel import multihost
    from dlnetbench_tpu_torch.parallel.mesh import (make_flat_mesh,
                                                    make_fsdp_mesh)
    from dlnetbench_tpu_torch.proxies import dp, fsdp
    device = multihost.initialize("cpu")
    res = {"coll": {}, "meta": {}, "counts": {}}
    grid = make_fsdp_mesh(2, 2, device)
    for name in COLL_DTYPES:
        x = torch.from_numpy(_coll_inputs(name)[rank]).to(getattr(torch,
                                                                  name))
        ar, ag, rs = x.clone(), torch.empty(WORLD * 24, dtype=x.dtype), \
            torch.empty(24 // WORLD, dtype=x.dtype)
        col.allreduce(ar)
        col.allgather(ag, x)
        col.reduce_scatter(rs, x)
        tp_ar, dp_ar = x.clone(), x.clone()
        tp_ag, tp_rs = torch.empty(48, dtype=x.dtype), \
            torch.empty(12, dtype=x.dtype)
        col.allreduce(tp_ar, group=grid.groups["tp"])
        col.allreduce(dp_ar, group=grid.groups["dp"])
        col.allgather(tp_ag, x, group=grid.groups["tp"])
        col.reduce_scatter(tp_rs, x, group=grid.groups["tp"])
        res["coll"][name] = {k: v.float().numpy() for k, v in (
            ("ar", ar), ("ag", ag), ("rs", rs), ("tp_ar", tp_ar),
            ("dp_ar", dp_ar), ("tp_ag", tp_ag), ("tp_rs", tp_rs))}
    res["coords"] = grid.coords

    stats = load_model_stats(MODEL)
    cfg = T_base.ProxyConfig(warmup=1, runs=2, **TINY)
    bundles = {
        "dp": lambda: dp.build(stats, 4, cfg, make_flat_mesh(device)),
        "fsdp4": lambda: fsdp.build(stats, 4, cfg, device),
        "fsdp2x2": lambda: fsdp.build(stats, 4, cfg, device,
                                      sharding_factor=2),
    }
    for key, make in bundles.items():
        bundle = make()
        res["meta"][key] = dict(bundle.global_meta)
        progs = {"full": bundle.full, "compute": bundle.compute,
                 "comm": bundle.comm, **(bundle.variants or {})}
        for pname, fn in progs.items():
            col.reset_counts()
            fn()
            res["counts"][f"{key}/{pname}"] = col.counts()
        if key in ("dp", "fsdp2x2"):
            result = T_base.run_proxy(key[:4].rstrip("2x"), bundle, cfg)
            per_rank = multihost.all_ranks((result.timers_us,
                                            bundle.rank_meta))
            if rank == 0:
                emit_result(result, path=str(Path(out_dir) / f"{key}.jsonl"),
                            rank_timers_us=[t for t, _ in per_rank],
                            rank_meta=[m for _, m in per_rank])
    multihost.shutdown()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    """Every rank's results (rank order) and the run's directory."""
    out = tmp_path_factory.mktemp("gloo4")
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_gloo_worker, args=(r, port, str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"gloo ranks {alive} did not finish"
    assert [p.exitcode for p in procs] == [0] * WORLD
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, out


def _jax_mesh(shape, axes):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:WORLD]).reshape(shape), axes)


def _jax_collectives(x: np.ndarray, shape, axes, axis: str) -> dict:
    """JAX's psum / all_gather(tiled) / psum_scatter(tiled) of row r of
    ``x`` on device r, per device (rows of the results)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from dlnetbench_tpu.parallel import collectives as J_col
    from dlnetbench_tpu.utils.jax_compat import shard_map
    mesh = _jax_mesh(shape, axes)
    spec = P(axes) if len(axes) > 1 else P(axes[0])
    out = {}
    for key, fn in (("ar", lambda v: J_col.allreduce(v, axis)),
                    ("ag", lambda v: J_col.allgather(v, axis)),
                    ("rs", lambda v: J_col.reduce_scatter(v, axis))):
        body = shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                         in_specs=spec, out_specs=spec, check_vma=False)
        out[key] = np.asarray(body(jnp.asarray(x)).astype(jnp.float32))
    return out


@pytest.mark.parametrize("dtype_name", COLL_DTYPES)
def test_collectives_equal_jax_on_four_devices(gloo_world, dtype_name,
                                               eight_devices):
    ranks, _ = gloo_world
    x = _coll_inputs(dtype_name)
    flat = _jax_collectives(x, (WORLD,), ("x",), "x")
    tp = _jax_collectives(x, (2, 2), ("dp", "tp"), "tp")
    dp = _jax_collectives(x, (2, 2), ("dp", "tp"), "dp")
    for r, res in enumerate(ranks):
        got = res["coll"][dtype_name]
        np.testing.assert_array_equal(got["ar"], flat["ar"][r])
        np.testing.assert_array_equal(got["ag"], flat["ag"][r])
        np.testing.assert_array_equal(got["rs"], flat["rs"][r])
        np.testing.assert_array_equal(got["tp_ar"], tp["ar"][r])
        np.testing.assert_array_equal(got["tp_ag"], tp["ag"][r])
        np.testing.assert_array_equal(got["tp_rs"], tp["rs"][r])
        np.testing.assert_array_equal(got["dp_ar"], dp["ar"][r])
        assert res["coords"] == (r // 2, r % 2)   # JAX's reshape order


def _count_collectives(jaxpr, coords=None) -> dict:
    """The jaxpr's collectives as ``collectives.counts()`` counts one
    rank's: its psum / all_gather / reduce_scatter / all_to_all
    equations, and the sends and receives its ppermute perms give the
    device at ``coords`` (axis name -> coordinate)."""
    names = {"psum": "allreduce", "all_gather": "allgather",
             "reduce_scatter": "reduce_scatter", "all_to_all": "alltoall"}
    out = dict.fromkeys(("allreduce", "allgather", "reduce_scatter",
                         "alltoall", "send", "recv"), 0)

    def walk(j):
        for eqn in j.eqns:
            if eqn.primitive.name in names:
                out[names[eqn.primitive.name]] += 1
            if eqn.primitive.name == "ppermute":
                (axis,) = eqn.params["axis_name"]
                for src, dst in eqn.params["perm"]:
                    out["send"] += src == coords[axis]
                    out["recv"] += dst == coords[axis]
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (list, tuple)) else [p]):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)
    walk(jaxpr.jaxpr)
    return out


SCHEDULE_KEYS = {
    "dp": ["proxy", "model", "world_size", "num_buckets", "bucket_bytes",
           "schedule_bucket_bytes", "fwd_us", "bwd_us_per_bucket",
           "comm_model", "size_scale", "time_scale"],
    "fsdp": ["proxy", "model", "world_size", "num_units",
             "sharding_factor", "num_replicas", "shard_bytes",
             "schedule_shard_bytes", "unit_bytes", "fwd_us_per_unit",
             "bwd_us_per_unit", "comm_model", "size_scale", "time_scale"],
}
MESH_KEYS = ["axes", "num_devices", "platform", "num_hosts", "fabric"]


@pytest.fixture(scope="module")
def jax_bundles(eight_devices):
    """JAX's DP / FSDP bundles at world 4 on the port's stats file."""
    from dlnetbench_tpu.core.model_stats import load_model_stats
    from dlnetbench_tpu.parallel.mesh import make_flat_mesh
    from dlnetbench_tpu.proxies import base as J_base
    from dlnetbench_tpu.proxies import dp, fsdp
    stats = load_model_stats(MODEL, PORT_STATS)
    cfg = J_base.ProxyConfig(warmup=1, runs=2, **TINY)
    devs = eight_devices[:WORLD]
    return cfg, {
        "dp": dp.build(stats, 4, cfg, mesh=make_flat_mesh(WORLD)),
        "fsdp4": fsdp.build(stats, 4, cfg, devices=devs),
        "fsdp2x2": fsdp.build(stats, 4, cfg, devices=devs,
                              sharding_factor=2),
    }


@pytest.mark.parametrize("key", ["dp", "fsdp4", "fsdp2x2"])
def test_schedule_meta_and_step_collectives_equal_jax(gloo_world,
                                                      jax_bundles, key):
    import jax
    ranks, _ = gloo_world
    _, bundles = jax_bundles
    jb = bundles[key]
    jm = jb.global_meta
    for res in ranks:
        tm = res["meta"][key]
        assert set(tm) == set(jm) - {"compile_cache_dir"}
        for k in SCHEDULE_KEYS[key[:4].rstrip("2x")]:
            assert tm[k] == jm[k], k
        for k in MESH_KEYS:
            assert tm["mesh"][k] == jm["mesh"][k], k
    progs = {"full": jb.full, "compute": jb.compute, "comm": jb.comm,
             **(jb.variants or {})}
    for pname, prog in progs.items():
        want = _count_collectives(jax.make_jaxpr(prog.traceable)(
            *prog.example_args))
        for res in ranks:
            assert res["counts"][f"{key}/{pname}"] == want, pname
    if key == "fsdp2x2":
        assert ranks[0]["counts"]["fsdp2x2/full"] == {
            "allreduce": 4, "allgather": 7, "reduce_scatter": 4,
            "alltoall": 0, "send": 0, "recv": 0}


@pytest.mark.parametrize("key", ["dp", "fsdp2x2"])
def test_records_load_through_the_jax_parser_as_jax_records(
        gloo_world, jax_bundles, key, tmp_path):
    from dlnetbench_tpu.metrics.emit import emit_result as J_emit
    from dlnetbench_tpu.metrics.parser import get_metrics_dataframe
    from dlnetbench_tpu.proxies.base import run_proxy as J_run
    _, out = gloo_world
    cfg, bundles = jax_bundles
    proxy = key[:4].rstrip("2x")
    J_emit(J_run(proxy, bundles[key], cfg), path=str(tmp_path / "j.jsonl"))
    jdf = get_metrics_dataframe(tmp_path / "j.jsonl", proxy)
    tdf = get_metrics_dataframe(out / f"{key}.jsonl", proxy)
    assert len(tdf) == WORLD * 2 and sorted(tdf["rank"].unique()) == [
        0, 1, 2, 3]
    # every column of JAX's record, its attribution verdict (attr_bound)
    # included, and one more: the port's ranks are processes, and the
    # record says how many
    assert set(tdf.columns) == set(jdf.columns) | {"num_processes"}
    for col in ("runtime", "compute_time", "barrier_time", "comm_time",
                "overlap_fraction"):
        assert tdf[col].notna().all(), col
    # each rank's row holds its own samples and its own burn plan, a
    # dict the parser makes no column from
    rec = json.loads((out / f"{key}.jsonl").read_text())
    assert len({tuple(r["runtimes"]) for r in rec["ranks"]}) > 1
    assert all(set(r["burn"]) == {"ns_per_iter", "iters", "planned_us"}
               for r in rec["ranks"])
    assert rec["global"]["transport"] == "virtual-host"


# ------------------------------------------------- the record pipeline
# proxy_summary's bus factors before it took analysis.bandwidth's
PARENT_BUS_FACTOR = {"allreduce": lambda n: 2 * (n - 1) / n,
                     "alltoall": lambda n: (n - 1) / n,
                     "allgather": lambda n: (n - 1) / n,
                     "reduce_scatter": lambda n: (n - 1) / n,
                     "p2p": lambda n: 1.0}


@pytest.mark.parametrize("key", ["dp", "fsdp2x2"])
def test_four_rank_record_merges_to_itself_and_jax_refuses_it(gloo_world,
                                                              key):
    """rank 0 gathered every rank's own clock: the mesh header marks the
    record, the port's merge gives it back with its attribution stamped
    again over every row, and JAX's merge (one record per process)
    refuses it as four processes' output with three missing."""
    import copy

    from dlnetbench_tpu.metrics.merge import merge_records as J_merge
    from dlnetbench_tpu_torch.analysis.attribution import attribute_record
    from dlnetbench_tpu_torch.metrics.merge import merge_records as T_merge
    _, out = gloo_world
    rec = json.loads((out / f"{key}.jsonl").read_text())
    assert rec["mesh"]["gathered"] is True
    assert rec["global"]["num_processes"] == WORLD
    attr = rec["global"]["attribution"]
    assert attr == attribute_record(rec)
    # the port's words: gloo moves loopback bytes, a CPU computes on host
    # cores — every verdict is host; the rate rides without a peak
    assert attr["bound"] == "host"
    assert attr["inputs"]["transport"] == "virtual-host"
    assert attr["inputs"]["compute_basis"] == "measured"
    comm = (attr.get("achieved") or {}).get("comm")
    if "comm_time" in rec["global"]["comm_model"]:
        # the rate from the record's own bytes and comm timers: the
        # stamp rounds GB/s to 3 places, which a slow loopback run (a
        # loaded host: tens of ms for the ~30 KB a step moves) takes to
        # 0.0, so the positive rate is checked before the rounding
        import statistics

        from dlnetbench_tpu_torch.analysis.attribution import _pooled
        nbytes = sum(float(c.get("bytes", 0))
                     for c in rec["global"]["comm_model"]["comm_time"])
        rate = nbytes / (statistics.median(
            _pooled(rec["ranks"], "comm_time")) * 1e-6)
        assert rate > 0 and comm["rate_GBps"] == round(rate / 1e9, 3)
        assert "peak_GBps" not in comm
    else:
        assert comm is None             # only comm_time's bytes are priced
    assert abs(sum(attr["fractions"].values()) - 1.0) <= 2e-4
    assert T_merge([copy.deepcopy(rec)]) == rec
    with pytest.raises(ValueError, match=r"expected range\(4\)"):
        J_merge([copy.deepcopy(rec)])


@pytest.mark.parametrize("key", ["dp", "fsdp2x2"])
def test_gloo_records_give_equal_analysis_frames(gloo_world, key):
    import pandas as pd

    from dlnetbench_tpu.analysis import bandwidth as J_bw
    from dlnetbench_tpu.analysis import critical_path as J_cp
    from dlnetbench_tpu_torch.analysis import bandwidth as T_bw
    from dlnetbench_tpu_torch.analysis import critical_path as T_cp
    _, out = gloo_world
    rec = json.loads((out / f"{key}.jsonl").read_text())
    for fn in ("effective_bandwidth", "bandwidth_summary"):
        want = getattr(J_bw, fn)([rec])
        assert len(want) and "host" in set(want["attr_bound"])
        pd.testing.assert_frame_equal(getattr(T_bw, fn)([rec]), want)
    assert T_bw.serving_summary([rec]).empty
    assert T_cp.blame_report(rec) == J_cp.blame_report(rec)
    assert repr(T_cp.blame_columns(rec)) == repr(J_cp.blame_columns(rec))


def test_proxy_summary_bus_factors_unchanged(gloo_world, monkeypatch):
    """proxy_summary's output is byte for byte what its private factors
    gave, now through analysis.bandwidth.bus_factor."""
    from dlnetbench_tpu_torch import proxy_summary
    _, out = gloo_world
    rec = json.loads((out / "dp.jsonl").read_text())
    got = json.dumps(proxy_summary.summarize(rec))
    monkeypatch.setattr(proxy_summary, "bus_factor", lambda kind, n:
                        PARENT_BUS_FACTOR[kind](max(n, 1)))
    assert got == json.dumps(proxy_summary.summarize(rec))


def test_world1_group_retries_a_taken_port(monkeypatch):
    """A one-rank group's store port can be taken between free_port()
    and the bind: that failure retries on a new port, any other raises."""
    import torch.distributed as dist

    from dlnetbench_tpu_torch.parallel import multihost
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    calls = []

    def taken(n):
        def init(backend, init_method, world_size, rank):
            calls.append((backend, init_method, world_size, rank))
            if len(calls) <= n:
                raise RuntimeError("The server socket has failed to listen "
                                   "on any local network address. code: "
                                   "-98, name: EADDRINUSE")
        return init
    monkeypatch.setattr(dist, "init_process_group", taken(2))
    assert multihost.initialize("cpu") == torch.device("cpu")
    assert len(calls) == 3 and all(c[0] == "gloo" and c[2:] == (1, 0)
                                   and c[1].startswith("tcp://localhost:")
                                   for c in calls)
    calls.clear()
    monkeypatch.setattr(dist, "init_process_group",
                        taken(multihost.PORT_ATTEMPTS))
    with pytest.raises(RuntimeError, match="EADDRINUSE"):
        multihost.initialize("cpu")
    assert len(calls) == multihost.PORT_ATTEMPTS

    def refused(*a, **kw):
        calls.append(a)
        raise RuntimeError("connection refused")
    calls.clear()
    monkeypatch.setattr(dist, "init_process_group", refused)
    with pytest.raises(RuntimeError, match="refused"):
        multihost.initialize("cpu")
    assert len(calls) == 1


# ------------------------------------------------------------ the burn
def test_burn_state_and_chain_match_jax():
    import jax.numpy as jnp
    from dlnetbench_tpu.proxies import burn as J_burn
    np.testing.assert_array_equal(
        T_burn.make_state().float().numpy(),
        np.asarray(J_burn.make_state().astype(jnp.float32)))
    for iters in (1, 2, 3, 8):
        b = T_burn.Burner("cpu")
        b(iters)
        want = np.asarray(J_burn.burn(J_burn.make_state(), iters)
                          .astype(jnp.float32))
        err = np.abs(b.state.float().numpy() - want).max()
        assert err <= 2.0 ** -6 * np.abs(want).max(), iters


def test_calibration_maps_time_to_iterations_as_jax(monkeypatch, tmp_path):
    from dlnetbench_tpu.proxies import burn as J_burn
    rng = np.random.default_rng(5)
    for _ in range(200):
        ns = float(rng.uniform(1, 5e5))
        j = J_burn.BurnCalibration(ns, (256, 256), "bfloat16", "x")
        t = T_burn.BurnCalibration(ns, (256, 256), "bfloat16", "x")
        for us in (0.0, -1.0, *rng.uniform(0, 1e6, 5)):
            assert t.iters_for_us(us) == j.iters_for_us(us)
        n = int(rng.integers(0, 10 ** 6))
        assert t.us_for_iters(n) == j.us_for_iters(n)
    # measured once per (shape, dtype, device), persisted when asked
    monkeypatch.setattr(T_burn, "_CAL_CACHE", {})
    monkeypatch.setenv(T_burn.ENV_CACHE_DIR, str(tmp_path))
    cal = T_burn.calibrate(T_burn.Burner("cpu"))
    assert cal.ns_per_iter > 0 and cal.device_kind == "cpu"
    saved = json.loads((tmp_path / "burn_calibration.json").read_text())
    assert saved == {"(256, 256):bfloat16:cpu": cal.ns_per_iter}
    monkeypatch.setattr(T_burn, "_CAL_CACHE", {})
    monkeypatch.setattr(T_burn, "_measure", None)     # must not measure
    assert T_burn.calibrate(T_burn.Burner("cpu")) == cal


# ------------------------------------------------------------ the harness
class _FakeSampler:
    source = "fake"

    def __init__(self):
        self.reads = 0

    def read_joules(self):
        self.reads += 1
        return 3.0 * self.reads


@pytest.mark.parametrize("k", [1, 2])
def test_barrier_time_uses_matched_compute_samples(monkeypatch, k):
    """barrier_time[i] = full[i] - compute[i] from the compute chain timed
    right after full chain i; times are scripted (no sleeps): the legs
    drift 10 ms a chain, so subtracting a mean compute time would give
    [0, 2, 12] ms where the matched pairs give 2 ms each."""
    script = {"full": [0.020, 0.030, 0.040], "compute": [0.018, 0.028,
                                                         0.038],
              "comm": [0.005, 0.005, 0.005], "allgather": [0.001] * 3}
    seen = []

    def fake_chain(fn, *a, k=1, device=None, **kw):
        seen.append((fn.__name__, k))
        return script[fn.__name__].pop(0)

    monkeypatch.setattr(T_base.timing, "time_chain", fake_chain)
    monkeypatch.setattr(T_base.timing, "time_callable",
                        lambda fn, *a, reps=1, device=None, **kw:
                        [0.05] * reps)

    def full():
        pass

    def compute():
        pass

    def comm():
        pass

    def allgather():
        pass

    bundle = T_base.StepBundle(full=full, compute=compute, comm=comm,
                               global_meta={}, variants={
                                   "allgather": allgather})
    cfg = T_base.ProxyConfig(warmup=2, runs=3 * k, reps_per_fence=k)
    res = T_base.run_proxy("t", bundle, cfg, energy_sampler=_FakeSampler())
    t = res.timers_us
    assert res.num_runs == 3 * k and res.warmup_times_us == [5e4, 5e4]
    assert t["runtimes"] == pytest.approx([2e4, 3e4, 4e4])
    assert t["compute_time"] == pytest.approx([1.8e4, 2.8e4, 3.8e4])
    assert t["barrier_time"] == pytest.approx([2e3, 2e3, 2e3])
    assert t["comm_time"] == pytest.approx([5e3] * 3)
    assert t["overlap_fraction"] == pytest.approx([0.6] * 3)   # (c+m-f)/m
    assert t["allgather_time"] == pytest.approx([1e3] * 3)
    assert t["energy_consumed"] == pytest.approx([3.0 / k] * 3)
    # full and compute chains alternate, each of k iterations
    assert seen[:6] == [("full", k), ("compute", k)] * 3
    g = res.global_meta
    assert g["reps_per_fence"] == k and g["energy_source"] == "fake"
    assert g["host_rtt_us"] >= 0


def test_card_state_is_read_beside_each_chain(monkeypatch):
    """A sampler that reads the card's state gives the SM clock and
    power after every full and every compute chain, in chain order."""
    log = []

    class StateSampler(_FakeSampler):
        def read_state(self):
            n = len(log)
            log.append(n)
            return {"sm_clock_mhz": 1900 + n, "power_w": 100.0 + n}

    monkeypatch.setattr(T_base.timing, "time_callable",
                        lambda fn, *a, reps=1, device=None, **kw:
                        [0.01] * reps)
    monkeypatch.setattr(T_base.timing, "time_chain",
                        lambda fn, *a, k=1, device=None, **kw: 0.01)
    bundle = T_base.StepBundle(full=lambda: None, compute=lambda: None,
                               comm=None, global_meta={})
    bundle.rank_meta = {"burn": {"planned_us": 1.0}}
    res = T_base.run_proxy("t", bundle, T_base.ProxyConfig(runs=3),
                           energy_sampler=StateSampler())
    assert bundle.rank_meta["card_state"] == {
        "sm_clock_mhz": [1900, 1902, 1904],
        "power_w": [100.0, 102.0, 104.0],
        "compute_sm_clock_mhz": [1901, 1903, 1905],
        "compute_power_w": [101.0, 103.0, 105.0]}
    assert bundle.rank_meta["burn"] == {"planned_us": 1.0}
    assert set(res.timers_us) == {"runtimes", "energy_consumed",
                                  "compute_time", "barrier_time"}
    # a sampler without the state (RAPL, hwmon) adds none
    bundle.rank_meta = {}
    T_base.run_proxy("t", bundle, T_base.ProxyConfig(runs=3),
                     energy_sampler=_FakeSampler())
    assert bundle.rank_meta == {}


def test_min_exectime_estimates_runs_from_warmup(monkeypatch):
    monkeypatch.setattr(T_base.timing, "time_callable",
                        lambda fn, *a, reps=1, device=None, **kw:
                        [9.0, 9.0, 0.1, 0.1][:reps])
    monkeypatch.setattr(T_base.timing, "time_chain",
                        lambda fn, *a, k=1, device=None, **kw: 0.1)
    bundle = T_base.StepBundle(full=lambda: None, compute=None, comm=None,
                               global_meta={})
    cfg = T_base.ProxyConfig(warmup=4, runs=5, min_exectime_s=0.75)
    res = T_base.run_proxy("t", bundle, cfg, energy_sampler=_FakeSampler())
    assert res.num_runs == 8 == T_base.estimate_runs([9, 9, .1, .1], .75)
    assert set(res.timers_us) == {"runtimes", "energy_consumed"}


# ------------------------------------------------------------ the CLI
def _dp(tmp_path, *extra):
    out = tmp_path / f"{len(list(tmp_path.iterdir()))}.jsonl"
    rc = cli.main(["dp", "--model", MODEL, "--num_buckets", "2",
                   "--platform", "cpu", "-r", "1", "-w", "1",
                   "--size_scale", "1e-5", "--time_scale", "1e-4",
                   *extra, "--out", str(out)])
    assert rc == 0
    return json.loads(out.read_text().strip())


def test_cli_dp_world1_record_and_buffer_dtype_stats(tmp_path):
    f32 = _dp(tmp_path, "--tag", "sweep=a")
    stats = _dp(tmp_path, "--buffer_dtype", "stats")    # bfloat16 file
    assert [b // 2 for b in f32["global"]["bucket_bytes"]] == \
        stats["global"]["bucket_bytes"]
    assert stats["global"]["buffer_dtype"] == "bfloat16"
    assert f32["global"]["variables"] == {"sweep": "a"}
    assert f32["global"]["world_size"] == 1
    assert f32["mesh"]["platform"] == "cpu"
    assert f32["ranks"][0]["summary"]["runtimes"]["n"] == 1
    assert not torch.distributed.is_initialized()     # torn down
    # the burn's plan: the schedule's compute in whole iterations
    g, burn = f32["global"], f32["ranks"][0]["burn"]
    assert burn["ns_per_iter"] == g["burn_ns_per_iter"]
    assert burn["planned_us"] == pytest.approx(
        burn["iters"] * burn["ns_per_iter"] / 1e3)
    sched_us = g["fwd_us"] + 2 * g["bwd_us_per_bucket"]
    assert abs(burn["planned_us"] - sched_us) <= \
        3 * burn["ns_per_iter"] / 1e3


def test_cli_fsdp_world1_record(tmp_path):
    out = tmp_path / "f.jsonl"
    assert cli.main(["fsdp", "--model", MODEL, "--num_units", "3",
                     "--platform", "cpu", "-r", "2", "-w", "1",
                     "--size_scale", "1e-5", "--time_scale", "1e-4",
                     "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    g = rec["global"]
    assert (g["sharding_factor"], g["num_replicas"]) == (1, 1)
    burn = rec["ranks"][0]["burn"]
    assert abs(burn["planned_us"] - 3 * (g["fwd_us_per_unit"]
                                         + g["bwd_us_per_unit"])) <= \
        6 * burn["ns_per_iter"] / 1e3
    assert len(rec["ranks"][0]["allgather_time"]) == 2
    assert len(rec["ranks"][0]["reduce_scatter_time"]) == 2


@pytest.mark.parametrize("argv,msg", [
    (["-d", "2"], "torchrun"),
    (["--buffer_dtype", "float8"], "float8"),
    (["--reps_per_fence", "0"], "reps_per_fence"),
    (["--tag", "novalue"], "KEY=VALUE"),
])
def test_cli_refusals(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["dp", "--model", MODEL, "--num_buckets", "2",
                  "--platform", "cpu", *argv])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_cli_refuses_cuda_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli.main(["fsdp", "--model", MODEL, "--num_units", "2"])
    assert "--platform cpu" in capsys.readouterr().err


def test_cli_refuses_a_float8_stats_file(capsys):
    with pytest.raises(SystemExit):
        cli.main(["dp", "--model", "gpt2_l_16_float8", "--num_buckets", "2",
                  "--platform", "cpu", "--buffer_dtype", "stats"])
    assert "float8" in capsys.readouterr().err


# ------------------------------------------------------------ NVML
class _StubNvml:
    """The NVML calls the sampler makes, over a settable counter, SM
    clock and power."""

    def __init__(self, mj=0, rc=0):
        self.mj, self.rc, self.index, self.uuid = mj, rc, None, None
        self.clock_type, self.mhz, self.mw = None, 1980, 205_250

    def nvmlInit_v2(self):
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        self.index = index.value
        handle._obj.value = 1000 + index.value
        return 0

    def nvmlDeviceGetHandleByUUID(self, uuid, handle):
        self.uuid = uuid
        handle._obj.value = 7
        return 0

    def nvmlDeviceGetTotalEnergyConsumption(self, handle, mj):
        assert isinstance(handle, ctypes.c_void_p) and handle.value
        mj._obj.value = self.mj
        return self.rc

    def nvmlDeviceGetClockInfo(self, handle, clock_type, mhz):
        self.clock_type = clock_type.value
        mhz._obj.value = self.mhz
        return 0

    def nvmlDeviceGetPowerUsage(self, handle, mw):
        if self.mw is None:
            return 3                    # NVML_ERROR_NOT_SUPPORTED
        mw._obj.value = self.mw
        return 0


def test_nvml_sampler_reads_joules_of_the_ranks_card():
    lib = _StubNvml(mj=123456)
    s = T_energy.NvmlSampler(1, lib=lib, environ={})
    assert s.available and s.source == "nvml" and lib.index == 1
    assert s.read_joules() == pytest.approx(123.456)
    lib.mj = 125456
    assert s.read_joules() == pytest.approx(125.456)
    # the SM clock (nvmlClockType_t NVML_CLOCK_SM = 1) and mW as W
    assert s.read_state() == {"sm_clock_mhz": 1980, "power_w": 205.25}
    assert lib.clock_type == 1
    lib.mw = None
    assert s.read_state() == {"sm_clock_mhz": 1980, "power_w": None}
    # torch's index is NVML's after CUDA_VISIBLE_DEVICES' mapping
    lib = _StubNvml(mj=5)
    s = T_energy.NvmlSampler(1, lib=lib,
                             environ={"CUDA_VISIBLE_DEVICES": "3,5"})
    assert s.available and lib.index == 5 and s.nvml_index == 5
    lib = _StubNvml(mj=5)
    s = T_energy.NvmlSampler(0, lib=lib,
                             environ={"CUDA_VISIBLE_DEVICES": "GPU-ab12"})
    assert s.available and lib.uuid == b"GPU-ab12" and lib.index is None
    # a card without the counter is no sampler
    assert not T_energy.NvmlSampler(0, lib=_StubNvml(rc=3),
                                    environ={}).available


def test_detect_sampler_tries_nvml_first_and_only_on_a_card(monkeypatch):
    made = []

    class Fake:
        source = "nvml"

        def __init__(self, index):
            made.append(index)
            self.available = True

    monkeypatch.setattr(T_energy, "NvmlSampler", Fake)
    monkeypatch.setattr(T_energy, "_CACHED", {})
    s = T_energy.detect_sampler(torch.device("cuda", 2))
    assert isinstance(s, Fake) and made == [2]
    assert T_energy.detect_sampler(torch.device("cuda", 2)) is s
    T_energy.detect_sampler(torch.device("cpu"))
    assert made == [2]                  # never NVML for a CPU run


def test_detect_sampler_gives_no_host_joules_for_a_card(monkeypatch):
    class NoNvml:
        def __init__(self, index):
            self.available = False

    def host_sensor(*a, **kw):
        raise AssertionError("a card's record must not hold host joules")

    monkeypatch.setattr(T_energy, "NvmlSampler", NoNvml)
    monkeypatch.setattr(T_energy, "RaplSampler", host_sensor)
    monkeypatch.setattr(T_energy, "HwmonSampler", host_sensor)
    monkeypatch.setattr(T_energy, "_CACHED", {})
    assert T_energy.detect_sampler(torch.device("cuda", 0)) is None
