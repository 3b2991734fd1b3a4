"""The port's pipeline hybrids (hybrid_2d, hybrid_3d, hybrid_3d_moe under
gpipe, 1f1b and zb) and sequence-parallel proxies (ring_attention,
ulysses) against the JAX package's, on the CPU: the new collectives bit
for bit against JAX's lax ops, the grid and sp meshes against JAX's
device layouts, each bundle's meta and every program's per-rank
collective and send/recv counts against the JAX program's jaxpr, the
1F1B hop independence against GPipe's chain, the bubble from scripted
ticks, the records through JAX's parser, and the CLI at world 1.

The four ranks run ``_gloo_worker`` in spawned processes, which import
this module: jax and the JAX package are imported inside the tests and
fixtures only, never at module level, so the workers load neither."""
from __future__ import annotations

import json
import multiprocessing
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch import cli
from dlnetbench_tpu_torch.core.schedule import zb_tables, zb_unit_ticks
from dlnetbench_tpu_torch.proxies import pipeline_common as T_pipe
from dlnetbench_tpu_torch.utils.net import free_port
from test_torch_proxies import MESH_KEYS, _count_collectives

REPO = Path(__file__).resolve().parent.parent
PORT_STATS = REPO / "dlnetbench_tpu_torch" / "data" / "model_stats"
MODEL = "gpt2_l_16_bfloat16"
MOE_MODEL = "mixtral_8x7b_16_bfloat16"
TINY = dict(size_scale=1e-5, time_scale=2e-4)
WORLD = 4
COLL_DTYPES = ("float32", "bfloat16", "int8")
# (op, axis, kwargs): axis x is the flat group, tp and pp the (1, 2, 2)
# grid's; the sender sets leave some ranks receiving nothing
COLL_CASES = [
    ("alltoall", "x", {}), ("alltoall", "tp", {}), ("alltoall", "pp", {}),
    ("ring_shift", "x", {}), ("ring_shift", "x", {"shift": 3}),
    ("ring_shift", "tp", {}), ("ring_shift", "pp", {}),
    ("shift_up", "x", {}), ("shift_up", "x", {"senders": (1, 2)}),
    ("shift_up", "pp", {}), ("shift_down", "x", {}),
    ("shift_down", "x", {"senders": (3,)}),
    ("shift_down", "tp", {"senders": ()}), ("shift_down", "pp", {}),
]
# (kind, (sizes)): grid = (dp, pp, tp), sp = (sp, dp)
MESHES = [("grid", (1, 2, 2)), ("grid", (2, 2, 1)), ("grid", (1, 4, 1)),
          ("sp", (4, 1)), ("sp", (2, 2))]
# key -> (proxy, build kwargs shared by both packages)
BUNDLES = {
    **{f"2d_s4_{s}": ("hybrid_2d", dict(num_stages=4, num_microbatches=4,
                                        dp=1, schedule=s))
       for s in T_pipe.SCHEDULES},
    **{f"2d_s2_dp2_{s}": ("hybrid_2d", dict(num_stages=2,
                                            num_microbatches=4, dp=2,
                                            schedule=s))
       for s in T_pipe.SCHEDULES},
    "3d_s2_tp2": ("hybrid_3d", dict(num_stages=2, num_microbatches=4,
                                    tp=2)),
    "moe_s2_ep2": ("hybrid_3d_moe", dict(num_stages=2, num_microbatches=4,
                                         num_expert_shards=2)),
    "ring_sp4": ("ring_attention", dict(sp=4, max_layers=2)),
    "ring_sp2_dp2": ("ring_attention", dict(sp=2, dp=2, max_layers=2)),
    "ulysses_sp2_dp2": ("ulysses", dict(sp=2, dp=2, max_layers=2)),
}
RECORDED = ("2d_s2_dp2_gpipe", "ring_sp4", "ulysses_sp2_dp2")


def _coll_inputs(dtype_name: str) -> np.ndarray:
    rng = np.random.default_rng(17)
    if dtype_name == "int8":
        return rng.integers(-100, 101, (WORLD, 24)).astype(np.int8)
    return (rng.integers(-64, 65, (WORLD, 24)) / 8).astype(np.float32)


def _model(key: str) -> str:
    return MOE_MODEL if key.startswith("moe") else MODEL


# ------------------------------------------------------------ gloo ranks
def _gloo_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of the 4-process world: the collective cases, the mesh
    layouts, every bundle's meta, each program's counts and order, and
    rank 0's records of the ``RECORDED`` bundles."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from dlnetbench_tpu_torch.core.model_card import (
        arch_name_from_stats_name, load_model_card)
    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.metrics.emit import emit_result
    from dlnetbench_tpu_torch.parallel import collectives as col
    from dlnetbench_tpu_torch.parallel import multihost
    from dlnetbench_tpu_torch.core.schedule import Grid3D
    from dlnetbench_tpu_torch.parallel.mesh import (make_grid_mesh,
                                                    make_sp_mesh,
                                                    mesh_from_grid)
    from dlnetbench_tpu_torch.proxies import base
    from dlnetbench_tpu_torch.proxies import (hybrid_2d, hybrid_3d,
                                              hybrid_3d_moe, ring_attention,
                                              ulysses)
    device = multihost.initialize("cpu")
    res = {"coll": {}, "coll_counts": {}, "meshes": {}, "meta": {},
           "counts": {}, "orders": {}, "burn": {}}
    grid = make_grid_mesh(1, 2, 2, device)
    groups = {"x": None, "tp": grid.groups["tp"], "pp": grid.groups["pp"]}
    for name in COLL_DTYPES:
        x = torch.from_numpy(_coll_inputs(name)[rank]).to(getattr(torch,
                                                                  name))
        for i, (op, axis, kw) in enumerate(COLL_CASES):
            out = torch.full_like(x, 99)      # zeros must be written
            col.reset_counts()
            getattr(col, op)(out, x, group=groups[axis], **kw)
            res["coll"][name, i] = out.float().numpy()
            res["coll_counts"][i] = col.counts()

    for kind, sizes in MESHES:
        mesh = (mesh_from_grid(Grid3D(*sizes), device) if kind == "grid"
                else make_sp_mesh(*sizes, device))
        res["meshes"][kind, sizes] = (mesh.coords, {
            axis: (dist.get_process_group_ranks(g) if g is not None
                   else list(range(WORLD)))
            for axis, g in mesh.groups.items()})

    mods = {"hybrid_2d": hybrid_2d, "hybrid_3d": hybrid_3d,
            "hybrid_3d_moe": hybrid_3d_moe,
            "ring_attention": ring_attention, "ulysses": ulysses}
    cfg = base.ProxyConfig(warmup=1, runs=2, **TINY)
    for key, (proxy, kw) in BUNDLES.items():
        stats = load_model_stats(_model(key))
        card = load_model_card(arch_name_from_stats_name(_model(key)))
        bundle = mods[proxy].build(stats, card, cfg, device, **kw)
        res["meta"][key] = dict(bundle.global_meta)
        res["burn"][key] = bundle.rank_meta["burn"]
        progs = {"full": bundle.full, "compute": bundle.compute,
                 "comm": bundle.comm, **bundle.variants}
        for pname, fn in progs.items():
            col.reset_counts()
            fn()
            res["counts"][key, pname] = col.counts()
            if key.startswith("2d_s4") and pname in ("comm", "pp_comm"):
                res["orders"][key, pname] = fn.order
        if key in RECORDED:
            result = base.run_proxy(proxy, bundle, cfg)
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
    out = tmp_path_factory.mktemp("gloo4_pipe")
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_gloo_worker, args=(r, port, str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
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


# ------------------------------------------------------------ collectives
def _jax_coords(shape, r: int) -> tuple:
    return tuple(int(c) for c in np.unravel_index(r, shape))


def _jax_case(x: np.ndarray, op: str, axis: str, kw: dict):
    """JAX's op on row r of ``x`` on device r: the per-device results and
    the program's jaxpr."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P
    from dlnetbench_tpu.parallel import collectives as J_col
    from dlnetbench_tpu.utils.jax_compat import shard_map
    shape, axes = ((WORLD,), ("x",)) if axis == "x" else \
        ((1, 2, 2), ("dp", "pp", "tp"))
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(shape), axes)
    spec = P(axes)
    body = shard_map(lambda v: getattr(J_col, op)(v[0], axis, **kw)[None],
                     mesh=mesh, in_specs=spec, out_specs=spec,
                     check_vma=False)
    arr = jnp.asarray(x)
    return (np.asarray(body(arr).astype(jnp.float32)),
            jax.make_jaxpr(body)(arr), shape, axes)


@pytest.mark.parametrize("dtype_name", COLL_DTYPES)
def test_collectives_equal_jax_bit_for_bit(gloo_world, dtype_name,
                                           eight_devices):
    """alltoall, ring_shift, shift_up and shift_down, with and without
    sender sets, on the flat group and the grid's tp and pp axes: every
    rank's result equals JAX's, zeros where a rank receives nothing, and
    its send / recv / alltoall counts equal what the jaxpr's ops give its
    coordinate."""
    import jax.numpy as jnp
    ranks, _ = gloo_world
    x = _coll_inputs(dtype_name)
    jx = x.astype(jnp.bfloat16) if dtype_name == "bfloat16" else x
    for i, (op, axis, kw) in enumerate(COLL_CASES):
        want, jaxpr, shape, axes = _jax_case(jx, op, axis, kw)
        for r, res in enumerate(ranks):
            got = res["coll"][dtype_name, i]
            np.testing.assert_array_equal(got, want[r],
                                          err_msg=f"{op} {axis} {kw} r{r}")
            coords = dict(zip(axes, _jax_coords(shape, r)))
            assert res["coll_counts"][i] == _count_collectives(
                jaxpr, coords), (op, axis, kw, r)
    # the zeros: shift_up with senders (1, 2) leaves ranks 0 and 1
    # receiving nothing
    i = COLL_CASES.index(("shift_up", "x", {"senders": (1, 2)}))
    for r in (0, 1):
        assert not ranks[r]["coll"][dtype_name, i].any()


@pytest.mark.parametrize("kind,sizes", MESHES)
def test_meshes_equal_jax_device_layouts(gloo_world, kind, sizes,
                                         eight_devices):
    """Each rank's coordinates and each axis group's members are the
    positions of JAX's mesh devices (device r = rank r)."""
    from dlnetbench_tpu.parallel import mesh as J_mesh
    ranks, _ = gloo_world
    devs = eight_devices[:WORLD]
    jm = (J_mesh.make_grid_mesh(*sizes, devices=devs) if kind == "grid"
          else J_mesh.make_sp_mesh(*sizes, devices=devs))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r, res in enumerate(ranks):
        coords, groups = res["meshes"][kind, sizes]
        pos = tuple(int(c) for c in np.argwhere(ids == r)[0])
        assert coords == pos
        assert list(groups) == list(jm.axis_names)
        for k, axis in enumerate(jm.axis_names):
            line = list(pos)
            line[k] = slice(None)
            assert groups[axis] == ids[tuple(line)].tolist(), (axis, r)


# ------------------------------------------------------------ bundles
@pytest.fixture(scope="module")
def jax_bundles(eight_devices):
    """JAX's bundles of ``BUNDLES`` at world 4 on the port's stats files."""
    from dlnetbench_tpu.core.model_card import (arch_name_from_stats_name,
                                                load_model_card)
    from dlnetbench_tpu.core.model_stats import load_model_stats
    from dlnetbench_tpu.proxies import base as J_base
    from dlnetbench_tpu.proxies import (hybrid_2d, hybrid_3d, hybrid_3d_moe,
                                        ring_attention, ulysses)
    mods = {"hybrid_2d": hybrid_2d, "hybrid_3d": hybrid_3d,
            "hybrid_3d_moe": hybrid_3d_moe,
            "ring_attention": ring_attention, "ulysses": ulysses}
    cfg = J_base.ProxyConfig(warmup=1, runs=2, **TINY)
    out = {}
    for key, (proxy, kw) in BUNDLES.items():
        stats = load_model_stats(_model(key), PORT_STATS)
        card = load_model_card(arch_name_from_stats_name(_model(key)))
        out[key] = mods[proxy].build(stats, card, cfg,
                                     devices=eight_devices[:WORLD], **kw)
    return cfg, out


# measured or build-time keys: the calibration, the compile times and
# the mesh (its common keys are compared apart)
UNCOMPARED = {"burn_ns_per_iter", "compile_ms", "aot", "mesh",
              "compile_cache_dir"}


@pytest.mark.parametrize("key", list(BUNDLES))
def test_bundle_meta_and_per_rank_counts_equal_jax(gloo_world, jax_bundles,
                                                   key):
    """The meta keys are JAX's (but compile_cache_dir), the schedule and
    byte keys equal; for each program each rank's allreduce / alltoall
    counts equal the jaxpr's psum / all_to_all equations and its send /
    recv counts what the jaxpr's ppermute perms give its coordinate."""
    import jax
    ranks, _ = gloo_world
    _, bundles = jax_bundles
    jb = bundles[key]
    jm = jb.global_meta
    for res in ranks:
        tm = res["meta"][key]
        assert set(tm) == set(jm) - {"compile_cache_dir"}
        for k in set(tm) - UNCOMPARED:
            assert tm[k] == jm[k], k
        for k in MESH_KEYS:
            assert tm["mesh"][k] == jm["mesh"][k], k
    shape = tuple(jm["mesh"]["axes"].values())
    axes = tuple(jm["mesh"]["axes"])
    progs = {"full": jb.full, "compute": jb.compute, "comm": jb.comm,
             **jb.variants}
    assert {p for k, p in ranks[0]["counts"] if k == key} == set(progs)
    for pname, prog in progs.items():
        jaxpr = jax.make_jaxpr(prog.traceable)(*prog.example_args)
        for r, res in enumerate(ranks):
            coords = dict(zip(axes, _jax_coords(shape, r)))
            assert res["counts"][key, pname] == _count_collectives(
                jaxpr, coords), (pname, r)


def test_pipeline_counts_per_rank(gloo_world):
    """Spot values of the above: hybrid_2d S=4 gpipe's hop-only program
    moves M messages on each of a stage's edges and directions, and the
    MoE step issues 2 x M waves of 2 x layers_per_stage all-to-alls and
    the two-level gradient sync."""
    ranks, _ = gloo_world
    M = 4
    for stage, res in enumerate(ranks):
        got = res["counts"]["2d_s4_gpipe", "pp_comm"]
        edges = (stage > 0) + (stage < 3)     # neighbours
        assert got["send"] == got["recv"] == M * edges
        moe = res["counts"]["moe_s2_ep2", "full"]
        lps = res["meta"]["moe_s2_ep2"]["layers_per_stage"]
        assert moe["alltoall"] == 2 * M * 2 * lps
        assert moe["allreduce"] == 2


# ------------------------------------------------------------ 1F1B vs GPipe
@pytest.mark.parametrize("schedule", T_pipe.SCHEDULES)
def test_1f1b_hops_independent_gpipe_chained(gloo_world, schedule):
    """What each rank's comm streams recorded (``collectives.Order``):
    GPipe's hops form one chain, in the hop-only program and in the comm
    program; 1F1B's and ZB's up-hop and down-hop of a tick depend on
    neither, while each depends on its own lane's previous hop."""
    ranks, _ = gloo_world
    key = f"2d_s4_{schedule}"
    for stage, res in enumerate(ranks):
        for pname in ("pp_comm", "comm"):
            order = res["orders"][key, pname]
            after = order.after_all()
            hops = [i for i, (name, _) in enumerate(order.ops)
                    if name.startswith("shift")]
            assert hops, (stage, pname)
            if schedule == "gpipe":
                assert all(h in after[j] for i, j in enumerate(hops)
                           for h in hops[:i]), (stage, pname)
                continue
            ups = [i for i in hops if order.ops[i][0] == "shift_up"]
            downs = [i for i in hops if order.ops[i][0] == "shift_down"]
            for lane in (ups, downs):
                assert all(a in after[b] for a, b in zip(lane, lane[1:]))
            # a tick's pair: the down-hop issued right after an up-hop
            pairs = [(u, d) for u, d in zip(hops, hops[1:])
                     if order.ops[u][0] == "shift_up"
                     and order.ops[d][0] == "shift_down"]
            indep = [p for p in pairs
                     if p[0] not in after[p[1]] and p[1] not in after[p[0]]]
            assert indep == pairs and pairs, (stage, pname)
            if 0 < stage < 3:        # a middle stage hops both ways often
                assert len(pairs) >= 2, (stage, pname)


# ------------------------------------------------------------ the bubble
def _edges(op, stage, S):
    """The (sender, receiver) stage pairs this stage takes part in."""
    _, t, lane, up, senders = op
    step = 1 if up else -1
    out = []
    if stage in senders and 0 <= stage + step < S:
        out.append((stage, stage + step))
    if stage - step in senders and 0 <= stage - step < S:
        out.append((stage - step, stage))
    return [(lane, t, e) for e in out]


def _simulate(schedule, S, M, units):
    """Every stage's ``rank_ops`` run against a scripted clock: a burn
    takes its iterations in units, a hop lands when both of its ends have
    issued it (after the burns before it and its lane's previous hop), a
    join waits for its lanes' last hops.  Returns the makespan, each
    stage's log of (tick, kind, iters, start) and its compute-only
    time."""
    zb = zb_tables(S, M) if schedule == "zb" else None
    progs = [T_pipe.rank_ops(schedule, S, M, s, units, zb=zb)
             for s in range(S)]
    pc, now = [0] * S, [0.0] * S
    lane_free = [{} for _ in range(S)]
    last = [{} for _ in range(S)]
    issued: dict = {}
    log = [[] for _ in range(S)]
    while any(pc[s] < len(progs[s]) for s in range(S)):
        moved = False
        for s in range(S):
            while pc[s] < len(progs[s]):
                op = progs[s][pc[s]]
                if op[0] == "burn":
                    log[s].append((op[1], op[2], op[3], now[s]))
                    now[s] += op[3]
                elif op[0] == "hop":
                    t0 = max(now[s], lane_free[s].get(op[2], 0.0))
                    es = _edges(op, s, S)
                    for e in es:
                        issued.setdefault(e, []).append(t0)
                    last[s][op[2]] = (t0, es)
                elif op[0] == "join":
                    if any(len(issued[e]) < 2 for lane in op[2]
                           for e in last[s][lane][1]):
                        break                   # the peer has not issued
                    for lane in op[2]:
                        t0, es = last[s][lane]
                        done = max([t0] + [max(issued[e]) for e in es])
                        lane_free[s][lane] = done
                        now[s] = max(now[s], done)
                pc[s] += 1
                moved = True
        assert moved, "the ranks' ops deadlock"
    compute = [sum(o[3] for o in T_pipe.rank_ops(
        schedule, S, M, s, units, zb=zb, with_comm=False)) for s in range(S)]
    return max(now), log, compute


@pytest.mark.parametrize("schedule", T_pipe.SCHEDULES)
@pytest.mark.parametrize("S,M", [(4, 4), (2, 4), (4, 8)])
def test_bubble_from_scripted_ticks(schedule, S, M):
    """With a scripted burn (a forward 1 unit, a backward 2, zb's halves
    1 each) logging (tick, iters): every stage burns M ticks a direction
    and idles S-1; the critical path through the hops is M+S-1 ticks a
    direction for gpipe and 1f1b (their ticks_total), 3M+S-1 for zb; the
    compute-only program has no bubble, so full / compute =
    ticks_total / (3M)."""
    units = {"f": 1, "b": 2, "h": 1}
    makespan, log, compute = _simulate(schedule, S, M, units)
    T = M + S - 1
    # each direction's clock: gpipe T forward then T backward ticks;
    # 1f1b's forward is its fill and steady ticks, its backward its
    # steady and drain ticks
    clock = {"gpipe": (range(T), range(T, 2 * T)),
             "1f1b": (range(T), range(S - 1, S - 1 + T))}
    for s in range(S):
        kinds = [k for _, k, _, _ in log[s]]
        if schedule == "zb":
            assert kinds.count("f") == kinds.count("b") \
                == kinds.count("w") == M
            continue
        for kind, ticks in zip("fb", clock[schedule]):
            active = [t for t, k, _, _ in log[s] if k == kind]
            assert len(set(active)) == M and set(active) <= set(ticks)
            assert len(ticks) - M == S - 1          # the idle ticks
        if schedule == "gpipe":
            assert [t for t, k, _, _ in log[s] if k == "f"] == \
                list(range(s, s + M))
    assert compute == [3 * M] * S
    zb = zb_tables(S, M) if schedule == "zb" else None
    ticks_total = zb_unit_ticks(zb, 2.0) if zb else 3.0 * (M + S - 1)
    assert makespan == ticks_total
    if schedule == "zb":
        assert ticks_total == 3 * M + S - 1
    elif schedule == "gpipe":
        # the forward wave: the last stage's last forward ends at M+S-1
        last_f = max(st + n for t, k, n, st in log[S - 1] if k == "f")
        assert last_f == M + S - 1
    assert makespan / compute[0] == pytest.approx(ticks_total / (3 * M))


# ------------------------------------------------------------ records
@pytest.mark.parametrize("key", RECORDED)
def test_records_load_through_the_jax_parser_as_jax_records(
        gloo_world, jax_bundles, key, tmp_path):
    from dlnetbench_tpu.metrics.emit import emit_result as J_emit
    from dlnetbench_tpu.metrics.parser import get_metrics_dataframe
    from dlnetbench_tpu.proxies.base import run_proxy as J_run
    _, out = gloo_world
    cfg, bundles = jax_bundles
    proxy = BUNDLES[key][0]
    J_emit(J_run(proxy, bundles[key], cfg), path=str(tmp_path / "j.jsonl"))
    jdf = get_metrics_dataframe(tmp_path / "j.jsonl", proxy)
    tdf = get_metrics_dataframe(out / f"{key}.jsonl", proxy)
    assert len(tdf) == WORLD * 2 and sorted(tdf["rank"].unique()) == [
        0, 1, 2, 3]
    # every column of JAX's record, its attribution verdict included, and
    # the count of processes
    assert set(tdf.columns) == set(jdf.columns) | {"num_processes"}
    for col in ("runtime", "compute_time", "barrier_time", "comm_time"):
        assert tdf[col].notna().all(), col
    rec = json.loads((out / f"{key}.jsonl").read_text())
    assert all(set(r["burn"]) == {"ns_per_iter", "iters", "planned_us"}
               for r in rec["ranks"])


@pytest.mark.parametrize("key", RECORDED)
def test_proxy_summary_reads_the_records(gloo_world, key):
    """``proxy_summary`` on a world-4 record: each comm_model region's
    slowest-rank median and its bytes over it, NCCL's bus factors, the
    hop rate, and the schedule's bubble (S=2, M=4 gpipe: 5/4; ring: 1)."""
    import statistics

    from dlnetbench_tpu_torch.proxy_summary import summarize
    _, out = gloo_world
    rec = json.loads((out / f"{key}.jsonl").read_text())
    g, got = rec["global"], summarize(rec)
    assert (got["world"], got["device"], got["proxy"]) == (
        WORLD, "cpu", BUNDLES[key][0])
    for region, parts in g["comm_model"].items():
        ms = max(statistics.median(r[region]) for r in rec["ranks"]) / 1e3
        nbytes = sum(p["bytes"] for p in parts)
        assert got[region]["ms"] == ms
        assert got[region]["algbw_GBps"] == pytest.approx(nbytes / ms / 1e6)
    if key.startswith("2d"):
        # the dp allreduce over 2 ranks: bus = 2(n-1)/n = 1 x algorithm
        dp = got["dp_comm_time"]
        assert dp["busbw_GBps"] == pytest.approx(dp["algbw_GBps"])
        pp = got["pp_comm_time"]
        assert pp["hop_GBps"] == pytest.approx(
            g["pipe_msg_bytes"] * g["pp_permute_ticks"] / pp["ms"] / 1e6)
        assert got["bubble_model"] == pytest.approx(5 / 4)
    elif key.startswith("ring"):
        ring = got["ring_comm_time"]
        assert ring["busbw_GBps"] == ring["algbw_GBps"]
        assert got["bubble_model"] == 1.0
    else:
        # the all-to-alls over sp = 2: bus = (n-1)/n = half the algorithm
        a2a = got["a2a_comm_time"]
        assert a2a["busbw_GBps"] == pytest.approx(a2a["algbw_GBps"] / 2)
        assert got["bubble_model"] == 1.0
    assert got["bubble"] == got["runtimes_ms"] / got["compute_time_ms"]


# proxy_summary's bus factors before it took analysis.bandwidth's
PARENT_BUS_FACTOR = {"allreduce": lambda n: 2 * (n - 1) / n,
                     "alltoall": lambda n: (n - 1) / n,
                     "allgather": lambda n: (n - 1) / n,
                     "reduce_scatter": lambda n: (n - 1) / n,
                     "p2p": lambda n: 1.0}


@pytest.mark.parametrize("key", RECORDED)
def test_proxy_summary_bus_factors_unchanged(gloo_world, key, monkeypatch):
    """proxy_summary's output is byte for byte what its private factors
    gave, now through analysis.bandwidth.bus_factor."""
    from dlnetbench_tpu_torch import proxy_summary
    _, out = gloo_world
    rec = json.loads((out / f"{key}.jsonl").read_text())
    got = json.dumps(proxy_summary.summarize(rec))
    monkeypatch.setattr(proxy_summary, "bus_factor", lambda kind, n:
                        PARENT_BUS_FACTOR[kind](max(n, 1)))
    assert got == json.dumps(proxy_summary.summarize(rec))


@pytest.mark.parametrize("key", RECORDED)
def test_gloo_records_through_the_record_pipeline(gloo_world, key):
    """The hybrid_2d, ring and Ulysses records: equal bandwidth frames
    and blame reports through both packages, the port's verdict words,
    and the gathered record merging to itself in the port."""
    import pandas as pd

    from dlnetbench_tpu.analysis import bandwidth as J_bw
    from dlnetbench_tpu.analysis import critical_path as J_cp
    from dlnetbench_tpu_torch.analysis import bandwidth as T_bw
    from dlnetbench_tpu_torch.analysis import critical_path as T_cp
    from dlnetbench_tpu_torch.metrics.merge import merge_records
    _, out = gloo_world
    rec = json.loads((out / f"{key}.jsonl").read_text())
    for fn in ("effective_bandwidth", "bandwidth_summary"):
        want = getattr(J_bw, fn)([rec])
        assert len(want)
        pd.testing.assert_frame_equal(getattr(T_bw, fn)([rec]), want)
    assert T_cp.blame_report(rec) == J_cp.blame_report(rec)
    attr = rec["global"]["attribution"]
    assert attr["bound"] == "host" and rec["mesh"]["gathered"] is True
    assert merge_records([rec]) == rec


def test_world1_hops_and_alltoall_on_gloo():
    """At world 1 (a one-rank gloo group) ring_shift sends to the rank
    itself — a local copy, as gloo has no pair to its own rank — and
    returns the input, as JAX's ppermute over one device does; shift_up /
    shift_down have no edge and give zeros; alltoall returns the input."""
    from dlnetbench_tpu_torch.parallel import collectives as col
    from dlnetbench_tpu_torch.parallel import multihost
    multihost.initialize("cpu")
    try:
        x = torch.arange(8, dtype=torch.bfloat16)
        outs = {op: torch.full_like(x, 5) for op in
                ("ring_shift", "shift_up", "shift_down", "alltoall")}
        col.reset_counts()
        for op, out in outs.items():
            getattr(col, op)(out, x)
        assert col.counts() == {"allreduce": 0, "allgather": 0,
                                "reduce_scatter": 0, "alltoall": 1,
                                "send": 1, "recv": 1}
    finally:
        multihost.shutdown()
    assert torch.equal(outs["ring_shift"], x)
    assert torch.equal(outs["alltoall"], x)
    assert not outs["shift_up"].any() and not outs["shift_down"].any()


# ------------------------------------------------------------ the CLI
CLI_RUNS = {
    "hybrid_2d": ["--model", MODEL, "--num_stages", "1",
                  "--num_microbatches", "4"],
    "hybrid_3d": ["--model", MODEL, "--num_stages", "1",
                  "--num_microbatches", "4", "--tp", "1",
                  "--schedule", "1f1b"],
    "hybrid_3d_moe": ["--model", MOE_MODEL, "--num_stages", "1",
                      "--num_microbatches", "4", "--num_expert_shards", "1",
                      "--schedule", "zb"],
    "ring_attention": ["--model", MODEL, "--sp", "1", "--max_layers", "2"],
    "ulysses": ["--model", MODEL, "--sp", "1", "--max_layers", "2"],
}
CLI_TIMERS = {"hybrid_2d": ["pp_comm_time", "dp_comm_time"],
              "hybrid_3d": ["pp_comm_time", "dp_comm_time", "tp_comm_time"],
              "hybrid_3d_moe": ["pp_comm_time", "ep_comm_time",
                                "dp_ep_comm_time"],
              "ring_attention": ["ring_comm_time"],
              "ulysses": ["a2a_comm_time"]}


@pytest.mark.parametrize("proxy", list(CLI_RUNS))
def test_cli_world1_record(proxy, tmp_path):
    out = tmp_path / "r.jsonl"
    assert cli.main([proxy, *CLI_RUNS[proxy], "--platform", "cpu", "-w",
                     "1", "-r", "2", "--size_scale", "1e-5",
                     "--time_scale", "2e-4", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    g, row = rec["global"], rec["ranks"][0]
    assert g["proxy"] == proxy and g["world_size"] == 1
    assert rec["num_runs"] == 2 and len(rec["ranks"]) == 1
    for t in ["runtimes", "compute_time", "barrier_time", "comm_time",
              *CLI_TIMERS[proxy]]:
        assert len(row[t]) == 2, t
    assert not torch.distributed.is_initialized()
    # world 1 burns exactly one step's stats time, in whole iterations
    burn = row["burn"]
    assert burn["planned_us"] == pytest.approx(
        burn["iters"] * burn["ns_per_iter"] / 1e3)
    if proxy.startswith("hybrid"):
        M = g["num_microbatches"]
        sched_us = M * (g["fwd_us_per_stage_mb"] + g["bwd_us_per_stage_mb"])
        assert abs(burn["planned_us"] - sched_us) <= \
            3 * M * burn["ns_per_iter"] / 1e3
        assert g["pp_edge_messages"] == 0 and g["dp"] == 1


REFUSALS = {
    "world": (["hybrid_3d", "--model", MODEL, "--num_microbatches", "4",
               "--num_stages", "2", "--tp", "1"], "hybrid_3d",
              dict(num_stages=2, num_microbatches=4, tp=1)),
    "dense": (["hybrid_3d_moe", "--model", MODEL, "--num_microbatches", "4",
               "--num_stages", "1", "--num_expert_shards", "1"],
              "hybrid_3d_moe",
              dict(num_stages=1, num_microbatches=4, num_expert_shards=1)),
    "heads": (["ulysses", "--model", MODEL, "--sp", "3", "--dp", "1"],
              "ulysses", dict(sp=3, dp=1)),
    "seq": (["ring_attention", "--model", MODEL, "--sp", "3", "--dp", "1"],
            "ring_attention", dict(sp=3, dp=1)),
    "schedule": (["hybrid_2d", "--model", MODEL, "--num_microbatches", "4",
                  "--num_stages", "1", "--schedule", "x"], None,
                 "invalid choice: 'x'"),
    "devices": (["hybrid_2d", "--model", MODEL, "--num_microbatches", "4",
                 "--num_stages", "1", "-d", "2"], None, "torchrun"),
    "max_layers": (["ulysses", "--model", MODEL, "--sp", "1",
                    "--max_layers", "-1"], None,
                   "--max_layers must be >= 0"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_cli_refusals_use_jax_messages(case, capsys, eight_devices):
    """At world 1: stages x tp = 2, a dense card for the MoE proxy,
    Ulysses' heads and sp not dividing seq_len are refused with the JAX
    builder's own message for the same arguments; an unknown schedule
    (argparse), -d (torchrun) and a negative --max_layers by name."""
    import importlib
    from dlnetbench_tpu.core.model_card import load_model_card
    from dlnetbench_tpu.core.model_stats import load_model_stats
    from dlnetbench_tpu.proxies import base as J_base
    argv, proxy, want = REFUSALS[case]
    if proxy is not None:
        build = importlib.import_module(f"dlnetbench_tpu.proxies.{proxy}")
        with pytest.raises(ValueError) as e:
            build.build(load_model_stats(MODEL, PORT_STATS),
                        load_model_card("gpt2_l"),
                        J_base.ProxyConfig(**TINY),
                        devices=eight_devices[:1], **want)
        want = str(e.value)
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--platform", "cpu"])
    assert e.value.code == 2
    assert want in capsys.readouterr().err
    assert not torch.distributed.is_initialized()
