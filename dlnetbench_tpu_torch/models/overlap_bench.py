"""Paired overlap-vs-baseline A/B of the SPMD train step (the JAX
package's ``models/overlap_bench.py``).

The real dp x pp x tp step is built twice — the baseline (blocking
collectives, monolithic gradient sync) and the overlapped config
(``tp_overlap="decomposed"`` + ``grad_sync="bucketed"``) — each in the
three A/B variants (full / compute / comm, ``models/spmd.VARIANTS``),
and the six programs are timed in interleaved rounds: every rank times
each program with ``utils/timing.time_chain`` after a barrier that
starts the round, and rank 0's samples are reported:

* the wall per config as ``{value, best, band, n}``,
* the paired per-round ratio band (below 1.0: the overlap wins),
* the measured overlap fraction per config
  (``metrics/stats.overlap_fraction``), and
* the overlapped config's attribution from its measured decomposition
  (``analysis/attribution.attribute_decomposition``): NCCL between the
  cards of one host binds as ``nvlink``, gloo between CPU processes as
  ``host``.

``assemble_line`` is pure, so the line's schema is held against the JAX
package's without a process group.
"""
from __future__ import annotations

import dataclasses

import torch

from dlnetbench_tpu_torch.metrics import stats as stats_mod


def assemble_line(metric: str, walls_s: dict[str, list[float]],
                  overlaps: dict[str, list[float]]) -> dict:
    """One paired overlap-vs-baseline JSON line: ``walls_s`` the
    per-round full-step seconds of "baseline" and "overlapped",
    ``overlaps`` the per-round overlap fractions of the same two; the
    headline ``value`` is the overlapped median."""
    summaries = {name: stats_mod.summarize(ts) for name, ts in
                 walls_s.items()}
    over = summaries["overlapped"]
    line = {
        "metric": metric,
        "value": round(over["value"] * 1e3, 3),
        "unit": "ms",
        "best": round(over["best"] * 1e3, 3),
        "band": [round(v * 1e3, 3) for v in over["band"]],
        "n": over["n"],
    }
    for name, s in summaries.items():
        line[name] = {
            "value": round(s["value"] * 1e3, 3),
            "best": round(s["best"] * 1e3, 3),
            "band": [round(v * 1e3, 3) for v in s["band"]],
            "n": s["n"],
        }
    # a 0.0 baseline wall makes the pair meaningless: dropped, and n on
    # the band says how many survived
    ratios = [o / b for o, b in zip(walls_s["overlapped"],
                                    walls_s["baseline"]) if b > 0]
    line["ratio_overlapped_vs_baseline"] = stats_mod.summarize(ratios,
                                                               ndigits=4)
    line["overlap_fraction"] = {
        name: stats_mod.summarize(vals, ndigits=4)
        for name, vals in overlaps.items()}
    return stats_mod.flag_low_mode(line)


def mesh_desc(mesh) -> str:
    return "x".join(f"{a}={s}" for a, s in mesh.axes.items())


def build_programs(mesh, cfg_kwargs: dict | None = None, seed: int = 0):
    """``(cfgs, programs, params, tokens)``: six step programs —
    {config: {variant: fn(params, tokens)}} for the baseline and the
    overlapped config in the three A/B variants, on ``mesh``."""
    from dlnetbench_tpu_torch.models import spmd
    dp, pp, tp = (mesh.axes[a] for a in ("dp", "pp", "tp"))
    kw = dict(cfg_kwargs or {})
    kw.setdefault("batch", dp * 2 * 2)
    kw.setdefault("num_microbatches", 2)
    base = spmd.SpmdConfig(tp_overlap="none", grad_sync="monolithic", **kw)
    # the defaults resolved here, so the metric names the chunk grain
    # the programs ran
    base = base.resolve_tuned(dp, pp, tp, mesh.device)
    over = dataclasses.replace(base, tp_overlap="decomposed",
                               grad_sync="bucketed")
    cfgs = {"baseline": base, "overlapped": over}
    programs = {name: {v: spmd.make_train_step(mesh, cfg, variant=v)
                       for v in spmd.VARIANTS}
                for name, cfg in cfgs.items()}
    params = spmd.shard_params(
        spmd.init_params(base, seed=seed, device=mesh.device), mesh, base)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(seed + 1)
    tokens = torch.randint(0, base.vocab_size,
                           (base.batch, base.seq_len + 1), generator=gen,
                           device=mesh.device)
    return cfgs, programs, params, tokens


def measure(mesh, cfg_kwargs: dict | None = None, rounds: int = 3,
            reps: int = 2) -> dict:
    """Run the paired A/B on every rank of ``mesh`` and return rank 0's
    line (the same dict on every rank; not printed).  Needs >= 2 ranks:
    one rank has no communication to overlap (ValueError)."""
    from dlnetbench_tpu_torch.analysis.attribution import \
        attribute_decomposition
    from dlnetbench_tpu_torch.parallel import multihost
    from dlnetbench_tpu_torch.utils.timing import fence, time_chain
    n = mesh.size
    if n < 2:
        raise ValueError(f"overlap A/B needs >= 2 devices, have {n}")
    device = mesh.device
    cfgs, programs, params, tokens = build_programs(mesh, cfg_kwargs)

    def thunk(fn):
        return lambda: fn(params, tokens)

    thunks = {name: {v: thunk(fn) for v, fn in vs.items()}
              for name, vs in programs.items()}
    for vs in thunks.values():            # warm outside timing
        for fn in vs.values():
            fn()
    fence(device)
    times = {name: {v: [] for v in vs} for name, vs in thunks.items()}
    for _ in range(rounds):
        multihost.barrier(device)
        # every (config, variant) back to back within the round: the
        # ratios and overlap fractions pair matched samples
        for name, vs in thunks.items():
            for v, fn in vs.items():
                times[name][v].append(time_chain(fn, k=reps, device=device))
    times = multihost.all_ranks(times)[0]
    walls = {name: ts["full"] for name, ts in times.items()}
    overlaps = {name: stats_mod.overlap_fraction(
        ts["full"], ts["compute"], ts["comm"])
        for name, ts in times.items()}
    cfg = cfgs["baseline"]
    metric = (f"spmd overlap A/B: tp_overlap=decomposed"
              f"(chunks={cfgs['overlapped'].tp_overlap_chunks}) + "
              f"grad_sync=bucketed vs blocking baseline, "
              f"mesh {mesh_desc(mesh)}, L={cfg.num_layers} "
              f"S={cfg.seq_len} B={cfg.batch}, "
              f"overlap_fraction=(Tc+Tm-Tboth)/min(Tc,Tm) from the "
              f"full/compute/comm decomposition")
    line = assemble_line(metric, walls, overlaps)
    cuda = device.type == "cuda"
    attr = attribute_decomposition(
        times["overlapped"]["full"], times["overlapped"]["compute"],
        times["overlapped"]["comm"], transport="nccl" if cuda else "gloo",
        on_accelerator=cuda, unit="sm")
    if attr is not None:
        line["attribution"] = attr
    return line
