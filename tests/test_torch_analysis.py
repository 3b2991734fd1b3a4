"""The port's plot utilities and plots (``dlnetbench_tpu_torch/analysis/
py_utils.py``, ``analysis/plots.py``) against the JAX package's, on the
CPU under matplotlib's Agg backend: the same byte formats and parses,
the same style assignments, the same Pareto fronts, and every plot draws
the same data (line and scatter coordinates, bar extents, tick labels)
from the same DataFrame.  Importing ``dlnetbench_tpu_torch.analysis``
with pandas and matplotlib blocked succeeds (they are imported only by
the functions that need them)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from dlnetbench_tpu.analysis import plots as J_plots  # noqa: E402
from dlnetbench_tpu.analysis import py_utils as J_utils  # noqa: E402
from dlnetbench_tpu_torch.analysis import plots as T_plots  # noqa: E402
from dlnetbench_tpu_torch.analysis import py_utils as T_utils  # noqa: E402
from dlnetbench_tpu_torch.metrics.parser import \
    get_metrics_dataframe  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n", [0, 1, 512, 1023, 1024, 1536, 10 ** 6,
                               3 * 2 ** 30 + 7, 2 ** 50, 2 ** 62, 0.5])
def test_format_bytes_equal(n):
    for precision in (0, 1, 3):
        assert T_utils.format_bytes(n, precision) == \
            J_utils.format_bytes(n, precision)


@pytest.mark.parametrize("s", ["512", "1.5 KiB", "1.5KB", "2 mib", "3GB",
                               " 7 TiB ", ".5 PiB", "1 B", "1.5 XB", "abc",
                               "", "1..5"])
def test_parse_bytes_equal(s):
    def run(fn):
        try:
            return fn(s)
        except ValueError as e:
            return str(e)
    assert run(T_utils.parse_bytes) == run(J_utils.parse_bytes)


def test_style_maps_assign_the_same_styles():
    tm, jm = T_utils.StyleMap(), J_utils.StyleMap()
    keys = ["a", 4, ("x", 1), "a", "b", 8, 4] + list(range(20))
    assert [tm[k] for k in keys] == [jm[k] for k in keys]
    assert tm.line_kwargs("a") == jm.line_kwargs("a")
    assert tm.scatter_kwargs(8) == jm.scatter_kwargs(8)


@pytest.mark.parametrize("seed", range(5))
def test_pareto_front_equal(seed):
    rng = np.random.default_rng(seed)
    pts = [tuple(p) for p in rng.integers(0, 20, (30 + seed, 2))]
    assert T_plots.pareto_front(pts) == J_plots.pareto_front(pts)
    assert T_plots.pareto_front([]) == J_plots.pareto_front([]) == []
    for v in ("1", 2.5, None, "x", [1]):
        assert T_plots.np_isnum(v) == J_plots.np_isnum(v)


def _record(model, world, buckets, runtime, barrier, sizes):
    return {
        "section": "dp", "version": 1,
        "global": {"model": model, "world_size": world,
                   "num_buckets": buckets, "bucket_bytes": sizes,
                   "attribution": {"bound": "host", "fractions": {
                       "compute": 0.5, "hbm": 0.1, "comm_exposed": 0.2,
                       "host": 0.2}},
                   "comm_model": {"barrier_time": [
                       {"kind": "allreduce", "group": world,
                        "bytes": sum(sizes)}]}},
        "mesh": {"platform": "cpu", "device_kind": "cpu"},
        "num_runs": len(runtime), "warmup_times": [],
        "ranks": [{"rank": r, "device_id": r, "process_index": 0,
                   "hostname": "h0", "runtimes": runtime,
                   "barrier_time": barrier, "energy_consumed": barrier}
                  for r in range(world)]}


@pytest.fixture(scope="module")
def run_df(tmp_path_factory):
    rng = np.random.default_rng(7)
    recs = []
    for model in ("gpt2_l", "llama3_8b"):
        for world, buckets in ((2, 4), (4, 4), (8, 8)):
            rt = list(100 + 100 * rng.random(3))
            recs.append(_record(model, world, buckets, rt,
                                list(10 + 10 * rng.random(3)),
                                [int(v) for v in
                                 rng.integers(1 << 10, 1 << 24, buckets)]))
    path = tmp_path_factory.mktemp("runs") / "runs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return get_metrics_dataframe(path, "dp"), recs


def _drawn(ax) -> dict:
    """What an Axes shows: its lines, collections, bars, ticks, labels."""
    return {
        "lines": [(ln.get_xdata().tolist(), ln.get_ydata().tolist(),
                   ln.get_color(), ln.get_marker(), ln.get_linestyle())
                  for ln in ax.get_lines()],
        "collections": [np.asarray(c.get_offsets()).round(9).tolist()
                        if len(c.get_offsets()) else
                        [p.vertices.round(9).tolist()
                         for p in c.get_paths()]
                        for c in ax.collections],
        "patches": [(round(p.get_x(), 9), round(p.get_y(), 9),
                     round(p.get_width(), 9), round(p.get_height(), 9))
                    for p in ax.patches],
        "xticks": [t.get_text() for t in ax.get_xticklabels()],
        "yticks": [t.get_text() for t in ax.get_yticklabels()],
        "labels": (ax.get_xlabel(), ax.get_ylabel()),
        "legend": ([t.get_text() for t in ax.get_legend().get_texts()]
                   if ax.get_legend() else None),
    }


def _both(call) -> tuple[dict, dict]:
    out = []
    for mod in (J_plots, T_plots):
        fig, ax = plt.subplots()
        call(mod, ax)
        fig.canvas.draw()
        out.append(_drawn(ax))
        plt.close(fig)
    return out[0], out[1]


@pytest.mark.parametrize("kw", [{}, {"agg": "min"}, {"agg": "max"},
                                {"group_by": "num_buckets"}])
def test_plot_runtime_scaling_draws_the_same(run_df, kw):
    df, _ = run_df
    j, t = _both(lambda m, ax: m.plot_runtime_scaling(df, ax=ax, **kw))
    assert t == j and j["lines"]


@pytest.mark.parametrize("kw", [{}, {"msg_col": "nothing"}])
def test_plot_barrier_scatter_draws_the_same(run_df, kw):
    df, _ = run_df
    j, t = _both(lambda m, ax: m.plot_barrier_scatter_by_bucket(
        df, ax=ax, seed=3, **kw))
    assert t == j and j["collections"]


@pytest.mark.parametrize("kw", [{}, {"y": "barrier_time"},
                                {"config_cols": ("num_buckets",)}])
def test_plot_pareto_draws_the_same(run_df, kw):
    df, _ = run_df
    j, t = _both(lambda m, ax: m.plot_pareto(df, ax=ax, **kw))
    assert t == j and j["collections"]


def test_plot_attribution_stack_draws_the_same(run_df):
    from dlnetbench_tpu.analysis.bandwidth import effective_bandwidth as J_bw
    from dlnetbench_tpu_torch.analysis.bandwidth import \
        effective_bandwidth as T_bw
    _, recs = run_df
    bw = J_bw(recs)
    assert T_bw(recs).equals(bw)
    j, t = _both(lambda m, ax: m.plot_attribution_stack(bw, ax=ax))
    assert t == j and j["patches"]


def test_plot_errors_and_zoom_inset_equal(run_df):
    df, _ = run_df
    for call in (lambda m: m.plot_runtime_scaling(df, y="nope"),
                 lambda m: m.plot_pareto(df, config_cols=("nope",)),
                 lambda m: m.plot_attribution_stack(df)):
        msgs = []
        for mod in (J_plots, T_plots):
            with pytest.raises(ValueError) as e:
                call(mod)
            msgs.append(str(e.value))
            plt.close("all")
        assert msgs[0] == msgs[1]
    insets = []
    for mod, utils in ((J_plots, J_utils), (T_plots, T_utils)):
        fig, ax = plt.subplots()
        mod.plot_runtime_scaling(df, ax=ax)
        axins = utils.add_zoom_inset(ax, (0.5, 0.5, 0.4, 0.4), (2, 4),
                                     (0, 300))
        insets.append((_drawn(axins)["lines"], axins.get_xlim(),
                       axins.get_ylim()))
        plt.close(fig)
    assert insets[0] == insets[1]


def test_analysis_imports_without_pandas_or_matplotlib():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('pandas', 'matplotlib'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import dlnetbench_tpu_torch.analysis as A\n"
        "import dlnetbench_tpu_torch.analysis.attribution\n"
        "import dlnetbench_tpu_torch.analysis.bandwidth as B\n"
        "import dlnetbench_tpu_torch.analysis.critical_path\n"
        "import dlnetbench_tpu_torch.analysis.goodput\n"
        "import dlnetbench_tpu_torch.sentinel\n"
        "import dlnetbench_tpu_torch.metrics.merge\n"
        "assert A.format_bytes(1536) == '1.5 KiB'\n"
        "assert B.bus_factor('allreduce', 4) == 1.5\n"
        "try:\n"
        "    A.records_to_dataframe([])\n"
        "except ImportError as e:\n"
        "    print('frame:', e)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('pandas', 'matplotlib', 'jax')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == ["frame: blocked: pandas", "ok"]
