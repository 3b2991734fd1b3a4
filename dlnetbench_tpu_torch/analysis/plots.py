"""Plot functions over proxy-run DataFrames.

Counterparts of the reference's analysis plots:
  * ``plot_runtime_scaling``        — runtime vs world size, one line per
    model/config (reference plots/plot_dp.py:29-77);
  * ``plot_barrier_scatter_by_bucket`` — exposed-comm ("barrier") time
    scatter grouped by bucket count, x-labels annotated with per-bucket
    message sizes (reference plots/plot_dp.py:80-145);
  * ``pareto_front`` / ``plot_pareto`` — min-min Pareto frontier of two
    cost metrics (reference plots/plots_pareto_energy.py:63-75, 82-234).
    The reference's second axis is NVML-sampled energy; on TPU no
    public per-chip energy counter exists, so the default second axis is
    exposed-comm time — any numeric column pair works (an ``energy``
    column is used automatically when present).

All functions take the DataFrame produced by
``analysis.get_metrics_dataframe`` (one row per rank x run) and return the
matplotlib Axes, so they compose into figures and are testable headless.
"""
from __future__ import annotations

from dlnetbench_tpu_torch.analysis.py_utils import StyleMap, format_bytes


def headless_pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib
    is not installed (the card machine has none): a study then still
    prints its tables and writes its CSVs, and names each PNG it
    skipped."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _require_cols(df, cols):
    missing = [c for c in cols if c not in df.columns]
    if missing:
        raise ValueError(f"DataFrame lacks columns {missing}; have "
                         f"{sorted(df.columns)}")


def _get_ax(ax):
    if ax is None:
        import matplotlib.pyplot as plt
        _, ax = plt.subplots(figsize=(7, 4.5))
    return ax


def plot_runtime_scaling(df, *, group_by="model", x="world_size",
                         y="runtime", agg="mean", ax=None, styles=None):
    """Runtime-vs-scale lines, one per ``group_by`` value.

    Aggregates ``y`` over ranks and runs per (group, x) point, with a shaded
    min-max band showing run variance.
    """
    _require_cols(df, [group_by, x, y])
    ax = _get_ax(ax)
    styles = styles or StyleMap()
    aggs = list(dict.fromkeys([agg, "min", "max"]))  # dedupe for agg=min/max
    for key, sub in sorted(df.groupby(group_by), key=lambda kv: str(kv[0])):
        stats = sub.groupby(x)[y].agg(aggs).reset_index()
        kw = styles.line_kwargs(key)
        ax.plot(stats[x], stats[agg], label=str(key), **kw)
        ax.fill_between(stats[x], stats["min"], stats["max"],
                        color=kw["color"], alpha=0.15, lw=0)
    ax.set_xlabel(x.replace("_", " "))
    ax.set_ylabel(f"{y} ({agg}, us)")
    ax.set_xscale("log", base=2)
    xs = sorted(df[x].unique())
    ax.set_xticks(xs, [str(int(v)) for v in xs])
    ax.legend(fontsize=8)
    ax.grid(True, alpha=0.3)
    return ax


def plot_barrier_scatter_by_bucket(df, *, y="barrier_time",
                                   bucket_col="num_buckets",
                                   msg_col="bucket_bytes", ax=None,
                                   styles=None, jitter=0.12, seed=0):
    """Exposed-comm time scatter per bucket count; x tick labels carry the
    per-bucket message size so comm cost reads against wire bytes
    (reference plots/plot_dp.py:80-145)."""
    _require_cols(df, [y, bucket_col])
    import numpy as np

    ax = _get_ax(ax)
    styles = styles or StyleMap()
    rng = np.random.default_rng(seed)
    buckets = sorted(df[bucket_col].unique())
    labels = []
    for pos, b in enumerate(buckets):
        sub = df[df[bucket_col] == b]
        xs = pos + rng.uniform(-jitter, jitter, len(sub))
        ax.scatter(xs, sub[y], s=14, alpha=0.7,
                   **styles.scatter_kwargs(b))
        label = f"{int(b)}"
        if msg_col in sub.columns and len(sub):
            # aggregate across every row in this column — models/configs
            # sharing a bucket count may have very different wire sizes
            per_row = []
            for sizes in sub[msg_col]:
                if isinstance(sizes, (list, tuple)) and sizes:
                    per_row.append(max(sizes))
                elif np_isnum(sizes):
                    per_row.append(float(sizes))
            if per_row:
                lo, hi = min(per_row), max(per_row)
                label += (f"\n{format_bytes(hi)}/bkt" if lo == hi else
                          f"\n{format_bytes(lo)}-{format_bytes(hi)}/bkt")
        labels.append(label)
        med = sub[y].median()
        ax.hlines(med, pos - 0.3, pos + 0.3,
                  color=styles[b]["color"], lw=2)
    ax.set_xticks(range(len(buckets)), labels, fontsize=8)
    ax.set_xlabel("num buckets (max bucket size)")
    ax.set_ylabel(f"{y} (us)")
    ax.grid(True, axis="y", alpha=0.3)
    return ax


def plot_attribution_stack(df, *, group_by=("section", "model"), ax=None):
    """Stacked horizontal bars of the mean attribution fractions
    (``attr_compute``/``attr_hbm``/``attr_comm``/``attr_host`` — the
    columns ``analysis.bandwidth.effective_bandwidth`` carries per row)
    per group: one glance says which runs are MXU-bound vs comm-exposed
    vs host-dominated.  Groups whose records carry no attribution block
    (all-NaN fractions) are dropped."""
    frac_cols = ["attr_compute", "attr_hbm", "attr_comm", "attr_host"]
    group_by = list(group_by)
    _require_cols(df, group_by + frac_cols)
    sub = df.dropna(subset=frac_cols, how="all")
    means = sub.groupby(group_by)[frac_cols].mean().dropna(how="all")
    if means.empty:
        raise ValueError("no rows carry attribution fractions")
    ax = _get_ax(ax)
    labels = [" / ".join(str(v) for v in (k if isinstance(k, tuple)
                                          else (k,)))
              for k in means.index]
    left = [0.0] * len(means)
    colors = {"attr_compute": "tab:blue", "attr_hbm": "tab:orange",
              "attr_comm": "tab:red", "attr_host": "tab:gray"}
    for col in frac_cols:
        vals = means[col].fillna(0.0).tolist()
        ax.barh(labels, vals, left=left, label=col.removeprefix("attr_"),
                color=colors[col])
        left = [sum(p) for p in zip(left, vals)]
    ax.set_xlabel("fraction of wall-clock (attribution)")
    ax.set_xlim(0, 1.05)
    ax.legend(fontsize=8, loc="lower right")
    ax.grid(True, axis="x", alpha=0.3)
    return ax


def np_isnum(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def pareto_front(points):
    """Min-min Pareto frontier of (x, y) pairs: the subset not dominated by
    any other point (reference plots/plots_pareto_energy.py:63-75, via the
    ``paretoset`` package there; direct sort-scan here).

    Returns frontier points sorted by x ascending.
    """
    pts = sorted(set((float(x), float(y)) for x, y in points))
    front = []
    best_y = float("inf")
    for x, y in pts:
        if y < best_y:
            front.append((x, y))
            best_y = y
    return front


def plot_pareto(df, *, x="runtime", y=None, group_by="model",
                config_cols=(), agg="mean", ax=None, styles=None):
    """Scatter of per-configuration aggregate costs + staircase Pareto
    frontier per ``group_by`` value.

    Each configuration (unique combination of ``config_cols``, e.g. the
    reference's NCCL protocol/algorithm/channel sweep axes,
    plots/plot_dp.py:23-26) becomes one point: (agg x, agg y).  ``y``
    defaults to an ``energy`` column when present (reference's
    runtime-energy Pareto) and ``barrier_time`` otherwise.
    """
    if y is None:
        y = next((c for c in ("energy", "energy_consumed")
                  if c in df.columns), "barrier_time")
    _require_cols(df, [x, y, group_by, *config_cols])
    ax = _get_ax(ax)
    styles = styles or StyleMap()
    config_cols = list(config_cols)
    for key, sub in sorted(df.groupby(group_by), key=lambda kv: str(kv[0])):
        if config_cols:
            pts_df = sub.groupby(config_cols)[[x, y]].agg(agg).reset_index()
        else:
            pts_df = sub.groupby("run")[[x, y]].agg(agg).reset_index()
        kw = styles.scatter_kwargs(key)
        ax.scatter(pts_df[x], pts_df[y], s=18, alpha=0.6, label=str(key),
                   **kw)
        front = pareto_front(zip(pts_df[x], pts_df[y]))
        if front:
            fx, fy = zip(*front)
            ax.step(fx, fy, where="post", color=kw["color"], lw=1.8)
    ax.set_xlabel(f"{x} ({agg}, us)")
    ax.set_ylabel(f"{y} ({agg})")
    ax.legend(fontsize=8)
    ax.grid(True, alpha=0.3)
    return ax
