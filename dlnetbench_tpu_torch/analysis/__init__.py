"""Analysis layer: DataFrame ingest, plotting, bandwidth, attribution,
critical path and goodput (the port's copy of the JAX package's
``analysis/``).

Counterpart of the reference's ``plots/`` package (reference
plots/parser.py, plots/plot_dp.py, plots/plots_pareto_energy.py,
plots/py_utils.py): parse proxy run records into pandas DataFrames and
render the scaling / exposed-comm / Pareto views.  Importing the package
imports neither pandas nor matplotlib: the functions that need them
import them when called.
"""
from dlnetbench_tpu_torch.metrics.parser import get_metrics_dataframe, records_to_dataframe
from dlnetbench_tpu_torch.analysis.py_utils import format_bytes, parse_bytes
from dlnetbench_tpu_torch.analysis.plots import (
    pareto_front,
    plot_attribution_stack,
    plot_barrier_scatter_by_bucket,
    plot_pareto,
    plot_runtime_scaling,
)

__all__ = [
    "get_metrics_dataframe",
    "records_to_dataframe",
    "format_bytes",
    "parse_bytes",
    "pareto_front",
    "plot_runtime_scaling",
    "plot_barrier_scatter_by_bucket",
    "plot_pareto",
    "plot_attribution_stack",
]
