"""The torch package stands alone: importing it (every submodule) loads
no ``jax`` and no module of the JAX package, and no file of it — nor
``chip_smoke.py`` — imports either; the CUDA sources include no JAX or
XLA header.  The import check runs in a subprocess because
tests/conftest.py imports jax into this one."""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "dlnetbench_tpu_torch"

_BAD_INCLUDE = re.compile(r"^\s*#\s*include\s*[<\"][^>\"]*(jax|xla)",
                          re.MULTILINE | re.IGNORECASE)
_BAD_IMPORT = re.compile(
    r"^\s*(import\s+(jax|dlnetbench_tpu)\b(?!_torch)"
    r"|from\s+(jax|dlnetbench_tpu)(\.|\s)(?!_torch))", re.MULTILINE)


def _modules() -> list[str]:
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_submodule_loads_no_jax():
    mods = _modules()
    for m in ("serving.scheduler", "ops.flash_attention", "bench", "entry",
              "models.bench_step", "core.roofline", "core.hardware",
              "utils.timing", "ops.int8", "ops.fp8", "ops.mlp_backward",
              "ops.quantized_matmul", "ops.grouped_matmul", "models.moe",
              "stats_gen", "core.model_stats", "core.schedule",
              "core.executor", "parallel.multihost", "parallel.mesh",
              "parallel.collectives", "parallel.buffers", "proxies.base",
              "proxies.burn", "proxies.dp", "proxies.fsdp",
              "metrics.energy", "utils.net", "metrics.spans",
              "metrics.profiling", "metrics.telemetry", "utils.topology",
              "sweep", "trace_summary", "metrics.parser", "metrics.merge",
              "analysis", "analysis.attribution", "analysis.bandwidth",
              "analysis.critical_path", "analysis.goodput", "analysis.plots",
              "analysis.py_utils", "faults.plan", "faults.inject",
              "faults.policy", "utils.checkpoint", "utils.watchdog",
              "sentinel",
              "serving.sampling", "serving.device_state",
              "serving.speculative", "serving.decode",
              "serving.kv_cache", "serving.metrics",
              "serving.moe_decode", "serving.requeue",
              "serving.disagg", "serving.router", "serving.fleet",
              "ops.page_migration", "scale_probe", "cli", "tuning",
              "tuning.db",
              "tuning.search", "tuning.params", "tuning.__main__",
              "models.vit", "hf_import"):
        assert f"dlnetbench_tpu_torch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith('jax.')\n"
            "             or m == 'dlnetbench_tpu'\n"
            "             or m.startswith('dlnetbench_tpu.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(REPO),
                               "HOME": str(Path.home())})
    assert proc.returncode == 0, proc.stderr[-3000:]


CARD_TESTS = sorted(REPO.glob("tests/test_torch_card*.py"))


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PKG.rglob("*.py"),
                                       REPO / "chip_smoke.py",
                                       *CARD_TESTS]))
def test_no_port_file_imports_jax_or_the_jax_package(path):
    src = (REPO / path).read_text()
    assert not _BAD_IMPORT.search(src), path


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in PKG.rglob("csrc/*.cu*")))
def test_no_kernel_source_includes_jax_or_xla(path):
    src = (REPO / path).read_text()
    assert not _BAD_INCLUDE.search(src), path
    assert not _BAD_IMPORT.search(src), path


def test_the_guard_covers_every_card_test_file():
    names = {p.name for p in CARD_TESTS}
    assert {f"test_torch_card_{m}.py" for m in (
        "flash_attention", "splash_attention", "paged_attention",
        "mlp_backward", "quantized_mlp", "grouped_matmul",
        "proxies", "observability", "decode_loop",
        "serving_breadth", "breadth")} <= names


def test_card_tests_collect_without_jax():
    """The card files run on a machine without jax, as chip_smoke.py
    runs them: ``pytest --noconftest -m cuda``.  Here jax and the JAX
    package are made unimportable first; every card case must still be
    collected (they skip at run time, in their fixture)."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'dlnetbench_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import pytest\n"
            "sys.exit(pytest.main(['--noconftest', '-m', 'cuda', '-q',\n"
            "                      '--collect-only', '-p', 'no:cacheprovider',\n"
            f"                      *{[str(p) for p in CARD_TESTS]!r}]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(REPO),
                               "HOME": str(Path.home())})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    n = int(proc.stdout.strip().splitlines()[-1].split()[0].split("/")[0])
    # the 59 cases moved out of the jax-importing files, and 19 more for
    # the wgmma K11 / K12 tiles, clusters and schedule
    assert n >= 78, proc.stdout[-2000:]


def test_the_guard_covers_every_kernel_source():
    srcs = {p.name for p in PKG.rglob("csrc/*.cu*")}
    assert {"paged_attention.cu", "flash_attention.cu",
            "mlp_matmul.cu"} <= srcs


def test_the_guard_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp",
                 "from jax import lax", "from dlnetbench_tpu.ops import x",
                 "    import dlnetbench_tpu", "from dlnetbench_tpu import y"):
        assert _BAD_IMPORT.search(line), line
    for line in ("import dlnetbench_tpu_torch",
                 "from dlnetbench_tpu_torch.ops import common",
                 "import jaxlib_like_name_is_not_jax_x"):
        assert not _BAD_IMPORT.search(line), line
    assert _BAD_INCLUDE.search('#include "xla/ffi/api/ffi.h"')
    assert not _BAD_INCLUDE.search("#include <cuda_bf16.h>")
