"""The torch package stands alone: importing it (every submodule) loads
no ``jax`` and no module of the JAX package, and no file of it — nor
``chip_smoke.py`` — imports either; the CUDA sources include no JAX or
XLA header; the port's native C++ tier includes nothing from the root
``native/`` tree, and neither it nor any Python file of the port names
the JAX package's ``dlnetbench_tpu/`` directory (its data root above
all).  The import check runs in a subprocess because
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
              "models.vit", "hf_import", "examples",
              "examples.dp_bucket_study", "examples.pod_study",
              "examples.congestion_study", "utils.native_build",
              "utils.congest"):
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


NATIVE = PKG / "native"
NATIVE_SRC = sorted(p for p in NATIVE.rglob("*")
                    if p.suffix in (".hpp", ".cc", ".cu", ".h"))
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
_JAX_DIR = re.compile(r"dlnetbench_tpu/")


@pytest.mark.parametrize("path", [str(p.relative_to(REPO))
                                  for p in NATIVE_SRC])
def test_native_includes_stay_in_the_port(path):
    """Every quoted include resolves inside the port's native tree (its
    own include/, src/proxies/, tests/ or the file's directory)."""
    src = (REPO / path).read_text()
    here = (REPO / path).parent
    roots = [NATIVE / "include", NATIVE / "src" / "proxies",
             NATIVE / "tests", here]
    for inc in _INCLUDE.findall(src):
        hits = [r / inc for r in roots if (r / inc).is_file()]
        assert hits, f"{path}: #include \"{inc}\" is not in the port"
        for h in hits:
            assert NATIVE in h.resolve().parents, (path, inc)
    assert not _BAD_INCLUDE.search(src), path


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*NATIVE_SRC, *PKG.rglob("*.py")]))
def test_no_port_file_names_the_jax_package_dir(path):
    assert not _JAX_DIR.search((REPO / path).read_text()), path


def test_the_native_guard_covers_the_tier():
    names = {p.name for p in NATIVE_SRC}
    assert {"nccl_fabric.hpp", "nccl_api.hpp", "proxy_runner.hpp",
            "burn.cu", "nccl_selftest.cc", "dp.cc"} <= names
    assert not (NATIVE / "include" / "dlnb" / "pjrt_fabric.hpp").exists()
    assert _INCLUDE.findall('#include "dlnb/x.hpp"\n') == ["dlnb/x.hpp"]
    assert _JAX_DIR.search('"/dlnetbench_tpu/data"')
    assert not _JAX_DIR.search('"/dlnetbench_tpu_torch/data"')


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
