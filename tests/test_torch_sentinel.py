"""The port's regression sentinel (``dlnetbench_tpu_torch/sentinel.py``)
against the JAX package's, on the CPU, and the port's ``bench --check``.

``bench_lines``, ``compare_line``, ``check``, ``check_paths``,
``scan_dir`` and the CLI get the same inputs on both sides — the root
``BENCH_r01-05.json`` captures, bench stdout JSONL and seeded synthetic
lines with and without bands and attribution blocks — and the sections,
the rendered text and the exit codes must be equal.

``bench.main(["--platform", "cpu", "--skip-aux", "--check", ...])`` at a
tiny ``DLNB_BENCH_*`` shape, its clock scripted so that a second run
measures what the first did: rc 0 against its own line, 3 against a
halved baseline, 2 against a file with no comparable headline."""
from __future__ import annotations

import contextlib
import io
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

from dlnetbench_tpu import sentinel as J
from dlnetbench_tpu_torch import sentinel as T

REPO = Path(__file__).resolve().parent.parent
BENCH = sorted(p.name for p in REPO.glob("BENCH_r0*.json"))


def _line(value, band=None, metric="m", **extra):
    d = {"metric": metric, "unit": "ms", "value": value}
    if band is not None:
        d["band"] = band
    d.update(extra)
    return d


def _headline(seed: int, scale: float = 1.0, bands: bool = True) -> dict:
    """A seeded headline with ms aux lines inside it, TPU-priced."""
    rng = np.random.default_rng(seed)
    v = float(rng.uniform(100, 600)) * scale
    band = [v * 0.99, v * 1.01] if bands else None
    line = _line(v, band, metric="llama step (tpu_v5e, x)",
                 tflops_achieved=float(rng.uniform(50, 150)) / scale,
                 vs_baseline=float(rng.uniform(0.3, 0.9)))
    for key in ("int8_step", "fp8_fused_ab", "recommended_step"):
        a = float(rng.uniform(10, 90)) * scale
        line[key] = _line(a, [a * 0.98, a * 1.02] if bands else None,
                          metric=f"{key} (tpu_v5e)", tflops_achieved=40.0,
                          vs_baseline=0.5,
                          **({"recipe": "bf16"} if key == "recommended_step"
                             else {}))
    line["not_a_line"] = {"unit": "GB/s", "value": 3.0, "metric": "x"}
    return line


# ---------------------------------------------------------- bench_lines
@pytest.mark.parametrize("name", BENCH)
def test_bench_lines_equal_on_the_captures(name):
    assert T.bench_lines(REPO / name) == J.bench_lines(REPO / name)


def test_bench_lines_equal_on_jsonl_and_single_objects(tmp_path):
    cases = {
        "stdout.jsonl": "\n".join([json.dumps(_line(1.0)),
                                   "not json", json.dumps(_headline(1)),
                                   '{"trunc']),
        "single.json": json.dumps(_headline(2)),
        "empty.jsonl": "\n",
        "no_ms.jsonl": json.dumps({"unit": "x", "value": 1}),
        "capture.json": json.dumps({"rc": 1, "tail": "boom\n"
                                    + json.dumps(_headline(3)),
                                    "parsed": None}),
    }
    for name, text in cases.items():
        (tmp_path / name).write_text(text)
        assert T.bench_lines(tmp_path / name) == \
            J.bench_lines(tmp_path / name), name
    assert T.is_ms_line(_line(1.0)) and not T.is_ms_line({"unit": "ms"})


# ------------------------------------------------------------- compare
COMPARE = [  # (baseline, current, threshold)
    (_line(100.0, [99.0, 101.0]), _line(110.0, [109.0, 111.0]), 5.0),
    (_line(100.0, [95.0, 115.0]), _line(110.0, [105.0, 112.0]), 5.0),
    (_line(100.0), _line(104.0), 5.0),
    (_line(100.0), _line(104.0), 2.0),
    (_line(100.0, [99.0, 101.0]), _line(80.0, [79.0, 81.0]), 5.0),
    (_line(0.0), _line(1.0), 5.0),
    (_line(10.0, recipe="bf16"), _line(20.0, recipe="int8"), 5.0),
    ({"unit": "GB/s", "value": 1.0, "metric": "m"}, _line(1.0), 5.0),
    (_headline(0)["int8_step"], _headline(0, 1.3)["int8_step"], 5.0),
]


@pytest.mark.parametrize("idx", range(len(COMPARE)))
def test_compare_line_equal(idx):
    base, cur, thr = COMPARE[idx]
    assert T.compare_line("x", base, cur, thr) == \
        J.compare_line("x", base, cur, thr)


@pytest.mark.parametrize("seed", range(4))
def test_check_equal_on_seeded_headlines(seed):
    for scale in (0.5, 1.0, 1.02, 1.3):
        for bands in (True, False):
            base = {"headline": _headline(seed, bands=bands)}
            cur_line = _headline(seed, scale, bands=bands)
            cur = {"headline": cur_line,
                   **{k: v for k, v in cur_line.items() if T.is_ms_line(v)}}
            base.update({k: v for k, v in base["headline"].items()
                         if T.is_ms_line(v)})
            base["vanished"] = _line(1.0)
            for thr in (5.0, 20.0):
                assert T.check(base, cur, thr, "b") == \
                    J.check(base, cur, thr, "b")
    assert T.check({}, {"headline": _line(1.0)}) == \
        J.check({}, {"headline": _line(1.0)})


def test_check_paths_equal_over_every_capture_pair():
    for a, b in itertools.permutations(BENCH, 2):
        assert T.check_paths(REPO / a, REPO / b) == \
            J.check_paths(REPO / a, REPO / b)


# ------------------------------------------------------------ scan, CLI
def _run(mod, fn, *args) -> tuple[int, str]:
    buf = io.StringIO()
    rc = getattr(mod, fn)(*args, out=buf)
    return rc, buf.getvalue()


def test_scan_dir_equal_over_the_repos_captures(tmp_path):
    assert _run(T, "scan_dir", REPO) == _run(J, "scan_dir", REPO)
    for thr in (0.1, 50.0):
        assert _run(T, "scan_dir", REPO, "BENCH_r*.json", thr) == \
            _run(J, "scan_dir", REPO, "BENCH_r*.json", thr)
    # a regressing latest, a dead latest, too few captures
    for i, (v, dead) in enumerate([(100.0, False), (150.0, False),
                                   (0.0, True)]):
        body = {"rc": 1, "tail": ""} if dead else {
            "parsed": _line(v, [v - 1, v + 1]), "tail": ""}
        (tmp_path / f"BENCH_r{i:02d}.json").write_text(json.dumps(body))
        got, want = (_run(T, "scan_dir", tmp_path),
                     _run(J, "scan_dir", tmp_path))
        assert got == want
    assert got[0] == 2
    (tmp_path / "BENCH_r02.json").unlink()
    assert _run(T, "scan_dir", tmp_path)[0] == 3
    assert _run(T, "scan_dir", tmp_path / "nowhere") == \
        _run(J, "scan_dir", tmp_path / "nowhere")


@pytest.mark.parametrize("argv", [
    [str(REPO)], [str(REPO), "--threshold", "0.01"],
    [str(REPO / "BENCH_r05.json"), "--baseline",
     str(REPO / "BENCH_r03.json")],
    [str(REPO / "BENCH_r03.json"), "--baseline",
     str(REPO / "BENCH_r05.json"), "--threshold", "0.001"],
    [str(REPO / "BENCH_r05.json"), "--baseline",
     str(REPO / "BENCH_r04.json")]])
def test_main_equal(argv, capsys):
    got = []
    for mod in (J, T):
        rc = mod.main(list(argv))
        cap = capsys.readouterr()
        got.append((rc, cap.out, cap.err))
    assert got[1] == got[0]
    assert T.RC_REGRESSION == J.RC_REGRESSION == 3


# ---------------------------------------------------------- bench --check
TINY = {"SEQ": 128, "LAYERS": 2, "VOCAB": 256, "EMBED": 256, "FF": 512,
        "HEADS": 2, "KV_HEADS": 1}


@pytest.fixture
def tiny_bench(monkeypatch):
    """The port's bench at a tiny shape on scripted clocks: every timed
    round takes 50 ms, so each run measures what the last one did."""
    from dlnetbench_tpu_torch import bench
    from dlnetbench_tpu_torch.models import bench_step
    from dlnetbench_tpu_torch.utils import timing
    for k, v in TINY.items():
        monkeypatch.setattr(bench_step, k, v)
    monkeypatch.setenv("DLNB_BENCH_K", "2")

    def scripted(fn, reps, device=None):
        fn()
        return [0.05] * reps
    monkeypatch.setattr(timing, "time_callable", scripted)

    def run(*argv) -> tuple[int, dict, str]:
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main(["--platform", "cpu", "--skip-aux", *argv])
        return rc, json.loads(out.getvalue().strip().splitlines()[-1]), \
            err.getvalue()
    return run


def test_bench_check_against_its_own_line_a_halved_one_and_none(
        tiny_bench, tmp_path):
    rc, line, _ = tiny_bench()
    assert rc == 0 and "sentinel" not in line
    assert "attribution" not in line          # no preset prices the CPU
    own = tmp_path / "own.jsonl"
    own.write_text(json.dumps(line) + "\n")
    rc, checked, _ = tiny_bench("--check", str(own))
    assert rc == 0
    assert checked["sentinel"]["verdict"] == "clean"
    assert checked["sentinel"] == J.check(
        J.bench_lines(own), {"headline": checked, **{
            k: v for k, v in checked.items() if J.is_ms_line(v)}},
        5.0, str(own))
    halved = tmp_path / "halved.jsonl"
    halved.write_text(json.dumps({**line, "value": line["value"] / 2,
                                  "band": [v / 2 for v in line["band"]]})
                      + "\n")
    rc, checked, err = tiny_bench("--check", str(halved),
                                  "--check-threshold", "10")
    assert rc == 3
    assert checked["sentinel"]["regressions"] == ["headline"]
    assert checked["sentinel"]["threshold_pct"] == 10.0
    assert "sentinel: REGRESSION" in err
    headless = tmp_path / "headless.jsonl"
    headless.write_text(json.dumps({"unit": "GB/s", "value": 1}) + "\n")
    rc, checked, err = tiny_bench("--check", str(headless))
    assert rc == 2 and checked["sentinel"]["verdict"] == "no-baseline"
    assert "sentinel cannot arm" in err
    rc, checked, err = tiny_bench("--check", str(tmp_path / "missing"))
    assert rc == 2 and "cannot read baseline" in err
