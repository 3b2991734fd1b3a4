"""The bench's resilience-slice lines against the JAX bench's, on the
CPU: the three 8-bit lines' assemblers (``fp8_mlp``, ``fp8_swiglu``,
``int8_matmul``) on the same scripted timings, the ``checkpoint_ab``
and ``straggler_ab`` line schemas (the JAX package's
tests/test_bench_aux.py), ``--fault``'s refusal of crash events with
the JAX bench's message and its delays inside the timed window, and
``--trace-out``'s merged trace at ``--platform cpu``."""
from __future__ import annotations

import contextlib
import io
import json
import types

import pytest
import torch

from dlnetbench_tpu_torch import bench as T_bench
from dlnetbench_tpu_torch.models import bench_step as T_bs

SUMMARY = {"value": 0.0031, "best": 0.003, "band": [0.003, 0.0034], "n": 3}
SWIGLU_STAGES = [{"value": 0.002, "best": 0.0019, "band": [0.0019, 0.0022],
                  "n": 3},
                 {"value": 0.0011, "best": 0.001, "band": [0.001, 0.0012],
                  "n": 3}]
CARD = types.SimpleNamespace(embed_dim=128, ff_dim=256)


@pytest.fixture
def scripted_lines(monkeypatch):
    """Both benches at B=2 S=64 with their chain measurement scripted:
    the same seconds-an-iteration summaries reach both assemblers."""
    import bench as J_bench
    for mod in (J_bench, T_bs):
        monkeypatch.setattr(mod, "BATCH", 2)
        monkeypatch.setattr(mod, "SEQ", 64)
    seq = {}

    def scripted(key):
        def measure(*a, **k):
            n = seq.get(key, 0)
            seq[key] = n + 1
            return dict((SWIGLU_STAGES * 4)[n] if key.endswith("swiglu")
                        else SUMMARY)
        return measure

    return J_bench, seq, scripted


def _gpu_words(block: dict) -> dict:
    """JAX's attribution block in the port's words for a card's
    preset: its compute is ``sm`` where JAX says ``mxu`` (a known
    difference since the record pipeline's port)."""
    out = json.loads(json.dumps(block).replace('"mxu"', '"sm"'))
    return out


LINES = {"fp8_mlp": ("_bench_fp8_mlp", "bench_fp8_mlp"),
         "fp8_swiglu": ("_bench_fp8_swiglu_chain", "bench_fp8_swiglu"),
         "int8_matmul": ("_bench_int8_matmul", "bench_int8_matmul")}


@pytest.mark.parametrize("hw_key", ["tpu_v5e", "b200"])
@pytest.mark.parametrize("name", sorted(LINES))
def test_eight_bit_lines_equal_jax_on_the_same_timings(scripted_lines,
                                                       monkeypatch, name,
                                                       hw_key, capsys):
    """Same keys and values (value, band, vs_baseline against the
    preset's own 8-bit peak, the achieved rate, the low-mode flag, the
    attribution block) — or the same skip when the preset lacks the
    peak (b200 has no int8 peak)."""
    J_bench, seq, scripted = scripted_lines
    jname, tname = LINES[name]
    seq.clear()
    monkeypatch.setattr(J_bench, "_measure_chain",
                        scripted("j" + ("swiglu" if "swiglu" in name
                                        else "")))
    monkeypatch.setattr(T_bench, "chain_summary",
                        scripted("t" + ("swiglu" if "swiglu" in name
                                        else "")))
    want = getattr(J_bench, jname)(CARD, hw_key,
                                   types.SimpleNamespace(device_kind="cpu"))
    jout = capsys.readouterr().out
    got = getattr(T_bench, tname)(CARD, hw_key, "cpu", torch.device("cpu"))
    tout = capsys.readouterr().out
    if want is None:
        assert got is None
        assert json.loads(tout) == json.loads(jout)     # the skip marker
        return
    assert set(got) == set(want)
    if hw_key == "b200":
        want["attribution"] = _gpu_words(want["attribution"])
    for k in want:
        if k == "metric" and name == "fp8_swiglu":
            continue        # JAX's names its compile pathology
        assert got[k] == want[k], k
    assert json.loads(tout) == got


def test_eight_bit_lines_run_on_the_cpu(monkeypatch, capsys):
    """Each line runs its real chain at a tiny shape (no preset on the
    CPU: vs_baseline null, no attribution)."""
    monkeypatch.setattr(T_bs, "BATCH", 2)
    monkeypatch.setattr(T_bs, "SEQ", 32)
    for fn in (T_bench.bench_fp8_mlp, T_bench.bench_fp8_swiglu,
               T_bench.bench_int8_matmul):
        line = fn(CARD, None, "cpu", torch.device("cpu"))
        assert line["value"] > 0 and line["vs_baseline"] is None
        assert "attribution" not in line
        assert line["metric"].endswith("cpu (no preset)")
    capsys.readouterr()


def test_int8_chain_product_is_exact():
    """The int8 chain's CPU product is the exact int32 sum, as
    ``torch._int_mm`` gives it on the card."""
    from dlnetbench_tpu_torch.ops import int8
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (32, 512), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (512, 64), generator=g, dtype=torch.int8)
    got = int8.int32_product(a, w.t().contiguous().t())
    want = a.to(torch.int64) @ w.to(torch.int64)
    assert got.dtype == torch.int32 and torch.equal(got.long(), want)


# ------------------------------------------------------ the fault lines
class FakeBundle:
    full = staticmethod(lambda: None)
    state = {"w": torch.ones(64)}


def test_checkpoint_ab_line_schema_locked(monkeypatch, tmp_path, capsys):
    """The JAX bench's schema (tests/test_bench_aux.py): the fraction
    moved off the timed path, the three step bands, the measured save
    cost, state size and backend — over a stub step and a real
    checkpointer on a tiny state."""
    from dlnetbench_tpu_torch.utils import timing
    monkeypatch.setattr("dlnetbench_tpu_torch.proxies.dp.build",
                        lambda *a, **k: FakeBundle())
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)

    def fake_time_chain(fn, k, device=None):
        import time as _t
        t0 = _t.monotonic()
        for _ in range(k):
            fn()
        return 0.001 + (_t.monotonic() - t0) / k

    monkeypatch.setattr(timing, "time_chain", fake_time_chain)
    line = T_bench.bench_checkpoint_ab("cpu")
    assert line["metric"].startswith("checkpoint A/B")
    assert line["unit"].startswith("fraction of save cost")
    for key in ("baseline_ms", "stall_ms", "async_ms", "save_ms"):
        sub = line[key]
        assert set(sub) == {"value", "best", "band", "n"}
        assert sub["band"][0] <= sub["value"] <= sub["band"][1]
    assert line["stall_ms"]["value"] >= line["async_ms"]["value"]
    assert line["save_ms"]["n"] == 12  # 3 rounds x k=4, every=1
    assert line["state_bytes"] == 64 * 4
    assert line["backend"] == "dcp"
    assert line["n"] == 3
    assert not list(tmp_path.glob("dlnb_ckpt_ab_*"))
    assert json.loads(capsys.readouterr().out) == line


def test_straggler_ab_skips_on_one_rank_with_jax_note(capsys):
    """A bench process alone is one rank: the JAX bench's note for one
    device, and no line."""
    assert T_bench.bench_straggler_ab("cpu") is None
    marker = json.loads(capsys.readouterr().out)
    assert marker == {"metric": "straggler A/B",
                      "skipped": "needs >= 2 devices, have 1 — no "
                                 "collective for a straggler to gate"}


def test_spmd_overlap_ab_skips_on_one_rank_with_jax_note(capsys):
    """A bench process alone is one rank: the JAX bench's note for one
    device (``bench.py``'s ``_bench_overlap_ab``), and no line."""
    assert T_bench.bench_overlap_ab("cpu") is None
    marker = json.loads(capsys.readouterr().out)
    assert marker == {"metric": "spmd overlap A/B",
                      "skipped": "needs >= 2 devices, have 1 — "
                                 "single-chip session has no "
                                 "communication to overlap"}


def test_straggler_ab_line_schema_locked(monkeypatch, capsys):
    """With >= 2 ranks (a world mocked here; rank 1 is the straggler):
    the JAX bench's schema — the amplification, both step bands, the
    injected delay."""
    import itertools

    from dlnetbench_tpu_torch.parallel import multihost
    from dlnetbench_tpu_torch.utils import timing
    monkeypatch.setattr("dlnetbench_tpu_torch.proxies.dp.build",
                        lambda *a, **k: FakeBundle())
    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    monkeypatch.setattr(multihost, "rank", lambda: 1)
    slept = []
    monkeypatch.setattr("time.sleep", lambda s: slept.append(s))
    monkeypatch.setattr("dlnetbench_tpu_torch.faults.inject.wait",
                        lambda s: slept.append(s))
    seq = itertools.cycle([0.001])

    def fake_time_chain(fn, k, device=None):
        base = next(seq)
        before = sum(slept)
        for _ in range(k):
            fn()
        return base + (sum(slept) - before) / k

    monkeypatch.setattr(timing, "time_chain", fake_time_chain)
    line = T_bench.bench_straggler_ab("cpu")
    assert line["metric"].startswith("straggler A/B")
    assert line["unit"].startswith("x (")
    assert line["injected_ms"] >= 2.0
    for key in ("clean_ms", "faulted_ms"):
        sub = line[key]
        assert set(sub) == {"value", "best", "band", "n"}
        assert sub["band"][0] <= sub["value"] <= sub["band"][1]
    assert line["faulted_ms"]["value"] > line["clean_ms"]["value"]
    assert line["value"] == pytest.approx(1.0)
    assert line["n"] == 3 and line["world"] == 2
    assert line["attribution"]["bound"] == "faulted"
    capsys.readouterr()


# ------------------------------------------------ --fault, --trace-out
TINY = {"SEQ": 128, "LAYERS": 2, "VOCAB": 256, "EMBED": 256, "FF": 512,
        "HEADS": 2, "KV_HEADS": 1}


@pytest.fixture
def tiny(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setattr(T_bs, k, v)
    monkeypatch.setenv("DLNB_BENCH_K", "2")

    def run(*argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = T_bench.main(["--platform", "cpu", "--skip-aux", *argv])
        return rc, out.getvalue(), err.getvalue()
    return run


def test_bench_fault_refuses_crash_with_jax_message(tiny, monkeypatch,
                                                    capsys):
    import bench as J_bench
    plan = json.dumps({"events": [{"kind": "crash", "iteration": 2},
                                  {"kind": "delay", "magnitude_us": 5.0},
                                  {"kind": "partition", "group": [1]}]})
    rc, out, err = tiny("--fault", plan)
    assert rc == 2 and out == ""
    monkeypatch.setattr(J_bench, "_tpu_up_or_skip", lambda: True)
    jrc = J_bench._run_bench(J_bench._parse_args(["--fault", plan]), None)
    jerr = capsys.readouterr().err.strip().splitlines()[-1]
    assert jrc == 2 and err.strip() == jerr


def test_bench_fault_delays_ride_the_timed_window(tiny, monkeypatch):
    """A delay plan's sleeps land inside each timed call (k steps'
    worth), never in the warm call; the headline stamps the plan and
    the verdict."""
    from dlnetbench_tpu_torch.utils import timing
    slept = []
    monkeypatch.setattr("time.sleep", lambda s: slept.append(s))
    monkeypatch.setattr("dlnetbench_tpu_torch.faults.inject.wait",
                        lambda s: slept.append(s))

    def scripted(fn, reps, device=None):
        for _ in range(reps):
            fn()
        return [0.05] * reps
    monkeypatch.setattr(timing, "time_callable", scripted)
    plan = {"events": [{"kind": "delay", "magnitude_us": 3000.0}]}
    rc, out, _ = tiny("--fault", json.dumps(plan))
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["fault_plan"] == {"policy": "fail_fast", "events": [
        {"kind": "delay", "iteration": 0, "magnitude_us": 3000.0}]}
    # 3 timed calls x k=2 steps, none in the warm call
    assert slept == pytest.approx([0.003] * 6)


def test_bench_trace_out_writes_a_merged_trace(tiny, tmp_path):
    """``--trace-out`` at ``--platform cpu``: the host spans (build,
    timed, the profiled call), the profiled call's device track and a
    trace ``trace_summary`` reads; the headline is unaffected."""
    from dlnetbench_tpu_torch import trace_summary
    from dlnetbench_tpu_torch.metrics import spans
    path = tmp_path / "bench.json"
    rc, out, err = tiny("--trace-out", str(path))
    assert rc == 0 and "merged host+device trace" in err
    assert not spans.is_enabled()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["value"] > 0
    trace = json.loads(path.read_text())
    evs = trace["traceEvents"]
    host = {e["name"] for e in evs if e.get("pid") == spans.HOST_PID
            and e.get("ph") == "X"}
    assert {"build", "timed", "profile"} <= host
    device = [e for e in evs if e.get("ph") == "X"
              and e.get("pid") != spans.HOST_PID]
    assert device and all(e["args"].get("device_op") for e in device)
    rows = trace_summary.summarize_trace(trace)
    assert [r["rank"] for r in rows] == ["rank 0 (cpu)"]
    assert rows[0]["kinds"]["other"]["count"] == len(device)
