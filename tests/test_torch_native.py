"""The port's native C++ tier (``dlnetbench_tpu_torch/native/``) on the
CPU: its unit suites, its seven proxies on the shm fabric held against
the JAX package's binaries (timer names, comm components, schedule meta
and rank rows equal), its schedule against the port's
``core/schedule.py``, a tcp pair merged by the port's
``metrics/merge.py``, the ``_loop`` twins, crash-and-shrink on shm and
tcp, the energy channel over a fake sysfs tree, and the refusal of
``--backend pjrt``.

The port's tree is the CPU flavour of ``utils/native_build`` (``g++``
alone, built once a run under its lock); the JAX package's comes from
``tests/conftest.py``'s ``native_bin`` (CMake and Ninja).  Both read one
stats file through a temporary ``--base_path`` laid out both ways."""
from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import time
from pathlib import Path

import pytest

from dlnetbench_tpu_torch.utils import native_build

REPO = Path(__file__).resolve().parent.parent
PORT_DATA = REPO / "dlnetbench_tpu_torch" / "data"
SMALL = ("--time_scale", "0.0001", "--size_scale", "0.00001", "--runs", "2",
         "--warmup", "1", "--no_topology")


@pytest.fixture(scope="module")
def port_bin():
    return native_build.native_bin(REPO, flavour="cpu")


@pytest.fixture(scope="module")
def both_ways(tmp_path_factory):
    """A base path holding the port's stats files and architecture cards
    under both packages' data roots."""
    root = tmp_path_factory.mktemp("base")
    for pkg in ("dlnetbench_tpu", "dlnetbench_tpu_torch"):
        shutil.copytree(PORT_DATA, root / pkg / "data")
    return root


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_json(binary: Path, *args, timeout=60, env=None) -> dict:
    out = subprocess.run([str(binary), *map(str, args)], capture_output=True,
                         text=True, timeout=timeout, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def record_shape(rec: dict) -> dict:
    """What two tiers' records must share: every global field (the
    schedule meta and the comm model), each rank row's identity fields
    and timer names with their lengths, and the run counts."""
    rows = []
    for row in rec["ranks"]:
        rows.append({k: (len(v) if isinstance(v, list) else v)
                     for k, v in row.items()
                     if k not in ("hostname", "summary")})
    return {"section": rec["section"], "version": rec["version"],
            "num_runs": rec["num_runs"],
            "warmup": len(rec["warmup_times"]),
            "global": rec["global"], "mesh": rec["mesh"], "ranks": rows}


# (proxy, flags, model, world): every proxy at worlds 1, 2 and 4, and the
# MoE proxy at the JAX package's own world 8
CASES = []
for _w in (1, 2, 4):
    CASES += [
        ("dp", ("--num_buckets", 4), "gpt2_l_16_bfloat16", _w),
        ("fsdp", ("--num_units", 4, "--sharding_factor", min(_w, 2)),
         "llama3_8b_16_bfloat16", _w),
        ("hybrid_2d", ("--num_stages", _w, "--num_microbatches", 4),
         "llama3_8b_16_bfloat16", _w),
        ("hybrid_3d", ("--num_stages", max(_w // 2, 1), "--num_microbatches",
                       4, "--tp", min(_w, 2)), "llama3_8b_16_bfloat16", _w),
        ("hybrid_3d_moe", ("--num_stages", max(_w // 2, 1),
                           "--num_microbatches", 4, "--num_expert_shards",
                           min(_w, 2)), "mixtral_8x7b_16_bfloat16", _w),
        ("ring_attention", ("--sp", _w, "--max_layers", 2),
         "llama3_8b_16_bfloat16", _w),
        ("ulysses", ("--sp", _w, "--max_layers", 2), "llama3_8b_16_bfloat16",
         _w),
    ]
CASES.append(("hybrid_3d_moe", ("--num_stages", 4, "--num_microbatches", 4,
                                "--num_expert_shards", 2),
              "mixtral_8x7b_16_bfloat16", 8))


@pytest.mark.parametrize("suite", ["test_core", "test_comm"])
def test_unit_suites(port_bin, suite):
    out = subprocess.run([str(port_bin / suite)], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "tests passed" in out.stdout


@pytest.mark.parametrize("name,extra,model,world", CASES,
                         ids=[f"{c[0]}-w{c[3]}" for c in CASES])
def test_proxy_record_equals_jax(port_bin, native_bin, both_ways, name, extra,
                                 model, world):
    args = ("--model", model, "--world", world, *extra, *SMALL,
            "--base_path", both_ways)
    mine = run_json(port_bin / name, *args)
    theirs = run_json(native_bin / name, *args)
    assert mine["global"]["backend"] == "shm"
    assert record_shape(mine) == record_shape(theirs)
    from dlnetbench_tpu_torch.metrics.parser import validate_record
    validate_record(mine)


def test_schedule_matches_port_python(port_bin):
    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.core.schedule import dp_schedule
    rec = run_json(port_bin / "dp", "--model", "llama3_70b_16_bfloat16",
                   "--world", 2, "--num_buckets", 7, *SMALL,
                   "--base_path", REPO)
    sched = dp_schedule(load_model_stats("llama3_70b_16_bfloat16"), 7)
    assert rec["global"]["schedule_bucket_bytes"] == sched.bucket_bytes
    assert rec["global"]["fwd_us"] == pytest.approx(sched.fwd_us * 1e-4)


def test_reads_the_port_data_root(port_bin):
    """Found by walking up from the working directory: the port's own
    H100 stats files, not the JAX package's."""
    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.core.schedule import dp_schedule
    out = subprocess.run([str(port_bin / "dp"), "--model",
                          "gpt2_l_16_bfloat16", "--world", "1",
                          "--num_buckets", "1", *SMALL],
                         capture_output=True, text=True, timeout=60,
                         cwd=REPO / "dlnetbench_tpu_torch")
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout)
    sched = dp_schedule(load_model_stats("gpt2_l_16_bfloat16"), 1)
    assert rec["global"]["fwd_us"] == pytest.approx(sched.fwd_us * 1e-4)


def test_tcp_pair_merges(port_bin, tmp_path):
    from dlnetbench_tpu_torch.metrics.merge import merge_files
    from dlnetbench_tpu_torch.metrics.parser import records_to_dataframe, \
        validate_record
    port = _free_port()
    outs = [tmp_path / f"p{r}.jsonl" for r in range(2)]
    procs = [subprocess.Popen(
        [str(port_bin / "dp"), "--model", "gpt2_l_16_bfloat16", "--world",
         "2", "--backend", "tcp", "--rank", str(r), "--coordinator",
         f"127.0.0.1:{port}", "--num_buckets", "2", *SMALL,
         "--base_path", str(REPO), "--out", str(outs[r])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    texts = [p.communicate(timeout=60)[0] for p in procs]
    for p, txt in zip(procs, texts):
        assert p.returncode == 0, txt
    for r, path in enumerate(outs):
        rec = json.loads(path.read_text())
        assert rec["process"] == r
        assert rec["global"]["transport"] == "tcp:loopback"
    merged = merge_files(tmp_path / "merged.jsonl", outs)
    validate_record(merged)
    assert [row["rank"] for row in merged["ranks"]] == [0, 1]
    assert len(records_to_dataframe([merged])) == 2 * merged["num_runs"]


@pytest.fixture(scope="module")
def loop_bin():
    return native_build.native_bin(REPO, flavour="cpu",
                                   targets=native_build.LOOPS)


LOOP_FLAGS = {
    "dp": ("--num_buckets", 2),
    "fsdp": ("--num_units", 2, "--sharding_factor", 2),
    "hybrid_2d": ("--num_stages", 2, "--num_microbatches", 2),
    "hybrid_3d": ("--num_stages", 1, "--num_microbatches", 2, "--tp", 2),
    "hybrid_3d_moe": ("--num_stages", 1, "--num_microbatches", 2,
                      "--num_expert_shards", 2),
    "ring_attention": ("--sp", 2, "--max_layers", 1),
    "ulysses": ("--sp", 2, "--max_layers", 1),
}


@pytest.mark.parametrize("proxy", native_build.PROXIES)
def test_loop_twin_runs_until_killed(loop_bin, proxy):
    """The `_loop` congestor never ends on its own (reference
    PROXY_LOOP, dp.cpp:251-256)."""
    model = ("mixtral_8x7b_16_bfloat16" if proxy == "hybrid_3d_moe"
             else "gpt2_l_16_bfloat16" if proxy == "dp"
             else "llama3_8b_16_bfloat16")
    p = subprocess.Popen([str(loop_bin / f"{proxy}_loop"), "--model", model,
                          "--world", "2", *map(str, LOOP_FLAGS[proxy]),
                          "--time_scale", "0.0001", "--size_scale",
                          "0.00001", "--no_topology", "--base_path",
                          str(REPO)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        time.sleep(0.7)
        assert p.poll() is None, p.communicate()[1]
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait()
    assert p.stdout.read() == b""  # a loop writes no record


CRASH_PLAN = '{"events":[{"kind":"crash","ranks":[1],"iteration":3}]}'


def test_shm_crash_shrink_survivors_finish(port_bin):
    out = subprocess.run(
        [str(port_bin / "fault_selftest"), "--world", "4", "--iters", "6",
         "--fault", '{"events":[{"kind":"crash","ranks":[2],'
         '"iteration":3}]}', "--fault_policy", "shrink"],
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    rows = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    assert [r["rank"] for r in rows] == [0, 1, 3]
    for r in rows:
        assert r["checks"] == "OK" and r["iters_done"] == 6
        assert r["shrunk"] is True and r["degraded_world"] == [0, 1, 3]
        assert r["detection_us"] > 0 and r["recovery_us"] > 0


@pytest.mark.slow
def test_tcp_crash_shrink_survivors_finish(port_bin):
    """Three processes; the victim dies without its goodbye, the two
    survivors regroup and finish (a kill test, so in the slow lane as
    the JAX package's is)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [str(port_bin / "fault_selftest"), "--backend", "tcp", "--world",
         "3", "--rank", str(r), "--coordinator", f"127.0.0.1:{port}",
         "--iters", "6", "--fault", CRASH_PLAN, "--fault_policy", "shrink"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(3)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=60)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0] + "\n<TIMEOUT>")
    assert procs[1].returncode != 0
    for r in (0, 2):
        assert procs[r].returncode == 0, outs[r]
        row = json.loads([ln for ln in outs[r].splitlines()
                          if ln.startswith("{")][0])
        assert row["shrunk"] is True and row["degraded_world"] == [0, 2]
        assert row["iters_done"] == 6 and row["checks"] == "OK"


def test_dp_shm_crash_shrink_record(port_bin):
    """The dp proxy under a crash + shrink plan on shm: the survivors'
    record with degraded_world, through the port's parser."""
    from dlnetbench_tpu_torch.metrics.parser import records_to_dataframe
    rec = run_json(port_bin / "dp", "--model", "gpt2_l_16_bfloat16",
                   "--world", 4, "--num_buckets", 2, "--time_scale", "0.0001",
                   "--size_scale", "0.00001", "--runs", 4, "--warmup", 1,
                   "--no_topology", "--base_path", REPO, "--fault",
                   '{"events":[{"kind":"crash","ranks":[2],"iteration":3}]}',
                   "--fault_policy", "shrink")
    assert rec["global"]["degraded_world"] == [0, 1, 3]
    assert [r["rank"] for r in rec["ranks"]] == [0, 1, 3]
    assert rec["global"]["detection_ms"] > 0
    assert len(records_to_dataframe([rec])) == 3 * rec["num_runs"]


def test_energy_channel_over_fake_sysfs(port_bin, tmp_path):
    hw = tmp_path / "hwmon" / "hwmon0"
    hw.mkdir(parents=True)
    (hw / "power1_input").write_text("10000000\n")  # 10 W in uW
    (hw / "name").write_text("cpu_fake\n")
    env = {**os.environ, "DLNB_RAPL_ROOT": str(tmp_path / "absent"),
           "DLNB_HWMON_ROOT": str(tmp_path / "hwmon")}
    env.pop("DLNB_HWMON_DEVICE", None)
    rec = run_json(port_bin / "dp", "--model", "gpt2_l_16_bfloat16",
                   "--world", 2, "--num_buckets", 2, "--time_scale", "0.02",
                   "--size_scale", "0.00001", "--runs", 3, "--warmup", 1,
                   "--no_topology", "--base_path", REPO, env=env)
    assert rec["global"]["energy_source"] == "hwmon:cpu_fake"
    assert rec["global"]["energy_scope"] == "process"
    rows = {row["rank"]: row for row in rec["ranks"]}
    assert len(rows[0]["energy_consumed"]) == rec["num_runs"]
    assert sum(rows[0]["energy_consumed"]) > 0
    assert "energy_consumed" not in rows[1]
    from dlnetbench_tpu_torch.metrics.parser import records_to_dataframe
    assert "energy_consumed" in records_to_dataframe([rec]).columns


def test_backend_pjrt_refused_by_name(port_bin):
    out = subprocess.run([str(port_bin / "dp"), "--model",
                          "gpt2_l_16_bfloat16", "--world", "1",
                          "--num_buckets", "1", "--backend", "pjrt",
                          "--base_path", str(REPO)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert "--backend pjrt" in out.stderr
    assert "--backend nccl" in out.stderr


def test_procs_needs_the_nccl_backend(port_bin):
    out = subprocess.run([str(port_bin / "dp"), "--model",
                          "gpt2_l_16_bfloat16", "--world", "2",
                          "--num_buckets", "1", "--procs", "2",
                          "--coordinator", "127.0.0.1:1", "--base_path",
                          str(REPO)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert "--procs > 1 requires --backend nccl" in out.stderr


def test_topology_draws_cards_of_a_host(port_bin):
    out = subprocess.run([str(port_bin / "dp"), "--model",
                          "gpt2_l_16_bfloat16", "--world", "10",
                          "--num_buckets", "1", "--time_scale", "0.0001",
                          "--size_scale", "0.00001", "--runs", "1",
                          "--warmup", "1", "--base_path", str(REPO)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "fabric: 10 x shm-rank[bfloat16] (2 hosts, network-linked)" \
        in out.stderr
    assert "host host0  [NVLink domain, 8 card(s)]" in out.stderr
    assert "rank id=9  card=1" in out.stderr


def test_python_tier_loop_runs_until_killed(tmp_path):
    """The Python tier's ``--loop`` (the native `_loop` twins' mode):
    ``cli dp --loop`` in a gloo world of 2 keeps stepping until killed
    and writes no record.  The two ranks are started here with the
    launcher's environment, each in a session of its own, so the kill
    reaches them (the launcher's workers would outlive a killed
    launcher)."""
    out = tmp_path / "dp.jsonl"
    port = _free_port()
    procs = []
    for r in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO), "RANK": str(r),
               "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
               "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [os.sys.executable, "-m", "dlnetbench_tpu_torch.cli", "dp",
             "--model", "gpt2_l_16_bfloat16", "--num_buckets", "2",
             "--platform", "cpu", "--size_scale", "1e-5", "--time_scale",
             "2e-4", "-w", "1", "-r", "1", "--loop", "--no_topology",
             "--out", str(out)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            start_new_session=True, env=env, cwd=tmp_path))
    def cpu_s(pid):  # user + system seconds so far (/proc/<pid>/stat)
        fields = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
        utime, stime = fields.split()[11:13]
        return (int(utime) + int(stime)) / os.sysconf("SC_CLK_TCK")

    try:
        time.sleep(8)
        # stepping, not blocked at the rendezvous or a collective: each
        # rank's CPU time grows in every one of four 1 s windows (a blocked
        # rank's does not; how much it grows is the machine's load, not the
        # rank's)
        busy = []
        for _ in range(4):
            before = [cpu_s(p.pid) for p in procs]
            time.sleep(1)
            busy.append([cpu_s(p.pid) - b for p, b in zip(procs, before)])
        alive = [p.poll() is None for p in procs]
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        errs = [p.communicate(timeout=30)[1] for p in procs]
    assert all(alive), [e[-2000:] for e in errs]
    assert min(min(w) for w in busy) >= 0.05, busy
    assert not out.exists()
