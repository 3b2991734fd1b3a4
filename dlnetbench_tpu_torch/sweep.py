"""Configuration sweep driver (the JAX package's ``sweep.py``).

The reference studies collective tuning by sweeping NCCL's environment
knobs (protocols {Simple, LL, LL128} x algorithms {ring, tree, nvls,
collnet} x threads x channels, reference plots/plot_dp.py:23-26)
across job grids whose ``job.variables`` tag every output
(plots/parser.py:221-238).  On the card those knobs are NCCL's again,
so this driver brings the study back to the hardware it was written
for:

* an axis whose key starts with ``env:`` varies an environment variable
  (``env:NCCL_ALGO=Ring|Tree|NVLS``) — each point runs in a FRESH
  subprocess, so init-time settings take effect;
* any other axis varies a flag of ``dlnetbench_tpu_torch.cli``;
* every point is tagged onto its record via ``--tag`` (the
  ``job.variables`` role), so the JAX package's ``metrics.parser``
  surfaces the swept axes as DataFrame columns.

The world comes from the launcher, as in the ``cli``: ``--nproc N``
(default 1) runs every point as ``python -m torch.distributed.run
--nproc_per_node N --master_port <a free port> -m
dlnetbench_tpu_torch.cli ...`` in a fresh process.  At N = 1 a
flag-only grid runs IN PROCESS by default: one process group (on the
passthrough's ``--platform``) and one burn calibration serve every
point; ``--subprocess`` forces a process a point, and ``env:`` axes
force it automatically.  The sweep itself must not run under
``torchrun``: every point's ranks would rendezvous on the launcher's
store again.

CLI::

    python -m dlnetbench_tpu_torch.sweep dp --model llama3_8b_16_bfloat16 \
        --out sweep.jsonl --nproc 4 \
        --axis num_buckets=4,8 \
        --axis "env:NCCL_ALGO=Ring|Tree|NVLS" \
        -- --time_scale 0.05 -r 3 --no_topology

(arguments after ``--`` pass through to every cli invocation unchanged;
``|`` separates env-axis values, ``,`` separates flag-axis values).
"""
from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys

from dlnetbench_tpu_torch.metrics import spans

CLI_MODULE = "dlnetbench_tpu_torch.cli"
# set by torchrun in every rank it starts
_LAUNCHER_ENV = ("TORCHELASTIC_RUN_ID", "LOCAL_RANK", "GROUP_RANK")


def expand_grid(axes: dict[str, list[str]]) -> list[dict[str, str]]:
    """Cartesian product of axes -> list of {axis: value} points."""
    if not axes:
        return [{}]
    keys = list(axes)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(axes[k] for k in keys))]


def point_command(proxy: str, point: dict[str, str],
                  passthrough: list[str], nproc: int = 1
                  ) -> tuple[list[str], dict[str, str]]:
    """(argv, env-overrides) for one grid point; ``nproc`` > 1 prefixes
    ``torch.distributed.run`` on a free port."""
    if nproc > 1:
        from dlnetbench_tpu_torch.utils.net import free_port
        argv = [sys.executable, "-m", "torch.distributed.run",
                "--nproc_per_node", str(nproc),
                "--master_port", str(free_port())]
    else:
        argv = [sys.executable]
    argv += ["-m", CLI_MODULE, proxy] + passthrough
    env: dict[str, str] = {}
    # axis flags go AFTER the passthrough/fixed flags: argparse keeps the
    # last occurrence, so the swept value always wins — the record's tag
    # and the actual run can never disagree
    for key, value in point.items():
        if key.startswith("env:"):
            env[key[4:]] = value
        else:
            argv += [f"--{key}", value]
        argv += ["--tag", f"{key.removeprefix('env:')}={value}"]
    return argv, env


def _run_point_in_process(argv: list[str], stream) -> int:
    """Run one grid point by calling cli.main in THIS process (argv past
    ``-m dlnetbench_tpu_torch.cli``); returns an exit code."""
    from dlnetbench_tpu_torch import cli
    try:
        return cli.main(argv[argv.index(CLI_MODULE) + 1:]) or 0
    except SystemExit as e:  # argparse errors exit; the sweep must not
        return int(e.code or 0) if not isinstance(e.code, str) else 2
    except Exception as e:
        print(f"[sweep] in-process point raised {type(e).__name__}: "
              f"{str(e)[:200]}", file=stream)
        return 1


def _platform(passthrough: list[str]) -> str:
    """The passthrough's ``--platform`` (its last occurrence), else the
    cli's default."""
    value = "cuda"
    for i, a in enumerate(passthrough):
        if a == "--platform" and i + 1 < len(passthrough):
            value = passthrough[i + 1]
        elif a.startswith("--platform="):
            value = a.split("=", 1)[1]
    return value


def run_sweep(proxy: str, axes: dict[str, list[str]],
              passthrough: list[str], *, dry_run: bool = False,
              keep_going: bool = False, stream=None,
              in_process: bool | None = None, nproc: int = 1) -> int:
    """Run every grid point; returns the number of FAILED points.

    ``in_process=None`` (auto) shares this process across points when
    ``nproc`` is 1 and no ``env:`` axis demands a fresh process: the
    process group and the burn calibration are then made ONCE for the
    whole grid."""
    stream = stream or sys.stderr
    points = expand_grid(axes)
    has_env_axis = any(k.startswith("env:") for k in axes)
    if in_process is None:
        in_process = not has_env_axis and nproc == 1
    if in_process and has_env_axis:
        raise ValueError("env: axes need a fresh subprocess per point "
                         "(init-time settings); drop --in_process")
    if in_process and nproc > 1:
        raise ValueError("--nproc > 1 runs each point under torchrun in "
                         "a fresh process; drop --in_process")
    owned = False
    if in_process and not dry_run:
        import torch.distributed as dist

        from dlnetbench_tpu_torch.parallel import multihost
        if not dist.is_initialized():
            try:
                multihost.initialize(_platform(passthrough))
                owned = True
            except (RuntimeError, ValueError):
                pass             # each point reports it through the cli
    failed = 0
    try:
        for i, point in enumerate(points):
            argv, env_over = point_command(proxy, point, passthrough, nproc)
            desc = (", ".join(f"{k}={v}" for k, v in point.items())
                    or "(single)")
            mode = "in-process" if in_process and not dry_run else ""
            print(f"[sweep {i + 1}/{len(points)}] {desc}"
                  + (f" [{mode}]" if mode else ""), file=stream)
            if dry_run:
                import shlex
                prefix = "".join(f"{k}={shlex.quote(v)} "
                                 for k, v in env_over.items())
                print("  " + prefix + " ".join(map(shlex.quote, argv)),
                      file=stream)
                continue
            # one span per grid point: a traced sweep shows per-config
            # wall-clock (and, in-process, the nested build/warmup/timed
            # spans of each point) on one timeline
            with spans.span("sweep-point", point=desc, index=i,
                            mode="in-process" if in_process
                            else "subprocess"):
                if in_process:
                    rc = _run_point_in_process(argv, stream)
                else:
                    env = {**os.environ, **env_over}
                    rc = subprocess.run(argv, env=env).returncode
            if rc != 0:
                failed += 1
                print(f"[sweep] point failed (exit {rc}): {desc}",
                      file=stream)
                if not keep_going:
                    break
    finally:
        if owned:
            from dlnetbench_tpu_torch.parallel import multihost
            multihost.shutdown()
    return failed


def bound_tally(out_path: str, stream=None, *,
                start_offset: int = 0) -> dict[str, int]:
    """Count the attribution ``bound`` verdicts across the records a
    sweep appended to ``out_path`` and say so on ``stream``.
    ``start_offset`` is the file's byte size before the sweep ran:
    emit_result appends, so records from earlier sweeps sharing the
    same --out must not pollute this grid's tally.  Every record the
    port writes carries the block (``metrics/emit.py`` stamps it): its
    verdict is ``sm``, ``nvlink``, ``network``, ``host`` or ``faulted``;
    a record without one (its samples could not be attributed, or the
    stamp failed) tallies under ``n/a``.  Returns the tally ({} when the
    file is unreadable — a dry run, or every point failed before
    emitting)."""
    import json
    stream = stream or sys.stderr
    tally: dict[str, int] = {}
    try:
        with open(out_path) as f:
            if start_offset:
                f.seek(start_offset)
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    rec = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                attr = (rec.get("global") or {}).get("attribution") or {}
                bound = attr.get("bound") or "n/a"
                tally[bound] = tally.get(bound, 0) + 1
    except OSError:
        return {}
    if tally:
        print("[sweep] bottleneck tally: "
              + ", ".join(f"{k}={v}" for k, v in sorted(tally.items())),
              file=stream)
    return tally


def _parse_axis(spec: str) -> tuple[str, list[str]]:
    key, sep, values = spec.partition("=")
    if not sep or not key:
        raise ValueError(f"--axis wants KEY=V1,V2,... got {spec!r}")
    split_on = "|" if key.startswith("env:") else ","
    return key, values.split(split_on)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # arguments after "--" pass through to every cli invocation
    passthrough: list[str] = []
    if "--" in argv:
        cut = argv.index("--")
        argv, passthrough = argv[:cut], argv[cut + 1:]

    p = argparse.ArgumentParser(
        prog="dlnetbench_tpu_torch.sweep", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("proxy", help="cli subcommand (dp, fsdp, hybrid_3d, ...)")
    p.add_argument("--model", required=True)
    p.add_argument("--out", required=True,
                   help="JSONL file every point appends its record to")
    p.add_argument("--axis", action="append", default=[],
                   metavar="KEY=V1,V2,... | env:VAR=V1|V2",
                   help="swept axis; repeatable")
    p.add_argument("--nproc", type=int, default=1,
                   help="ranks a point (> 1: each point under "
                        "torch.distributed.run --nproc_per_node N)")
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("--keep_going", action="store_true",
                   help="continue past failed points")
    p.add_argument("--trace-out", "--trace_out", dest="trace_out",
                   default=None, metavar="PATH",
                   help="write a Chrome/Perfetto trace of the sweep: one "
                        "host span per grid point (nesting each in-process "
                        "point's build/warmup/timed spans)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--in_process", action="store_true",
                      help="force sharing this process across points "
                           "(default for flag-only grids at --nproc 1; "
                           "invalid with env: axes or --nproc > 1)")
    mode.add_argument("--subprocess", action="store_true",
                      help="force a fresh subprocess per point "
                           "(automatic for env: axes and --nproc > 1)")
    args = p.parse_args(argv)
    launched = [k for k in _LAUNCHER_ENV if k in os.environ]
    if launched:
        p.error(f"the sweep runs outside torchrun ({', '.join(launched)} "
                f"is set): start it alone and give each point its ranks "
                f"with --nproc N")
    if args.nproc < 1:
        p.error("--nproc must be >= 1")

    axes: dict[str, list[str]] = {}
    for spec in args.axis:
        try:
            key, vals = _parse_axis(spec)
        except ValueError as e:
            p.error(str(e))
        if key in axes:
            p.error(f"--axis {key!r} given twice; merge the value lists")
        axes[key] = vals
    passthrough = ["--model", args.model, "--out", args.out] + passthrough
    in_process = True if args.in_process else \
        (False if args.subprocess else None)
    try:
        out_offset = os.path.getsize(args.out)
    except OSError:
        out_offset = 0  # fresh --out file
    tracer = spans.enable() if args.trace_out else None
    try:
        failed = run_sweep(args.proxy, axes, passthrough,
                           dry_run=args.dry_run, keep_going=args.keep_going,
                           in_process=in_process, nproc=args.nproc)
    except ValueError as e:
        p.error(str(e))
    finally:
        if tracer is not None:
            spans.disable()
            try:
                spans.write_chrome_trace(args.trace_out, tracer)
                print(f"sweep trace -> {args.trace_out}", file=sys.stderr)
            except OSError as e:
                # the trace is auxiliary: a write failure must neither
                # override the sweep's outcome nor mask an in-flight
                # usage error from the except arm above
                print(f"sweep trace write failed ({e})", file=sys.stderr)
    if not args.dry_run:
        bound_tally(args.out, start_offset=out_offset)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
