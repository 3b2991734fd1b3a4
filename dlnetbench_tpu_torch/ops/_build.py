"""Builds the hand-written Hopper kernels under ``ops/csrc/`` at first
use and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers as
``void*``, sizes as ``int``, the CUDA stream last, a ``cudaError_t``
returned as ``int``) and compiles on its own, with no PyTorch header, to
``lib<name>.so``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xptxas -v -shared -Xcompiler -fPIC -o lib<name>.so <name>.cu

All sources are compiled at once, one ``nvcc`` process each.  The
libraries land in ``build/cuda_kernels/<hash>/`` at the root of the
checkout (``.gitignore`` lists ``build/``), where ``<hash>`` covers the
sources and the flags, so an edited kernel is rebuilt and an unchanged
one is reused.  A missing ``nvcc`` or a failed compile raises: there is
no fall back to the plain versions on a card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "cuda_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


@dataclasses.dataclass
class Build:
    """The loaded kernel libraries (``name -> CDLL``), the wall seconds
    the build took (0.0 when every library was already built), and each
    compile's ``nvcc``/``ptxas`` output (registers, shared memory and
    spills per kernel)."""
    libs: dict
    seconds: float
    log: dict


_lock = threading.Lock()
_build: Build | None = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on ``PATH``, then the
    toolkit's usual place; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the "
        "Hopper kernels cannot be built, and a CUDA tensor has no other "
        "path")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no kernel sources under {CSRC}")
    return srcs


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):    # sources and headers
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Build:
    """Compile (when needed) and load every kernel library; cached for
    the life of the process."""
    global _build
    with _lock:
        if _build is not None:
            return _build
        srcs = _sources()
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        todo = [s for s in srcs
                if not (out_dir / f"lib{s.stem}.so").is_file()]
        t0 = time.perf_counter()
        log: dict = {}
        if todo:
            nvcc = find_nvcc()
            procs = {}
            for s in todo:
                tmp = out_dir / f"lib{s.stem}.so.{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
                procs[s] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for s, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                log[s.stem] = out
                if proc.returncode != 0:
                    failed.append(f"{s.name} (rc {proc.returncode}):\n{out}")
                else:
                    # atomic publish: a concurrent build sees either
                    # no library or a whole one
                    os.replace(tmp, out_dir / f"lib{s.stem}.so")
            if failed:
                raise RuntimeError("kernel build failed: "
                                   + "\n".join(failed))
        seconds = time.perf_counter() - t0 if todo else 0.0
        libs = {s.stem: ctypes.CDLL(str(out_dir / f"lib{s.stem}.so"))
                for s in srcs}
        _build = Build(libs=libs, seconds=seconds, log=log)
        return _build


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so`` (building every kernel first if
    needed)."""
    libs = build().libs
    if name not in libs:
        raise RuntimeError(f"no kernel source csrc/{name}.cu")
    return libs[name]
