"""Build (on demand) and locate the port's native C++ tier
(``dlnetbench_tpu_torch/native/``).

No cmake and no ninja: one compiler process per binary, all started at
once, as ``ops/_build.py`` builds the CUDA kernels.  Two flavours:

* ``cpu``  — ``g++`` alone.  Every fabric but NCCL's real library; the
  nccl backend runs only as its host double (``--nccl_impl host``), and
  ``--backend nccl`` otherwise exits naming the CPU-flavour build.
* ``cuda`` — ``nvcc`` compiles ``csrc/burn.cu`` for ``sm_90a``; the C++
  sources are compiled with ``-DDLNB_HAVE_CUDA`` against the toolkit's
  headers and linked with it and the static CUDA runtime.

The headers every binary shares are precompiled once a flavour (a
``g++`` PCH), and the binaries build at ``-O1``.  The ``_loop`` twins
(``DLNB_PROXY_LOOP``) are built only when asked for.

Trees land in ``build/native/<hash>/<flavour>/bin`` at the root of the
checkout (``.gitignore`` lists ``build/``); ``<hash>`` covers the sources,
the flags and the compilers.  A file lock lets parallel test workers
build once and share the result.  A failed build raises; on a machine
with a card the default flavour is ``cuda``, and a missing ``nvcc`` there
raises instead of handing back a CPU-flavour tree.

The JAX package's helper of the same name builds the root ``native/``
tree with CMake; this one keeps its ``native_bin(repo, build=...)`` call
and its build-directory ownership checks.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

NATIVE = Path(__file__).resolve().parents[1] / "native"
PROXIES = ("dp", "fsdp", "hybrid_2d", "hybrid_3d", "hybrid_3d_moe",
           "ring_attention", "ulysses")
TOOLS = ("tcp_selftest", "fault_selftest", "nccl_selftest", "nccl_probe")
TESTS = ("test_core", "test_comm")
DEFAULT_TARGETS = PROXIES + TOOLS + TESTS
LOOPS = tuple(p + "_loop" for p in PROXIES)
CXX_FLAGS = ("-std=c++17", "-O1", "-pthread", "-Wall", "-Wextra")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
CUDA_HOME = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
# the shared headers behind the precompiled header (none of them reads
# DLNB_PROXY_LOOP, so the _loop twins share it)
PCH_HEADERS = ("dlnb/args.hpp", "dlnb/energy.hpp", "dlnb/fabric.hpp",
               "dlnb/fault_session.hpp", "dlnb/harness.hpp",
               "dlnb/json.hpp", "dlnb/model_data.hpp",
               "dlnb/nccl_fabric.hpp", "dlnb/schedule.hpp",
               "dlnb/shm_backend.hpp", "dlnb/tcp_backend.hpp",
               "dlnb/timers.hpp", "dlnb/topology.hpp")


def find_nvcc() -> str | None:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return None


def _card_present() -> bool:
    try:
        import torch
        return torch.cuda.is_available()
    except ImportError:
        return False


def default_flavour() -> str:
    """``cuda`` on a machine with a card (or an ``nvcc``), else ``cpu``."""
    return "cuda" if (_card_present() or find_nvcc()) else "cpu"


def _source_of(target: str) -> tuple[Path, tuple[str, ...]]:
    if target in TESTS:
        return NATIVE / "tests" / f"{target}.cc", ()
    if target.endswith("_loop") and target[:-5] in PROXIES:
        return (NATIVE / "src" / "proxies" / f"{target[:-5]}.cc",
                ("-DDLNB_PROXY_LOOP",))
    if target in PROXIES or target in TOOLS:
        return NATIVE / "src" / "proxies" / f"{target}.cc", ()
    raise ValueError(f"unknown native target {target!r}")


def _tool_version(cmd: list[str]) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[-1] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def digest(flavour: str) -> str:
    """Hash of the sources, the flags and the compilers of a flavour."""
    h = hashlib.sha256()
    h.update(flavour.encode())
    h.update(" ".join(CXX_FLAGS + NVCC_FLAGS + PCH_HEADERS).encode())
    h.update(_tool_version(["g++", "--version"]).encode())
    if flavour == "cuda":
        h.update(_tool_version([find_nvcc() or "nvcc", "--version"]).encode())
    for p in sorted(NATIVE.rglob("*")):
        if p.is_file() and p.suffix in (".hpp", ".cc", ".cu", ".h"):
            h.update(str(p.relative_to(NATIVE)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_root(repo: Path | str | None = None,
               flavour: str | None = None) -> Path:
    repo = Path(repo) if repo else NATIVE.parents[1]
    flavour = flavour or default_flavour()
    return repo / "build" / "native" / digest(flavour) / flavour


def _claim(root: Path) -> None:
    """Create the build dir (0700) and check it is ours: a tree another
    user could write to may hold planted binaries."""
    root.mkdir(parents=True, exist_ok=True, mode=0o700)
    st = root.stat()
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        raise RuntimeError(
            f"{root} exists but is not owned by uid {os.getuid()}")
    if st.st_mode & 0o022:
        shutil.rmtree(root)
        root.mkdir(mode=0o700)
    elif st.st_mode & 0o077:
        root.chmod(0o700)


def _wait_all(procs: dict, what: str) -> None:
    failed = []
    for name, (p, log) in procs.items():
        p.wait()
        if p.returncode != 0:
            failed.append(f"--- {name} (rc={p.returncode}):\n"
                          f"{Path(log).read_text()[-4000:]}")
    if failed:
        raise RuntimeError(f"native build ({what}) failed:\n"
                           + "\n".join(failed))


def _spawn(cmd: list[str], log: Path) -> subprocess.Popen:
    f = open(log, "w")
    try:
        return subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    finally:
        f.close()


def _build(root: Path, flavour: str, targets: list[str]) -> float:
    bin_dir = root / "bin"
    bin_dir.mkdir(exist_ok=True)
    missing = [t for t in targets if not (bin_dir / t).exists()]
    if not missing:
        return 0.0
    t0 = time.perf_counter()
    inc = ["-I", str(NATIVE / "include"), "-I", str(NATIVE / "src" / "proxies"),
           "-I", str(NATIVE / "tests")]
    flags = list(CXX_FLAGS)
    link: list[str] = ["-ldl"]
    procs: dict = {}
    if flavour == "cuda":
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "native build (cuda flavour): no nvcc found (set CUDA_HOME "
                "or put nvcc on PATH) — the card needs the burn kernel")
        flags += ["-DDLNB_HAVE_CUDA", "-I", str(CUDA_HOME / "include")]
        burn_o = root / "burn.o"
        if not burn_o.exists():
            tmp = root / f"burn.{os.getpid()}.o"
            procs["burn.cu"] = (_spawn(
                [nvcc, *NVCC_FLAGS, "-c", str(NATIVE / "csrc" / "burn.cu"),
                 "-o", str(tmp)], root / "burn.log"), root / "burn.log")
        link = [str(burn_o), "-L", str(CUDA_HOME / "lib64"),
                "-lcudart_static", "-lrt", "-ldl"]
    pch_src = root / "common.hpp"
    if not (root / "common.hpp.gch").exists():
        pch_src.write_text("".join(f'#include "{h}"\n' for h in PCH_HEADERS))
        tmp = root / f"common.{os.getpid()}.gch"
        procs["pch"] = (_spawn(["g++", *flags, *inc, "-x", "c++-header",
                                str(pch_src), "-o", str(tmp)],
                               root / "pch.log"), root / "pch.log")
    _wait_all(procs, flavour)
    if "burn.cu" in procs:
        os.replace(root / f"burn.{os.getpid()}.o", root / "burn.o")
    if "pch" in procs:
        os.replace(root / f"common.{os.getpid()}.gch", root / "common.hpp.gch")
    procs = {}
    for t in missing:
        src, extra = _source_of(t)
        tmp = bin_dir / f".{t}.{os.getpid()}"
        log = root / f"{t}.log"
        procs[t] = (_spawn(["g++", *flags, *extra, "-Winvalid-pch",
                            "-include", str(pch_src), *inc, str(src),
                            "-o", str(tmp), *link, "-pthread"], log), log)
    _wait_all(procs, flavour)
    for t in missing:
        os.replace(bin_dir / f".{t}.{os.getpid()}", bin_dir / t)
    return time.perf_counter() - t0


LAST_BUILD_SECONDS = 0.0


def native_bin(repo: Path | str | None = None, build: bool = True,
               flavour: str | None = None,
               targets: tuple[str, ...] | list[str] | None = None) -> Path:
    """The ``bin/`` directory of a flavour's tree, building the missing
    ``targets`` (default: the proxies, the self-tests, the probe and the
    unit suites; add ``LOOPS`` for the ``_loop`` twins).  With
    ``build=False`` only where it would be.  ``DLNB_NATIVE_TORCH_BIN``
    names a prebuilt bin dir and wins over everything."""
    global LAST_BUILD_SECONDS
    env_bin = os.environ.get("DLNB_NATIVE_TORCH_BIN")
    if env_bin:
        return Path(env_bin)
    flavour = flavour or default_flavour()
    if flavour not in ("cpu", "cuda"):
        raise ValueError(f"unknown native flavour {flavour!r} (cpu | cuda)")
    if flavour == "cpu" and _card_present():
        raise RuntimeError(
            "native build: a card is present — build the cuda flavour; a "
            "CPU-flavour tree cannot run --backend nccl")
    root = build_root(repo, flavour)
    if not build:
        return root / "bin"
    _claim(root)
    with open(root.parent / f"{flavour}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        LAST_BUILD_SECONDS = _build(root, flavour,
                                    list(targets or DEFAULT_TARGETS))
    return root / "bin"


def nccl_library() -> str | None:
    """The ``libnccl.so.2`` torch loads, for ``$DLNB_NCCL_LIB``: the
    one under an installed ``nvidia/nccl/lib``, else the one mapped into
    this process once torch's CUDA side is up; None when neither."""
    import sys
    for base in sys.path:
        p = Path(base) / "nvidia" / "nccl" / "lib" / "libnccl.so.2"
        if p.is_file():
            return str(p)
    try:
        import torch
        if torch.cuda.is_available():
            torch.cuda.init()
            for line in Path("/proc/self/maps").read_text().splitlines():
                if "libnccl.so" in line:
                    return line.split()[-1]
    except (ImportError, OSError, RuntimeError):
        pass
    return None


def nccl_env() -> dict:
    """``os.environ`` with ``DLNB_NCCL_LIB`` set to torch's NCCL (when
    not set already and one is found)."""
    env = dict(os.environ)
    if not env.get("DLNB_NCCL_LIB"):
        lib = nccl_library()
        if lib:
            env["DLNB_NCCL_LIB"] = lib
    return env
