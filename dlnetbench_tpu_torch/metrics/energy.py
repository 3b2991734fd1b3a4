"""Energy sampling (the JAX package's ``metrics/energy.py``, with the
card's own counter first).

``run_proxy`` brackets each fenced chain of the full step with
``read_joules()`` and emits the per-iteration deltas as
``energy_consumed`` (the reference's per-rank arrays,
plots/parser.py:172); the record's ``energy_source`` names the sensor.
Best available source wins:

  * NvmlSampler   — the card's cumulative energy counter,
                    ``nvmlDeviceGetTotalEnergyConsumption`` (mJ), read
                    through ``ctypes`` from NVIDIA's
                    ``libnvidia-ml.so.1``, for the rank's own card
                    (``energy_source: "nvml"``);
  * RaplSampler   — Linux RAPL cumulative counters (host package);
  * HwmonSampler  — /sys/class/hwmon power (uW) integrated by a 5 ms
                    background thread (the reference's sampling rate);
  * none          — ``energy_consumed`` is absent from the record.

On a card only NVML is tried: the host's RAPL or hwmon joules are not
the card's, so a card whose counter cannot be read gives no
``energy_consumed`` rather than the host's.
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading
import time

POWER_SAMPLING_RATE_MS = 5   # reference dp.cpp:67
NVML_LIB = "libnvidia-ml.so.1"
NVML_CLOCK_SM = 1            # nvmlClockType_t


def load_nvml():
    """NVIDIA's NVML library with the signatures used here declared;
    raises OSError where it is absent."""
    lib = ctypes.CDLL(NVML_LIB)
    handle_p = ctypes.POINTER(ctypes.c_void_p)
    for name, args in (
            ("nvmlInit_v2", []),
            ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, handle_p]),
            ("nvmlDeviceGetHandleByUUID", [ctypes.c_char_p, handle_p]),
            ("nvmlDeviceGetTotalEnergyConsumption",
             [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]),
            ("nvmlDeviceGetClockInfo",
             [ctypes.c_void_p, ctypes.c_uint, ctypes.POINTER(ctypes.c_uint)]),
            ("nvmlDeviceGetPowerUsage",
             [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


class NvmlSampler:
    """Cumulative joules of one card from NVML.

    ``cuda_index`` is torch's index of the card; NVML numbers every card
    on the machine, so the index is mapped through
    ``CUDA_VISIBLE_DEVICES`` (integers, or ``GPU-`` UUIDs looked up by
    UUID).  ``lib`` is the loaded library (``ctypes.CDLL``); a test
    passes a stub."""

    source = "nvml"

    def __init__(self, cuda_index: int = 0, lib=None, environ=None):
        self.available = False
        self.nvml_index = None
        try:
            self._lib = lib if lib is not None else load_nvml()
        except OSError:
            return
        if self._lib.nvmlInit_v2() != 0:
            return
        self._handle = ctypes.c_void_p()
        visible = (os.environ if environ is None else environ).get(
            "CUDA_VISIBLE_DEVICES")
        entries = [v.strip() for v in visible.split(",")] \
            if visible else None
        if entries and cuda_index < len(entries) \
                and not entries[cuda_index].isdigit():
            rc = self._lib.nvmlDeviceGetHandleByUUID(
                entries[cuda_index].encode(), ctypes.byref(self._handle))
        else:
            index = int(entries[cuda_index]) if entries and \
                cuda_index < len(entries) else cuda_index
            self.nvml_index = index
            rc = self._lib.nvmlDeviceGetHandleByIndex_v2(
                ctypes.c_uint(index), ctypes.byref(self._handle))
        if rc != 0:
            return
        try:
            self._read_mj()
        except RuntimeError:
            return
        self.available = True

    def _read_mj(self) -> int:
        mj = ctypes.c_ulonglong()
        rc = self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(mj))
        if rc != 0:
            raise RuntimeError(
                f"nvmlDeviceGetTotalEnergyConsumption returned {rc}")
        return mj.value

    def read_joules(self) -> float:
        """The card's energy counter (mJ since NVML's module loaded), in
        J."""
        return self._read_mj() / 1e3

    def read_state(self) -> dict:
        """The card's SM clock (MHz) and power draw (W) now; a value NVML
        cannot read is None."""
        clock, mw = ctypes.c_uint(), ctypes.c_uint()
        ok_clock = self._lib.nvmlDeviceGetClockInfo(
            self._handle, ctypes.c_uint(NVML_CLOCK_SM),
            ctypes.byref(clock)) == 0
        ok_power = self._lib.nvmlDeviceGetPowerUsage(
            self._handle, ctypes.byref(mw)) == 0
        return {"sm_clock_mhz": clock.value if ok_clock else None,
                "power_w": mw.value / 1e3 if ok_power else None}


class RaplSampler:
    """Cumulative joules from Linux RAPL package domains."""

    def __init__(self, root: str = "/sys/class/powercap"):
        packages, psys = [], []
        for path in sorted(glob.glob(f"{root}/intel-rapl:*")):
            # top-level zones only: subzones (intel-rapl:0:0) are already
            # included in their parent's counter
            if path.rsplit("/", 1)[-1].count(":") != 1:
                continue
            try:
                with open(f"{path}/energy_uj") as f:
                    float(f.read())
                try:
                    with open(f"{path}/name") as f:
                        zone = f.read().strip()
                except OSError:
                    zone = "package-?"
                try:
                    with open(f"{path}/max_energy_range_uj") as f:
                        rng = float(f.read())
                except OSError:
                    rng = 0.0   # unknown range: drop wrapped samples
                entry = (f"{path}/energy_uj", rng)
                # psys already contains the packages — never sum both
                (psys if zone == "psys" else packages).append(entry)
            except (OSError, ValueError):
                continue
        self._domains = psys if psys else packages
        self._last: list[float] = []
        self._acc = 0.0
        if self._domains:
            self._last = [self._read_raw(i)
                          for i in range(len(self._domains))]

    @property
    def available(self) -> bool:
        return bool(self._domains)

    def _read_raw(self, i: int) -> float:
        with open(self._domains[i][0]) as f:
            return float(f.read())

    def read_joules(self) -> float:
        """Monotonic cumulative joules across packages (wraparound-safe)."""
        for i, (_, rng) in enumerate(self._domains):
            cur = self._read_raw(i)
            delta = cur - self._last[i]
            if delta < 0:  # counter wrapped; drop the sample if the
                delta = delta + rng if rng > 0 else 0.0  # range is unknown
            self._acc += delta
            self._last[i] = cur
        return self._acc / 1e6


class HwmonSampler:
    """Integrate instantaneous /sys/class/hwmon power (uW) in a background
    thread at the reference's 5 ms sampling period."""

    def __init__(self, root: str = "/sys/class/hwmon"):
        # channels from ONE hwmon device only — summing across devices
        # double-counts when aggregate (battery/ACPI) and component (CPU
        # package) sensors coexist.  DLNB_HWMON_DEVICE selects by name.
        import os
        want = os.environ.get("DLNB_HWMON_DEVICE", "")
        by_dev: dict[str, list[str]] = {}
        names: dict[str, str] = {}
        for path in sorted(glob.glob(f"{root}/hwmon*/power*_input")):
            dev = path.rsplit("/", 2)[-2]
            try:
                with open(path) as f:
                    float(f.read())
                by_dev.setdefault(dev, []).append(path)
                try:
                    with open(f"{root}/{dev}/name") as f:
                        names[dev] = f.read().strip()
                except OSError:
                    names[dev] = dev
            except (OSError, ValueError):
                continue
        if want:
            # explicit selection: no match means unavailable, never a
            # silent fallback to some other sensor
            chosen = next((d for d, n in names.items() if want in n), None)
            if chosen is None and by_dev:
                import sys
                print(f"[energy] DLNB_HWMON_DEVICE={want!r} matches none of "
                      f"{sorted(names.values())}; hwmon sampling disabled",
                      file=sys.stderr)
        else:
            # unconfigured: prefer CPU-package-like sensors — the
            # alphabetically-first device could be a battery, NVMe or
            # wifi sensor, silently attributing energy to the wrong part
            preferred = ("cpu", "package", "core", "soc", "rapl")
            chosen = next((d for d in sorted(by_dev)
                           if any(p in names[d].lower() for p in preferred)),
                          next(iter(sorted(by_dev)), None))
        self._inputs = by_dev.get(chosen, []) if chosen else []
        # surfaced in the emitted record (energy_source) so a
        # misattributed sensor is visible, not silent
        self.source = f"hwmon:{names[chosen]}" if self._inputs else ""
        self._joules = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def available(self) -> bool:
        return bool(self._inputs)

    def _ensure_running(self):
        """Lazy-start (or restart after close) the integration thread —
        the 5 ms poller only spins while a measurement is in progress."""
        if self._inputs and (self._thread is None
                             or not self._thread.is_alive()):
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def _loop(self):
        prev = time.monotonic()
        while not self._stop.is_set():
            time.sleep(POWER_SAMPLING_RATE_MS / 1e3)
            now = time.monotonic()
            watts = 0.0
            for path in self._inputs:
                try:
                    with open(path) as f:
                        watts += float(f.read()) / 1e6
                except (OSError, ValueError):
                    continue
            with self._lock:
                self._joules += watts * (now - prev)
            prev = now

    def read_joules(self) -> float:
        self._ensure_running()
        with self._lock:
            return self._joules

    def close(self):
        """Stop the integration thread; a later read_joules restarts it.
        Joins before returning so a read that follows immediately sees a
        dead thread and restarts cleanly (otherwise it could observe the
        stopping-but-alive thread, skip the restart, and integrate
        nothing for the whole next measured phase)."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=1.0)


_CACHED: dict = {}


def detect_sampler(device=None):
    """Best available energy source for ``device`` (a torch device), or
    None; cached per process and device.  On ``cuda`` the card's NVML
    counter or None, never the host's sensors."""
    cuda_index = (device.index or 0) if device is not None \
        and getattr(device, "type", None) == "cuda" else None
    if cuda_index not in _CACHED:
        _CACHED[cuda_index] = (_nvml(cuda_index) if cuda_index is not None
                               else _host_sampler())
    return _CACHED[cuda_index]


def _nvml(cuda_index: int):
    nvml = NvmlSampler(cuda_index)
    return nvml if nvml.available else None


def _host_sampler():
    rapl = RaplSampler()
    if rapl.available:
        rapl.source = "rapl"
        return rapl
    hw = HwmonSampler()
    if hw.available:
        # never leave the poller spinning past process end
        import atexit
        atexit.register(hw.close)
        return hw
    return None


def close_sampler(sampler) -> None:
    """Release a sampler's background resources after a measured phase
    (restartable)."""
    close = getattr(sampler, "close", None)
    if close is not None:
        close()
