"""Hardware roofline presets (the port's counterpart of the JAX package's
``core/hardware.py``): NVIDIA Hopper presets for the cards the port runs
on, beside a copy of the JAX package's TPU presets as data, so that the
port's record pipeline prices a JAX record or a JAX bench line exactly
as the JAX package does.

Peaks are per card or chip, dense (no sparsity), from the vendors' data
sheets; the H100 figures at the SXM part's 700 W limit.  A card capped
lower runs slower under load, so every measurement names the card's
power limit beside it.

Link conventions: ``ici_bandwidth`` is one TPU ICI link's one-way rate
(the JAX package's field); ``nvlink_bandwidth`` is a card's aggregate
NVLink rate in ONE direction — NVIDIA quotes NVLink 4 on the H100 SXM as
900 GB/s total, both directions summed, so the preset holds 450e9.  The
H100 PCIe preset assumes no NVLink bridge (0).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    # peak FLOP/s by dtype key ("bfloat16", "float8", "int8", "float32")
    peak_flops: dict
    hbm_bandwidth: float        # bytes/s
    hbm_capacity: int           # bytes
    # one-way ICI link bandwidth per chip (bytes/s); 0 for non-TPU devices
    ici_bandwidth: float = 0.0
    num_ici_links: int = 0
    # aggregate NVLink bandwidth per card, one direction (bytes/s); 0
    # where no NVLink is assumed
    nvlink_bandwidth: float = 0.0
    # the verdict word for compute-bound time on this part: a TPU's
    # matrix unit or a card's streaming multiprocessors
    compute_unit: str = "sm"

    def peak(self, dtype: str) -> float:
        try:
            return self.peak_flops[dtype]
        except KeyError:
            raise ValueError(
                f"{self.name} has no peak for dtype {dtype!r}; "
                f"available: {sorted(self.peak_flops)}") from None


HARDWARE: dict[str, HardwareSpec] = {
    "h100_sxm": HardwareSpec(
        name="NVIDIA H100 SXM",
        peak_flops={"bfloat16": 989e12, "float8": 1979e12,
                    "int8": 1979e12, "float32": 67e12},
        hbm_bandwidth=3.35e12, hbm_capacity=80 << 30,
        nvlink_bandwidth=450e9,
    ),
    "h100_pcie": HardwareSpec(
        name="NVIDIA H100 PCIe",
        peak_flops={"bfloat16": 756e12, "float8": 1513e12,
                    "int8": 1513e12, "float32": 51e12},
        hbm_bandwidth=2.0e12, hbm_capacity=80 << 30,
        nvlink_bandwidth=0.0,
    ),
    # The JAX package's presets, as data (per chip; v5e = v5 lite).
    "tpu_v4": HardwareSpec(
        name="TPU v4",
        peak_flops={"bfloat16": 275e12, "int8": 275e12},
        hbm_bandwidth=1228e9, hbm_capacity=32 << 30,
        ici_bandwidth=50e9, num_ici_links=6, compute_unit="mxu",
    ),
    "tpu_v5e": HardwareSpec(
        name="TPU v5e",
        peak_flops={"bfloat16": 197e12, "int8": 394e12, "float8": 394e12},
        hbm_bandwidth=819e9, hbm_capacity=16 << 30,
        ici_bandwidth=50e9, num_ici_links=4, compute_unit="mxu",
    ),
    "tpu_v5p": HardwareSpec(
        name="TPU v5p",
        peak_flops={"bfloat16": 459e12, "int8": 918e12, "float8": 918e12},
        hbm_bandwidth=2765e9, hbm_capacity=95 << 30,
        ici_bandwidth=100e9, num_ici_links=6, compute_unit="mxu",
    ),
    "tpu_v6e": HardwareSpec(
        name="TPU v6e",
        peak_flops={"bfloat16": 918e12, "int8": 1836e12, "float8": 1836e12},
        hbm_bandwidth=1640e9, hbm_capacity=32 << 30,
        ici_bandwidth=90e9, num_ici_links=4, compute_unit="mxu",
    ),
    # the JAX package's cross-check preset of the source paper's modeled
    # card (bf16 2.25 PF, fp8 4.5 PF, nvfp4 9 PF, 8 TB/s HBM)
    "b200": HardwareSpec(
        name="NVIDIA B200-192GB (Single)",
        peak_flops={"bfloat16": 2.25e15, "float8": 4.5e15, "nvfp4": 9.0e15},
        hbm_bandwidth=8.0e12, hbm_capacity=192 << 30,
    ),
}

DEFAULT_DEVICE = "h100_sxm"

BYTES_PER_ELEMENT = {"bfloat16": 2.0, "float8": 1.0, "float32": 4.0,
                     "int8": 1.0, "nvfp4": 0.5}


def hw_key_for_device_name(name: str | None) -> str | None:
    """``HARDWARE`` key for a ``torch.cuda.get_device_name()`` string
    ("NVIDIA H100 80GB HBM3" -> ``h100_sxm``, "NVIDIA H100 PCIe" ->
    ``h100_pcie``); None for anything else, the CPU included, so a CPU
    run is never priced against a card's preset."""
    if not name:
        return None
    n = str(name).lower()
    if "h100" not in n:
        return None
    return "h100_pcie" if "pcie" in n else "h100_sxm"


def hw_key_for_device_kind(kind: str | None) -> str | None:
    """``HARDWARE`` key for a JAX ``device_kind`` string ("TPU v5 lite"
    -> ``tpu_v5e``, "TPU v5p" -> ``tpu_v5p``); None for non-TPU kinds,
    as in the JAX package."""
    if not kind:
        return None
    k = str(kind).lower().replace(" ", "").replace("lite", "e")
    if "tpu" not in k:
        return None
    return next((key for key in HARDWARE
                 if key.startswith("tpu") and key.replace("tpu_", "") in k),
                None)


def hw_key_for_device(kind: str | None) -> str | None:
    """The preset of a record's ``mesh.device_kind``, whichever package
    wrote it: a TPU kind or a card's name; None for a CPU."""
    return hw_key_for_device_kind(kind) or hw_key_for_device_name(kind)
