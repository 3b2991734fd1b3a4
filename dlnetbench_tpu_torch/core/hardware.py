"""Hardware roofline presets for the cards the port runs on (the port's
counterpart of the JAX package's ``core/hardware.py``, with NVIDIA
Hopper presets in place of the TPU ones).

Peaks are per card, dense (no sparsity), from NVIDIA's H100 data sheet,
at the SXM part's 700 W limit; a card capped lower runs slower under
load, so every measurement names the card's power limit beside it.
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
    ),
    "h100_pcie": HardwareSpec(
        name="NVIDIA H100 PCIe",
        peak_flops={"bfloat16": 756e12, "float8": 1513e12,
                    "int8": 1513e12, "float32": 51e12},
        hbm_bandwidth=2.0e12, hbm_capacity=80 << 30,
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
