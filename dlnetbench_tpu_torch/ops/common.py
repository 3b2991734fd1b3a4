"""The device split every kernel wrapper in ``ops/`` makes, and the
block-size helper the kernels share (counterpart of the JAX package's
``ops/pallas_common.py``).

* ``on_card(t)`` — True for a CUDA tensor (the wrapper launches its
  hand-written kernel or raises), False for a CPU tensor (the wrapper
  runs the kernel's plain PyTorch version).  Any other device raises:
  there is no silent third path.
* ``resolve_device(platform)`` — the entry points' device policy:
  ``cuda`` unless the caller asks for ``cpu``, and a missing card is an
  error, never a quiet fall back to the CPU.
* ``fit_block`` — the largest power-of-two halving of a block that
  divides a dimension.
"""
from __future__ import annotations

import torch

PLATFORMS = ("cpu", "cuda")

# At and beyond this size a sub-warp block is a configuration bug, not
# a fall back (the JAX package's LONG_DIM rule, with a warp for a lane)
LONG_DIM = 64 * 1024
WARP = 32


def on_card(t: torch.Tensor) -> bool:
    """Which side of the device split ``t`` lies on."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device} (cpu or cuda)")


def resolve_device(platform: str = "cuda") -> torch.device:
    """``cuda`` (the default) or ``cpu``; raises when ``cuda`` is asked
    for and no card is visible."""
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got "
                         f"{platform!r}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "platform 'cuda' asked for but torch.cuda.is_available() is "
            "False — pass platform='cpu' (CLI: --platform cpu) to run "
            "the plain versions on the CPU")
    return torch.device(platform)


def fit_block(dim: int, block: int) -> int:
    """Largest power-of-two halving of ``block`` that divides ``dim``;
    refuses a long dim (>= 64k) whose only fitting blocks are narrower
    than a warp."""
    if dim <= 0:
        raise ValueError(f"fit_block: non-positive dim {dim}")
    while dim % block:
        block //= 2
    if dim >= LONG_DIM and block < WARP:
        raise ValueError(
            f"fit_block: dim {dim} >= {LONG_DIM} admits no block >= "
            f"{WARP} (best fit {block}); pad the dim to a multiple of "
            f"{WARP}")
    return block
