"""The card's published peaks and the roofline arithmetic.

NVIDIA's H100 SXM data sheet, at the full 700 W power limit: 3.35 TB/s
of device memory and 67 TFLOP/s of float32 outside the tensor cores.
The run prints the card's own power limit beside every share.
"""
from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def roofline_share(bytes_moved: float, flops: float, device_s: float):
    """The bound as a percentage of the device time, or None without a
    device time to divide by."""
    if device_s <= 0:
        return None
    return 100.0 * bound_s(bytes_moved, flops) / device_s


def card() -> dict:
    """nvidia-smi's name and power limit of card 0 (empty where it cannot
    be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "--id=0"], capture_output=True,
                             text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    name, _, limit = out.partition(",")
    return {"smi_name": name.strip(), "power_limit": limit.strip()}
