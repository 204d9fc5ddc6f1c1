"""The accelerator a measurement ran on.

Every number this repository reports on the GPU is printed beside the
card's name and power limit, because a card set below its maximum power
runs slower under load.
"""

from __future__ import annotations

import subprocess

import jax

# Published HBM bandwidth (bytes/s) by jax device_kind.  Source: NVIDIA
# H100 Tensor Core GPU data sheet, SXM5 part (80 GB HBM3, 3.35 TB/s).
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_hbm_bytes_per_s(device) -> float:
    """Published HBM bandwidth of `device`; a card not in the table is an
    error, not a default."""
    bw = PEAK_HBM_BYTES_PER_S.get(device.device_kind)
    if bw is None:
        raise SystemExit(f"no HBM bandwidth known for device_kind "
                         f"{device.device_kind!r}; add it to "
                         f"PEAK_HBM_BYTES_PER_S with its source")
    return bw


def require_gpu():
    """jax.devices() when JAX's default backend is a GPU; otherwise exit
    with an error (there is no CPU fallback for a measurement)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default devices are "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    return devs


def card() -> str:
    """Name and power limit of each card, as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip()
