"""The device a measurement runs on, named — and required to be a GPU.

Every timing this repository reports names its device.  A measurement
path that finds no GPU stops; it never falls back to the CPU.
"""
from __future__ import annotations

import subprocess

import jax


def gpu_line() -> str:
    """One line naming the GPU: JAX platform, device kind and count, and
    ``nvidia-smi``'s name and power limit.  Raises SystemExit without a
    GPU default device."""
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"no GPU: the default device is {d.platform} ({d.device_kind})"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return (f"platform={d.platform} kind={d.device_kind} count={len(devs)} "
            f"nvidia-smi={smi[0]}")
