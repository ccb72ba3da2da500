"""The accelerator a run is on, for scripts that must run on a GPU."""

from __future__ import annotations

import subprocess

__all__ = ["require_gpu", "gpu_name_and_power_limit"]


def require_gpu() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's devices.

    Raises SystemExit when JAX's default devices are not GPUs: a measurement
    or smoke run never falls back to the CPU.
    """
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:  # no backend could be initialised
        raise SystemExit(f"no GPU found: {e}") from e
    dev = devices[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX runs on {dev.platform} ({dev.device_kind}); "
            "this script needs an NVIDIA GPU"
        )
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one line each."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
