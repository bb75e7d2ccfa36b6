"""Process-level runtime set-up shared by the CLIs, ``bench.py`` and
``chip_smoke.py``: where compiled programs are cached, and how the device
is named in reports."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# fixed, inside the checkout: the cache path is part of what JAX keys on,
# so a temporary or per-process directory would never hit
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing else is configured. Otherwise the GPU caches under
    :data:`DEFAULT_CACHE_DIR`, and the CPU keeps the cache off (CPU
    executables compiled on another host type can load and run wrong).
    Call before the first compilation of the process.
    """
    import jax

    from ..ops.impls import platform

    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    if platform() != "gpu":
        return None
    DEFAULT_CACHE_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def nvidia_smi_name_power() -> str | None:
    """``name, power.limit`` of the first card as nvidia-smi reports it,
    or None where there is no nvidia-smi (it opens no JAX client)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0:
        return None
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    return lines[0] if lines else None


def device_report() -> dict:
    """The device this process runs on, as every result names it."""
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
        "card": nvidia_smi_name_power(),
    }
