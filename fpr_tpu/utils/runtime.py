"""Process-level setup shared by the entry points (cli, bench.py,
chip_smoke.py): the persistent compilation cache, the GPU guard of the
measurement paths, and the card line every recorded number carries."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# fixed path: the directory is part of the cache key, so it must not move
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Keep JAX's persistent compilation cache where JAX_COMPILATION_CACHE_DIR
    says (JAX reads the variable itself, so nothing is set), else in
    ``<repo>/.jax_cache``.  Returns the directory in use."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def require_gpu():
    """The devices, if JAX's default backend is a GPU; SystemExit otherwise
    (a measurement that finds no card must not fall back to the CPU)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {devices[0].platform!r} "
            f"({devices[0].device_kind})"
        )
    return devices


def card_line() -> str:
    """``name, power.limit`` of every card as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())
