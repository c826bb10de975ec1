"""Process set-up shared by the entry scripts (`chip_smoke.py`, `bench.py`,
`demo.py`): where JAX keeps its persistent compilation cache, and which
card the numbers were taken on."""
from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

#: `<checkout>/.jax_cache`. The path is part of the cache key, so it is
#: fixed: a directory that moved between runs would never hit.
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory and
    return it. Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it
    itself and nothing is set here; otherwise the cache goes to
    `<checkout>/.jax_cache`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)


def card_info() -> str:
    """The first card's name and power limit as `nvidia-smi` reports them
    (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"). Read by a child process that
    does not touch JAX; raises if `nvidia-smi` is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
