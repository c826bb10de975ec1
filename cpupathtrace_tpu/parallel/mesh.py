"""Device-mesh construction for SPMD rendering.

The reference's only parallelism is a pthread pool over a mutex-guarded tile
queue (ref: src/worker.cpp:328-414). The equivalent here is a named
`jax.sharding.Mesh` with two axes:

  * `dp` — data parallel over pixels (the tile-queue analog; tiles become
    shards of the pixel axis, one program, no queue, no mutexes)
  * `sp` — sample parallel over samples-per-pixel (the latent per-pixel
    sample loop of worker.cpp:193, made a parallel axis; film accumulation
    is a `psum` over `sp`)

Scene/BVH/material arrays are replicated (the "model" fits HBM, like the
reference's shared-memory scene); a primitive-sharded variant for giant
scenes lives in the roadmap (tensor-parallel analog).
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_render_mesh(devices=None, sample_axis: int | None = None) -> Mesh:
    """Build a (dp, sp) mesh over `devices` (default: all local devices).

    `sample_axis` fixes the size of the sample-parallel axis; default picks
    the largest power-of-two divisor <= 4 so small device counts stay
    pixel-dominant (pixel shards are the better-balanced axis).
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if sample_axis is None:
        sample_axis = 1
        for cand in (4, 2):
            if n % cand == 0 and n // cand >= cand:
                sample_axis = cand
                break
    if n % sample_axis != 0:
        raise ValueError(f"device count {n} not divisible by sample_axis {sample_axis}")
    return Mesh(devices.reshape(n // sample_axis, sample_axis), ("dp", "sp"))
