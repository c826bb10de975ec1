"""Color conventions.

The reference wraps RGBA in `Color<T>` (ref: include/PathTrace/util/color.h)
and radiance in `Spectrum` (ref: scene/light.h:12). This design
keeps both as plain `[..., 4]` float arrays (last axis = RGBA) so every
color operation is a vectorized lane op; these helpers name the common
conventions.
"""
from __future__ import annotations

import jax.numpy as jnp


def rgba(r, g, b, a=1.0) -> jnp.ndarray:
    return jnp.asarray([r, g, b, a], jnp.float32)


def rgb_mean(color: jnp.ndarray) -> jnp.ndarray:
    """(r+g+b)/3 — the reference's getContribution (ref: worker.cpp:12-14)."""
    return jnp.mean(color[..., :3], axis=-1)


def brightness(color: jnp.ndarray) -> jnp.ndarray:
    """max(r,g,b) (ref: post_processing.cpp:22-24)."""
    return jnp.max(color[..., :3], axis=-1)


def brightness_heuristic(color: jnp.ndarray) -> jnp.ndarray:
    """a * ((r+g+b)/3 + max(r,g,b)) / 2 — the tone mapper's pixel weight
    (ref: post_processing.cpp:27-30)."""
    return color[..., 3] * (rgb_mean(color) + brightness(color)) / 2.0
