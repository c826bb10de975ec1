"""Ray batches as SoA pytrees.

The reference's `Ray` is a single origin/direction pair (ref:
include/PathTrace/base.h:16-22). Here a ray is a *lane*: batches of origins
and directions with a common leading shape, so every downstream op is a
vectorized array op.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Rays(NamedTuple):
    """A batch of rays. `origin` and `direction` share leading shape [...]."""

    origin: jnp.ndarray  # [..., 3] float32
    direction: jnp.ndarray  # [..., 3] float32, unit length

    @property
    def batch_shape(self):
        return self.origin.shape[:-1]

    def at(self, t: jnp.ndarray) -> jnp.ndarray:
        """Point along each ray: origin + direction * t."""
        return self.origin + self.direction * t[..., None]
