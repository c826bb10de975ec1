"""Sharded differentiable-rendering training step.

The full SPMD "training step" for inverse rendering: forward wavefront render
sharded over the (dp, sp) mesh, loss against a target image, reverse-mode
gradients w.r.t. the replicated material table (the `psum` over shards is
inserted by shard_map's transpose of the replicated-parameter broadcast —
the SPMD analog of a gradient all-reduce), then an SGD/Adam update.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..camera.camera import Camera
from ..core.config import RenderOptions
from ..integrator.film import pixel_camera_coords
from ..scene.scene import SceneData
from ..diff.render import apply_material_params
from .render import render_chunk_sharded


def sharded_image_loss(
    params: dict,
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    mesh,
    target: jnp.ndarray,  # [P, 4]
    x_cam: jnp.ndarray,
    y_cam: jnp.ndarray,
    key,
    spp: int,
):
    s = apply_material_params(scene, params)
    sums, counts = render_chunk_sharded(
        s, camera, options, mesh, x_cam, y_cam, key, spp, differentiable=True
    )
    img = sums / jnp.maximum(counts, 1)[:, None]
    diff = img[:, :3] - target[:, :3]
    return jnp.mean(diff * diff)


@partial(jax.jit, static_argnames=("options", "mesh", "spp", "lr"))
def train_step_sharded(
    params: dict,
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    mesh,
    target: jnp.ndarray,
    x_cam: jnp.ndarray,
    y_cam: jnp.ndarray,
    key,
    spp: int,
    lr: float = 0.05,
):
    """One SGD step of sharded inverse rendering; returns (params, loss)."""
    loss, grads = jax.value_and_grad(sharded_image_loss)(
        params, scene, camera, options, mesh, target, x_cam, y_cam, key, spp
    )
    params = {
        k: jnp.maximum(v - lr * grads[k], 0.0) for k, v in params.items()
    }
    return params, loss


def pixel_grid(options: RenderOptions, dp: int):
    """Host helper: flat pixel sensor coords padded to the dp axis."""
    import numpy as np

    w, h = options.image_width, options.image_height
    xg, yg = np.meshgrid(
        np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)
    )
    x, y = pixel_camera_coords(options, xg.ravel(), yg.ravel())
    pad = (-x.size) % dp
    if pad:
        x = np.concatenate([x, np.zeros(pad, np.float32)])
        y = np.concatenate([y, np.zeros(pad, np.float32)])
    return jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
