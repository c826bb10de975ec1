"""Differentiable rendering: the capability the C++ reference lacks entirely.

The estimator in `integrator/wavefront.py` is written detached-sampling
style: every sampling decision (ray directions, Bernoulli reflect/refract,
Russian roulette, light selection) is `stop_gradient`-ed, while the
radiance-side terms — material diffuse/specular albedo products and emission
(`SceneData.mat_*`) — stay differentiable. For parameters that do not move
discrete decision boundaries this yields *unbiased* pixel gradients: the
north-star contract is gradients w.r.t. material albedo + emitter radiance
that match finite differences under common random numbers.

Note on roulette: past depth 4 the roulette probability depends on the path
throughput and hence on albedo (ref: worker.cpp:67-70). The probability is
detached, so the analytic gradient treats it as a constant; finite
differences see O(eps) threshold crossings. At `max_depth <= 4` (p == 1) the
two agree exactly; beyond that they agree in expectation.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..camera.camera import Camera
from ..core.config import RenderOptions
from ..integrator.film import pixel_camera_coords, render_chunk
from ..scene.scene import SceneData

#: The differentiable leaves of a scene (ref Material fields:
#: include/PathTrace/scene/material.h:12-77).
DIFFERENTIABLE_FIELDS = ("mat_diffuse", "mat_specular", "mat_emission")


def get_material_params(scene: SceneData, fields=DIFFERENTIABLE_FIELDS) -> dict:
    """Extract the differentiable material table columns as a params dict."""
    return {f: getattr(scene, f) for f in fields}


def apply_material_params(scene: SceneData, params: dict) -> SceneData:
    """Rebuild the scene with updated material parameters.

    Note: `mat_emission` feeds both shading and the (host-built) emissive CDF.
    The CDF stays fixed — it is a *sampling* distribution, so the estimator
    remains unbiased for any emission value; only its variance is affected
    (importance mismatch), matching detached-sampling semantics.
    """
    import dataclasses

    return dataclasses.replace(scene, **params)


@partial(jax.jit, static_argnames=("options", "spp"))
def render_image_diff(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    key,
    spp: int,
):
    """Differentiable fixed-spp mean image [H*W, 4] (scan-based wavefront)."""
    w, h = options.image_width, options.image_height
    px = jnp.arange(w, dtype=jnp.float32)
    py = jnp.arange(h, dtype=jnp.float32)
    xg, yg = jnp.meshgrid(px, py)
    x_cam, y_cam = pixel_camera_coords(options, xg.ravel(), yg.ravel())
    s, c = render_chunk(
        scene, camera, options, x_cam, y_cam, key, spp, differentiable=True
    )
    return s / jnp.maximum(c, 1)[:, None]


def image_loss(
    params: dict,
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    target: jnp.ndarray,  # [H*W, 4]
    key,
    spp: int,
):
    """Mean squared error of the rendered RGB against a target image.

    NB: with a Monte Carlo render X, E[(X-t)^2] = (E[X]-t)^2 + Var[X] — the
    variance term biases plain L2 toward low-variance (dark) parameters. Use
    `image_loss_unbiased` for optimization; this plain version is the right
    object for FD-vs-analytic gradient checks under common random numbers.
    """
    s = apply_material_params(scene, params)
    img = render_image_diff(s, camera, options, key, spp)
    diff = img[:, :3] - target[:, :3]
    return jnp.mean(diff * diff)


def image_loss_unbiased(
    params: dict,
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    target: jnp.ndarray,  # [H*W, 4]
    key,
    spp: int,
):
    """Unbiased squared-error estimator from two independent renders A, B:
    E[(A-t)(B-t)] = (E[X]-t)^2 exactly, with no Var[X] term — so gradient
    descent converges to the true parameters instead of dark ones."""
    s = apply_material_params(scene, params)
    ka, kb = jax.random.split(key)
    a = render_image_diff(s, camera, options, ka, spp)
    b = render_image_diff(s, camera, options, kb, spp)
    return jnp.mean((a[:, :3] - target[:, :3]) * (b[:, :3] - target[:, :3]))


loss_and_grad = jax.jit(
    jax.value_and_grad(image_loss),
    static_argnames=("options", "spp"),
)


def finite_difference_grad(
    params: dict,
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    target,
    key,
    spp: int,
    field: str,
    index: tuple,
    eps: float = 1e-3,
) -> float:
    """Central finite difference of `image_loss` w.r.t. one parameter entry,
    using common random numbers (same key both sides)."""
    def at(delta):
        p = dict(params)
        p[field] = p[field].at[index].add(delta)
        return float(image_loss(p, scene, camera, options, target, key, spp))

    return (at(eps) - at(-eps)) / (2.0 * eps)


def inverse_render(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    target: jnp.ndarray,  # [H*W, 4] ground-truth mean image
    init_params: dict,
    steps: int = 100,
    learning_rate: float = 0.05,
    spp: int = 16,
    seed: int = 0,
    callback=None,
):
    """Recover material parameters by Adam gradient descent on the image loss
    — the inverse-rendering demo (examples/inverse_render.py)."""
    import optax

    # NEE's 1/r^2 close-to-light singularity produces heavy-tailed gradient
    # spikes (fireflies); clipping keeps one spike from steering Adam's
    # momentum for many steps.
    opt = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adam(learning_rate),
    )
    params = init_params
    state = opt.init(params)
    key = jax.random.PRNGKey(seed)

    @partial(jax.jit, static_argnames=("options", "spp"))
    def step(params, state, key, scene, camera, options, target, spp):
        loss, grads = jax.value_and_grad(image_loss_unbiased)(
            params, scene, camera, options, target, key, spp
        )
        updates, state = opt.update(grads, state)
        params = optax.apply_updates(params, updates)
        # Physical projection: albedo/emission stay non-negative.
        params = {k: jnp.maximum(v, 0.0) for k, v in params.items()}
        return params, state, loss

    losses = []
    for i in range(steps):
        key, k = jax.random.split(key)
        params, state, loss = step(
            params, state, k, scene, camera, options, target, spp
        )
        losses.append(float(loss))
        if callback is not None:
            callback(i, float(loss), params)
    return params, np.asarray(losses)
