"""Wavefront path-tracing integrator.

Architecture inversion of the reference's depth-first per-ray loop
(ref: src/worker.cpp:26-146 impl::getSample): instead of one ray recursing
through the scene, a whole batch of rays advances bounce-by-bounce with an
alive mask. Same estimator, different execution order:

  * emission collected at every path vertex, weighted by
    1 / (sample_divisor * sample_bounce_pd)          (ref: worker.cpp:62-64)
  * next-event estimation at every vertex against all point lights plus K
    CDF-sampled emissive primitives                  (ref: worker.cpp:72-103)
  * Russian roulette: p = 1 for depth <= 4, else
    0.1 + 0.1 * min(contribution_unweighted * mean_rgb(sample_spectrum), 1)
                                                     (ref: worker.cpp:67-70)
  * bounce_pd accumulates roulette probabilities including the final (1-p)
    stop factor                                      (ref: worker.cpp:106-110)
  * sample_divisor accumulates prod(ray_pd * shading_pd / (ray_factor *
    shading_factor))                                 (ref: worker.cpp:121-130)
  * termination: miss, roulette stop, bounce_pd <= 1e-20, divisor <= 1e-20
                                                     (ref: worker.cpp:47,106,112,134)
  * alpha channel = "any hit" mask                   (ref: worker.cpp:141-143)

The roulette schedule bounds survival: past depth 4 every step multiplies
bounce_pd by <= 0.2, so bounce_pd <= 1e-20 within ~34 bounces — the loop
terminates without the reference's unbounded `for(;;)`.

Differentiation: pdf-side weights (divisor, bounce_pd, roulette p) are
detached; radiance-side terms (sample_spectrum albedo products, emission)
stay differentiable — the detached-sampling estimator with unbiased gradients
w.r.t. material albedo / specular / emission.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..bsdf.bsdf import eval_spectrum, gather_material, propagate
from ..core import debug
from ..core.config import RenderOptions
from ..core.rays import Rays
from ..ops.intersect import scene_intersect
from ..ops.surface import surface_normal
from ..scene.lights import num_light_samples, sample_lights
from ..scene.scene import SceneData
from ..utils.math import dot, length, normalize

_PD_CUTOFF = 1e-20


def _mean_rgb(spectrum):
    """getContribution: (r+g+b)/3 (ref: worker.cpp:12-14)."""
    return (spectrum[..., 0] + spectrum[..., 1] + spectrum[..., 2]) / 3.0


def light_visibility(scene: SceneData, pos, target, eps, live):
    """NEE shadow query from points `pos` [R, 3] to light points
    `target` [R, L, 3]: any occluder strictly before the light blocks
    (ref: worker.cpp:84-86). The ray starts `eps` along the light direction
    and `t_max = dist - eps` holds the reference's `lt >= dist - eps`
    pass-through. Returns (ldir [R, L, 3], visible [R, L] bool)."""
    to_light = target - pos[:, None, :]
    ldir = normalize(to_light)
    sh_o = (pos[:, None, :] + ldir * eps).reshape(-1, 3)
    dist = length(to_light)
    lt, _ = scene_intersect(
        scene, sh_o, ldir.reshape(-1, 3),
        t_max=(dist - eps).reshape(-1),
        live=live.reshape(-1),
        any_hit=True,
    )
    return ldir, lt.reshape(target.shape[:2]) < 0.0


def trace(
    scene: SceneData,
    rays: Rays,
    options: RenderOptions,
    key,
    differentiable: bool = False,
):
    """Trace a flat batch of rays to completion.

    Returns (spectrum [R,4] with alpha = any-hit, collected [R] bool).

    `differentiable=True` runs a fixed-length `lax.scan` (reverse-mode
    friendly); otherwise a `lax.while_loop` that exits as soon as every lane
    is dead.
    """
    o = rays.origin
    d = rays.direction
    n_rays = o.shape[0]
    eps = options.epsilon

    state = dict(
        o=o,
        d=d,
        sample_spectrum=jnp.ones((n_rays, 4)),
        out=jnp.zeros((n_rays, 4)),
        divisor=jnp.ones(n_rays),
        bounce_pd=jnp.ones(n_rays),
        contribution_unweighted=jnp.ones(n_rays),
        collected=jnp.zeros(n_rays, bool),
        alive=jnp.ones(n_rays, bool),
        depth=jnp.zeros((), jnp.int32),
        key=key,
    )

    def body(s):
        key, k_rt, k_nee, k_prop = jax.random.split(s["key"], 4)

        # Debug-assertion layer (PTX_DEBUG=1; ref: base.h:59-80 assert set).
        # No-ops unless enabled; surfaced via `checked_trace`.
        debug.check_normalized(s["d"], "ray direction")
        debug.check_non_negative(s["sample_spectrum"], "sample_spectrum")
        debug.check_non_negative(s["out"], "accumulated spectrum")
        debug.check_finite(s["divisor"], "sample_divisor")
        debug.check_finite(s["bounce_pd"], "sample_bounce_pd")

        t, prim = scene_intersect(scene, s["o"], s["d"], live=s["alive"])
        hit = s["alive"] & (t >= 0.0)
        prim_safe = jnp.maximum(prim, 0)

        pos = s["o"] + s["d"] * t[..., None]
        normal = surface_normal(scene, prim_safe, pos)
        mat = gather_material(scene, prim_safe)

        collected = s["collected"] | hit
        # path_length for every alive lane equals depth+1 (a lane stays alive
        # only by hitting every bounce), so the roulette depth test is scalar.
        path_length = s["depth"] + 1

        divisor = s["divisor"]
        bounce_pd = s["bounce_pd"]
        # Dead lanes can carry divisor/bounce_pd values at or below the
        # cutoff (including exact 0 after underflow); their contributions
        # are masked out below, but an unguarded 1/0 here would poison the
        # BACKWARD pass (where's branch cotangent is 0 * inf = NaN — hit
        # in practice by rare grazing-cosine samples during inverse
        # rendering). Alive lanes always sit above the cutoffs, so the
        # guard never changes a used value.
        den = divisor * bounce_pd
        weight = jnp.where(hit, 1.0 / jnp.where(hit, den, 1.0), 0.0)

        # --- Emission at this vertex (ref: worker.cpp:62-64).
        out = s["out"] + jnp.where(
            hit[..., None], s["sample_spectrum"] * mat.emission * weight[..., None], 0.0
        )

        # --- Russian roulette (ref: worker.cpp:67-70).
        bp = jnp.where(
            path_length <= 4,
            1.0,
            0.1
            + 0.1
            * jnp.minimum(
                s["contribution_unweighted"] * _mean_rgb(s["sample_spectrum"]), 1.0
            ),
        )
        bp = jax.lax.stop_gradient(bp)
        u_rt = jax.random.uniform(k_rt, (n_rays,))
        do_bounce = u_rt < bp

        # --- Next-event estimation (ref: worker.cpp:72-103).
        nl = num_light_samples(scene)
        if nl > 0:
            lights = sample_lights(scene, pos, k_nee)
            ldir, visible = light_visibility(
                scene, pos, lights.target, eps, hit[:, None] & lights.valid
            )

            mat_l = jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(
                    x[:, None] if x.ndim == 1 else x[:, None, :],
                    (n_rays, nl) + x.shape[1:],
                ),
                mat,
            )
            from_dir = jnp.broadcast_to(s["d"][:, None, :], (n_rays, nl, 3))
            nrm = jnp.broadcast_to(normal[:, None, :], (n_rays, nl, 3))
            base_spec, shading, spd = eval_spectrum(
                mat_l, from_dir, ldir, nrm, lights.spectrum, synthetic=True
            )
            lpd = jax.lax.stop_gradient(lights.pd)
            spd = jax.lax.stop_gradient(spd)
            denom = (
                divisor[:, None] * bounce_pd[:, None] * lpd * jnp.where(spd > 0, spd, 1.0)
            )
            use = hit[:, None] & lights.valid & visible & (spd > 0.0)
            # Guard the masked lanes' denominator (dead lanes can carry an
            # underflowed divisor == 0): forward values on used lanes are
            # untouched, but x/0 on a masked lane would turn the where
            # backward into 0 * inf = NaN (see `weight` above).
            contrib = (
                base_spec
                * shading[..., None]
                * s["sample_spectrum"][:, None, :]
                / jnp.where(use, denom, 1.0)[..., None]
            )
            out = out + jnp.sum(jnp.where(use[..., None], contrib, 0.0), axis=1)

        # --- Roulette stop bookkeeping (ref: worker.cpp:106-110).
        bounce_pd = jnp.where(
            hit, jnp.where(do_bounce, bounce_pd * bp, bounce_pd * (1.0 - bp)), bounce_pd
        )
        cont = hit & do_bounce & (bounce_pd > _PD_CUTOFF)

        # --- Sample the next ray (ref: worker.cpp:117-130).
        u_prop = jax.random.uniform(k_prop, (n_rays, 3))
        no, nd, ray_factor, ray_pd = propagate(mat, s["d"], pos, normal, eps, u_prop)
        shaded, shading_factor, shading_pd = eval_spectrum(
            mat, s["d"], nd, normal, s["sample_spectrum"], synthetic=False
        )
        ray_pd = jax.lax.stop_gradient(ray_pd)
        ray_factor_d = jax.lax.stop_gradient(ray_factor)
        shading_pd = jax.lax.stop_gradient(shading_pd)
        shading_factor_d = jax.lax.stop_gradient(shading_factor)

        divisor = jnp.where(
            cont, divisor * (ray_pd / ray_factor_d) * (shading_pd / shading_factor_d), divisor
        )
        contribution_unweighted = jnp.where(
            cont,
            s["contribution_unweighted"] * ray_factor_d * shading_factor_d,
            s["contribution_unweighted"],
        )
        sample_spectrum = jnp.where(cont[..., None], shaded, s["sample_spectrum"])

        alive = cont & (divisor > _PD_CUTOFF)
        o_new = jnp.where(alive[..., None], no, s["o"])
        d_new = jnp.where(alive[..., None], nd, s["d"])

        return dict(
            o=o_new,
            d=d_new,
            sample_spectrum=sample_spectrum,
            out=out,
            divisor=divisor,
            bounce_pd=bounce_pd,
            contribution_unweighted=contribution_unweighted,
            collected=collected,
            alive=alive,
            depth=s["depth"] + 1,
            key=key,
        )

    if differentiable:
        def scan_body(s, _):
            return body(s), None

        state, _ = jax.lax.scan(scan_body, state, None, length=options.max_depth)
    else:
        def cond(s):
            return jnp.any(s["alive"]) & (s["depth"] < options.max_depth)

        state = jax.lax.while_loop(cond, body, state)

    collected = state["collected"]
    out = state["out"]
    # Alpha channel = any-hit mask (ref: worker.cpp:141-143).
    out = out.at[..., 3].set(jnp.where(collected, 1.0, 0.0))
    return out, collected


def checked_trace(scene, rays, options, key, differentiable=False):
    """`trace` with the PTX_DEBUG assertion layer surfaced: raises
    JaxRuntimeError on the first failed check (the analog of an assert
    firing in a reference debug build). Identical to `trace` when
    PTX_DEBUG is unset."""
    return debug.checked(
        lambda *a: trace(*a, differentiable=differentiable)
    )(scene, rays, options, key)
