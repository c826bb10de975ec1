"""Vectorized BSDFs: Lambertian, Glass (Fresnel), Mirror.

(The reference also declares a `CombinedBSDF` (propagation.h:110-132) that is
never defined or used anywhere in its codebase — a vestigial API, deliberately
not reproduced.)

The reference dispatches through virtual `BSDF` subclasses
(ref: src/scene/propagation.cpp); here polymorphism becomes an integer type
code per material and masked selects, so every lane takes the same (cheap)
instruction stream — the batched replacement for virtual dispatch.

Contracts preserved exactly:
  * propagate -> (next_ray, ray_factor, ray_pd)
  * eval      -> (spectrum, shade_factor, pd); `synthetic=True` marks NEE
    shadow rays, for which specular BSDFs report pd=0 and thereby opt out of
    next-event estimation (ref: propagation.cpp:173,214).

Differentiability: sampled directions and discrete choices (Bernoulli
reflect/refract) are detached (`stop_gradient`); the spectrum evaluations stay
differentiable w.r.t. the material table (diffuse/specular/emission), which is
the north-star gradient path.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene.scene import SceneData, BSDF_LAMBERTIAN, BSDF_GLASS, BSDF_MIRROR
from ..utils.math import PI, dot, local_to_global, normalize, reflect, sqrt


class RayMaterial(NamedTuple):
    """Material table rows gathered for a batch of hit points."""

    diffuse: jnp.ndarray  # [R,4]
    specular: jnp.ndarray  # [R,4]
    ior: jnp.ndarray  # [R]
    emission: jnp.ndarray  # [R,4]
    bsdf: jnp.ndarray  # [R] i32
    one_way: jnp.ndarray  # [R] bool


def gather_material(scene: SceneData, prim: jnp.ndarray) -> RayMaterial:
    """prim -> material id -> table rows. Invalid prims clamp to row 0."""
    is_tri = prim < scene.n_tri
    p = jnp.maximum(prim, 0)
    tid = scene.tri_material[jnp.clip(p, 0, scene.tri_material.shape[0] - 1)]
    sid = scene.sph_material[jnp.clip(p - scene.n_tri, 0, scene.sph_material.shape[0] - 1)]
    mid = jnp.where(is_tri, tid, sid)
    return RayMaterial(
        diffuse=scene.mat_diffuse[mid],
        specular=scene.mat_specular[mid],
        ior=scene.mat_ior[mid],
        emission=scene.mat_emission[mid],
        bsdf=scene.mat_bsdf[mid],
        one_way=scene.mat_one_way[mid],
    )


def importance_sample_cosine(u1, u2, e=1.0):
    """Cosine-power hemisphere sample in tangent space with pdf
    (e+1) cos^e(theta) / 2pi (ref: propagation.cpp:11-21)."""
    fac = sqrt(1.0 - jnp.power(u2, 2.0 / (e + 1.0)))
    cos_theta = jnp.power(u2, 1.0 / (e + 1.0))
    vec = jnp.stack(
        [fac * jnp.cos(2.0 * PI * u1), fac * jnp.sin(2.0 * PI * u1), cos_theta],
        axis=-1,
    )
    p = (e + 1.0) * jnp.power(cos_theta, e) / (2.0 * PI)
    return vec, p


def fresnel_reflectance(ray_dot, ri_leaving, ri_entering):
    """Unpolarized Fresnel reflectance + transmitted cosine; total internal
    reflection -> (1, 0) (ref: propagation.cpp:64-83)."""
    sin_i = sqrt(jnp.maximum(1.0 - ray_dot * ray_dot, 0.0))
    sin_t = ri_leaving / ri_entering * sin_i
    tir = sin_t >= 1.0
    cos_t = sqrt(jnp.maximum(1.0 - sin_t * sin_t, 0.0))
    r_par = (ri_entering * ray_dot - ri_leaving * cos_t) / (
        ri_entering * ray_dot + ri_leaving * cos_t
    )
    r_perp = (ri_leaving * ray_dot - ri_entering * cos_t) / (
        ri_leaving * ray_dot + ri_entering * cos_t
    )
    reflectance = (r_par * r_par + r_perp * r_perp) / 2.0
    return jnp.where(tir, 1.0, reflectance), jnp.where(tir, 0.0, cos_t)


def propagate(
    mat: RayMaterial,
    ray_dir: jnp.ndarray,  # [R,3] incoming (towards surface)
    pos: jnp.ndarray,  # [R,3] hit point
    normal: jnp.ndarray,  # [R,3] unit shading normal
    epsilon,
    u: jnp.ndarray,  # [R,3] uniforms: (u1, u2, bernoulli)
):
    """Sample the outgoing ray for every lane; returns
    (next_origin [R,3], next_dir [R,3], ray_factor [R], ray_pd [R]).
    Masked-select equivalent of the virtual propagateRay dispatch."""
    u1, u2, ub = u[..., 0], u[..., 1], u[..., 2]

    # --- Lambertian (ref: propagation.cpp:89-104) ---------------------------
    local, p_lam = importance_sample_cosine(u1, u2, 1.0)
    dir_lam = local_to_global(local, normal)
    fac_lam = jnp.ones_like(p_lam)

    # --- Glass (ref: propagation.cpp:120-160) --------------------------------
    ray_dot = -dot(ray_dir, normal)
    entering = ray_dot >= 0.0
    ri = mat.ior
    ri_leaving = jnp.where(entering, 1.0, ri)
    ri_entering = jnp.where(entering, ri, 1.0)
    rat, cos_t = fresnel_reflectance(jnp.abs(ray_dot), ri_leaving, ri_entering)
    reflect_choice = ub < rat
    sign = jnp.where(ray_dot < 0.0, -1.0, 1.0)
    dir_reflect = reflect(ray_dir, normal * sign[..., None])
    ratio = ri_leaving / ri_entering
    dir_refract = normalize(
        ray_dir * ratio[..., None]
        + normal * ((ratio * jnp.abs(ray_dot) - cos_t) * sign)[..., None]
    )
    ri_fac = (ri_entering * ri_entering) / (ri_leaving * ri_leaving)
    dir_glass = jnp.where(reflect_choice[..., None], dir_reflect, dir_refract)
    fac_glass = jnp.where(reflect_choice, rat, ri_fac * (1.0 - rat))
    p_glass = jnp.where(reflect_choice, rat, 1.0 - rat)

    # --- Mirror (ref: propagation.cpp:180-204) -------------------------------
    unaligned = dot(ray_dir, normal) > 0.0
    pass_through = mat.one_way & unaligned
    flip = (~mat.one_way) & unaligned
    normal_dir = normal * jnp.where(flip, -1.0, 1.0)[..., None]
    dir_mirror = jnp.where(
        pass_through[..., None], ray_dir, reflect(ray_dir, normal_dir)
    )
    fac_mirror = jnp.ones_like(p_lam)
    p_mirror = jnp.ones_like(p_lam)

    is_glass = mat.bsdf == BSDF_GLASS
    is_mirror = mat.bsdf == BSDF_MIRROR
    next_dir = jnp.where(
        is_glass[..., None], dir_glass, jnp.where(is_mirror[..., None], dir_mirror, dir_lam)
    )
    ray_factor = jnp.where(is_glass, fac_glass, jnp.where(is_mirror, fac_mirror, fac_lam))
    ray_pd = jnp.where(is_glass, p_glass, jnp.where(is_mirror, p_mirror, p_lam))

    # Detach sampling decisions; keep pdf/factor values (they feed the
    # estimator weights, whose gradients w.r.t. geometry/ior are out of scope).
    next_dir = jax.lax.stop_gradient(next_dir)
    next_origin = pos + next_dir * epsilon
    return next_origin, next_dir, ray_factor, ray_pd


def eval_spectrum(
    mat: RayMaterial,
    from_dir: jnp.ndarray,  # [R,3] camera-side incoming direction
    to_dir: jnp.ndarray,  # [R,3] light-side outgoing direction
    normal: jnp.ndarray,  # [R,3]
    light_spectrum: jnp.ndarray,  # [R,4]
    synthetic: bool,
):
    """Evaluate (spectrum, shade_factor, pd) for a direction pair — the
    vectorized BSDF::getSpectrum (ref: propagation.cpp:107-116, 163-177,
    207-219). `synthetic` is a static flag (NEE vs sampled bounce)."""
    # Lambertian
    shade_lam = jnp.maximum(dot(normal, to_dir), 0.0) / PI
    spec_lam = mat.diffuse * light_spectrum
    pd_lam = jnp.ones_like(shade_lam)

    # Glass: specular color when transmitting to the other hemisphere
    same_side = dot(from_dir, to_dir) <= 0.0
    spec_glass = light_spectrum * jnp.where(
        same_side[..., None], mat.specular, mat.diffuse
    )
    # Mirror: specular unless one-way backface transmission
    mirror_mul = jnp.where(
        ((~mat.one_way) | same_side)[..., None], mat.specular, jnp.ones_like(mat.specular)
    )
    spec_mirror = light_spectrum * mirror_mul

    ones = jnp.ones_like(shade_lam)
    pd_specular = jnp.zeros_like(ones) if synthetic else ones

    is_glass = mat.bsdf == BSDF_GLASS
    is_mirror = mat.bsdf == BSDF_MIRROR
    spectrum = jnp.where(
        is_glass[..., None], spec_glass, jnp.where(is_mirror[..., None], spec_mirror, spec_lam)
    )
    shade = jnp.where(is_glass | is_mirror, ones, shade_lam)
    pd = jnp.where(is_glass | is_mirror, pd_specular, pd_lam)
    return spectrum, shade, pd
