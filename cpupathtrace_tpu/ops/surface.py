"""Surface queries on the unified primitive index space: shading normals and
uniform surface sampling (for area lights / NEE).

Parity:
  * triangle barycentric-interpolated per-vertex normals
    (ref: src/scene/object.cpp:126-144 Triangle::getSurfaceNormal)
  * sphere radial normal (ref: object.cpp:86-88)
  * triangle surface sampling, sqrt warp, pdf 1/area (ref: object.cpp:192-207)
  * sphere surface sampling, uniform, pdf 1/(4 pi r^2) (ref: object.cpp:101-116)
"""
from __future__ import annotations

import jax.numpy as jnp

from ..scene.scene import SceneData
from ..utils.math import PI, cross, dot, length, normalize, sqrt


def _gather_tri(scene: SceneData, idx):
    idx = jnp.clip(idx, 0, scene.tri_v0.shape[0] - 1)
    return (
        scene.tri_v0[idx], scene.tri_v1[idx], scene.tri_v2[idx],
        scene.tri_n0[idx], scene.tri_n1[idx], scene.tri_n2[idx],
        scene.tri_cull[idx],
    )


def surface_normal(scene: SceneData, prim, pos):
    """Shading normal at `pos` on primitive `prim` ([...] i32, [...,3])."""
    is_tri = prim < scene.n_tri
    v0, v1, v2, n0, n1, n2, _ = _gather_tri(scene, jnp.where(is_tri, prim, 0))

    ab = v1 - v0
    ac = v2 - v0
    ap = pos - v0
    d00 = dot(ab, ab)
    d01 = dot(ab, ac)
    d11 = dot(ac, ac)
    d20 = dot(ap, ab)
    d21 = dot(ap, ac)
    inv_d = 1.0 / (d00 * d11 - d01 * d01)
    v = (d11 * d20 - d01 * d21) * inv_d
    w = (d00 * d21 - d01 * d20) * inv_d
    u = 1.0 - v - w
    n_tri = normalize(n0 * u[..., None] + n1 * v[..., None] + n2 * w[..., None])

    sidx = jnp.clip(prim - scene.n_tri, 0, scene.sph_center.shape[0] - 1)
    n_sph = normalize(pos - scene.sph_center[sidx])

    return jnp.where(is_tri[..., None], n_tri, n_sph)


def sample_prim_surface(scene: SceneData, prim, u1, u2):
    """Uniformly sample a point on primitive `prim`.

    Returns (pos [...,3], pdf [...], cull [...] bool) matching
    Object::sampleSurface's contract (ref: object.h:54 + object.cpp:101-116,
    192-207).
    """
    is_tri = prim < scene.n_tri
    v0, v1, v2, _, _, _, cull_tri = _gather_tri(scene, jnp.where(is_tri, prim, 0))

    rr1 = sqrt(u1)
    pos_tri = (
        v0 * (1.0 - rr1)[..., None]
        + v1 * (rr1 * (1.0 - u2))[..., None]
        + v2 * (rr1 * u2)[..., None]
    )
    area = length(cross(v1 - v0, v2 - v0)) / 2.0
    pdf_tri = 1.0 / jnp.maximum(area, 1e-30)

    sidx = jnp.clip(prim - scene.n_tri, 0, scene.sph_center.shape[0] - 1)
    c = scene.sph_center[sidx]
    r = scene.sph_radius[sidx]
    theta = 2.0 * PI * u1
    phi = jnp.arccos(jnp.clip(1.0 - 2.0 * u2, -1.0, 1.0))
    sp = jnp.sin(phi)
    unit = jnp.stack([sp * jnp.cos(theta), sp * jnp.sin(theta), jnp.cos(phi)], axis=-1)
    pos_sph = c + unit * r[..., None]
    pdf_sph = 1.0 / jnp.maximum(4.0 * PI * r * r, 1e-30)

    pos = jnp.where(is_tri[..., None], pos_tri, pos_sph)
    pdf = jnp.where(is_tri, pdf_tri, pdf_sph)
    cull = jnp.where(is_tri, cull_tri, False)
    return pos, pdf, cull
