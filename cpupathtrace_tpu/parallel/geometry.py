"""Geometry-parallel (primitive-sharded) rendering over a device mesh.

The scene's pre-blocked triangle clusters are sharded over a named mesh
axis ("gp"); every device intersects the full ray wavefront against its
cluster slice and per-shard nearest hits are combined with two `pmin`
collectives per query (ops/intersect.py:_gp_combine). This is the
tensor-parallel analog for scenes whose intersection tables exceed one
device's memory — SURVEY §2's "primitive-sharded variant for giant scenes".

Reference analog: none. The reference shares one `Scene` across its thread
pool (src/worker.cpp:364-387) and is bounded by a single host's RAM; there
is no mechanism to split geometry.

Design:
  * **Sharded** (axis 0 = cluster axis): the sweep intersector's cluster
    tables `blk_v0/v1/v2`, `blk_cull`, `blk_prim`, `blk_lo`, `blk_hi` —
    the dominant intersection memory (3 verts x 3 f32 per triangle plus
    bounds). Padding clusters carry `blk_prim = -1`, which every
    intersector already masks.
  * **Replicated**: shading tables (`tri_*` normals/materials — gathered
    per HIT, so they cannot be cheaply sharded without an all-to-all),
    spheres, materials, lights, and the whole estimator state. Since the
    combined (t, prim) is identical on every shard, the wavefront stays
    replicated bounce by bounce and needs no further collectives.
  * **Collectives**: 2 pmins ([R] f32 + [R] i32) per intersection query —
    nearest-hit and NEE shadow queries alike.

The per-shard intersector is the dense-top sweep (ops/intersect.py:
sweep_intersect): it is exact over any cluster subset, so min-over-shards
of exact local results is the exact global nearest hit. Composition with
the (dp, sp) image mesh (parallel/render.py) is orthogonal: shard pixels
over dp, samples over sp, clusters over gp.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..camera.camera import Camera, shoot_rays
from ..core.config import RenderOptions
from ..integrator.film import pixel_camera_coords
from ..integrator.wavefront import trace
from ..scene.scene import SceneData

# SceneData fields sharded on their leading (cluster) axis.
_GP_FIELDS = (
    "blk_v0", "blk_v1", "blk_v2", "blk_cull", "blk_prim", "blk_lo", "blk_hi"
)


def make_gp_mesh(devices=None, axis: str = "gp") -> Mesh:
    """1-D geometry-parallel mesh over `devices` (default: all)."""
    devices = jax.devices() if devices is None else list(devices)
    return Mesh(np.array(devices), (axis,))


def shard_scene_geometry(
    scene: SceneData, n_shards: int, axis: str = "gp"
) -> SceneData:
    """Host-side prep: pad the cluster axis to a multiple of `n_shards`,
    drop the unused accelerator tables (per-prim BVH and cluster tree —
    the gp path intersects with the sweep), and mark the scene
    with `gp_axis`. Pass the result through `gp_in_specs(scene)` to
    shard_map (or device_put each _GP_FIELDS leaf with a NamedSharding).
    """
    if scene.accel not in ("sweep", "cluster"):
        raise ValueError(
            "geometry-parallel rendering needs every triangle in the "
            f"cluster tables; build the scene with accel='sweep' (got "
            f"accel={scene.accel!r}, whose big-triangle partition would "
            "be lost)"
        )
    c = scene.blk_lo.shape[0]
    pad = (-c) % n_shards
    f32 = jnp.float32

    def pad0(a, fill):
        if pad == 0:
            return a
        wide = jnp.full((pad,) + a.shape[1:], fill, a.dtype)
        return jnp.concatenate([a, wide])

    return dataclasses.replace(
        scene,
        accel="sweep",
        gp_axis=axis,
        blk_v0=pad0(scene.blk_v0, 0.0),
        blk_v1=pad0(scene.blk_v1, 0.0),
        blk_v2=pad0(scene.blk_v2, 0.0),
        blk_cull=pad0(scene.blk_cull, False),
        blk_prim=pad0(scene.blk_prim, -1),
        # Padding clusters: inverted bounds make the slab test miss; their
        # blk_prim = -1 also voids them via cluster_valid.
        blk_lo=pad0(scene.blk_lo, jnp.inf),
        blk_hi=pad0(scene.blk_hi, -jnp.inf),
        # Tables the sweep never touches — freed so the gp memory budget
        # is the sharded slice, not the replicated originals.
        bvh_lo=jnp.zeros((1, 3), f32), bvh_hi=jnp.zeros((1, 3), f32),
        bvh_left=jnp.full(1, -1, jnp.int32),
        bvh_right=jnp.full(1, -1, jnp.int32),
        bvh_prim=jnp.full(1, -1, jnp.int32),
        cl_lo=jnp.zeros((1, 3), f32), cl_hi=jnp.zeros((1, 3), f32),
        cl_left=jnp.full(1, -1, jnp.int32),
        cl_right=jnp.full(1, -1, jnp.int32),
        cl_leaf=jnp.full(1, -1, jnp.int32),
    )


def gp_in_specs(scene: SceneData, axis: str = "gp") -> SceneData:
    """A SceneData-shaped pytree of PartitionSpecs: cluster tables on
    `axis`, everything else replicated."""
    spec = jax.tree.map(lambda _: P(), scene)
    return dataclasses.replace(spec, **{f: P(axis) for f in _GP_FIELDS})


def _trace_gp(camera, options, spp, scene, x, y, key):
    """Per-shard body. The key is NOT folded with the gp index: every
    shard must draw identical sample streams so the replicated estimator
    stays bitwise consistent after each pmin combine."""
    p = x.shape[0]
    xs = jnp.tile(x, spp)
    ys = jnp.tile(y, spp)
    k_cam, k_trace = jax.random.split(key)
    rays = shoot_rays(
        camera, xs, ys,
        1.0 / options.image_width, 1.0 / options.image_height, k_cam,
    )
    spectrum, collected = trace(scene, rays, options, k_trace)
    spectrum = spectrum.reshape(spp, p, 4)
    collected = collected.reshape(spp, p)
    s = jnp.sum(jnp.where(collected[..., None], spectrum, 0.0), axis=0)
    c = jnp.sum(collected.astype(jnp.int32), axis=0)
    return s, c


@partial(jax.jit, static_argnames=("options", "mesh", "spp", "axis"))
def render_chunk_gp(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    mesh: Mesh,
    x_cam: jnp.ndarray,  # [P]
    y_cam: jnp.ndarray,
    key,
    spp: int,
    axis: str = "gp",
):
    """Geometry-parallel render of P pixels at `spp` samples; returns
    (sum [P,4], collected [P]), replicated. `scene` must come from
    `shard_scene_geometry(scene, mesh.shape[axis])`."""
    if scene.gp_axis != axis:
        raise ValueError(
            f"scene.gp_axis={scene.gp_axis!r}; run shard_scene_geometry first"
        )
    if scene.blk_lo.shape[0] % mesh.shape[axis]:
        raise ValueError("cluster count not divisible by the gp axis")
    fn = jax.shard_map(
        partial(_trace_gp, camera, options, spp),
        mesh=mesh,
        in_specs=(gp_in_specs(scene, axis), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(scene, x_cam, y_cam, key)


def render_gp(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    mesh: Mesh,
    seed: int = 0,
    spp: int | None = None,
    axis: str = "gp",
) -> np.ndarray:
    """Full-frame fixed-spp geometry-parallel render; returns [H, W, 4].

    The scene may be un-sharded (it is prepared on the fly) or the output
    of `shard_scene_geometry`."""
    if scene.gp_axis is None:
        scene = shard_scene_geometry(scene, mesh.shape[axis], axis)
    w, h = options.image_width, options.image_height
    spp = spp if spp is not None else options.max_sample_count

    xg, yg = np.meshgrid(
        np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)
    )
    x_cam, y_cam = pixel_camera_coords(options, xg.ravel(), yg.ravel())

    s, c = render_chunk_gp(
        scene, camera, options, mesh,
        jnp.asarray(x_cam, jnp.float32), jnp.asarray(y_cam, jnp.float32),
        jax.random.PRNGKey(seed), spp, axis,
    )
    s = np.asarray(s)
    c = np.asarray(c)
    img = s / np.maximum(c, 1)[:, None]
    img = np.where(c[:, None] > 0, img, 0.0).astype(np.float32)
    return img.reshape(h, w, 4)
