"""SPMD sharded rendering over a (dp, sp) device mesh.

SPMD replacement for the reference's thread-pool scheduler
(ref: src/worker.cpp:328-414 doWorkParallel/processJob): the image's pixel
axis is sharded over `dp` (each shard is the analog of a work-queue tile),
samples-per-pixel are sharded over `sp`, and the per-pixel sample sums are
reduced with a `psum` over `sp` — the collective that replaces the
reference's shared output image + mutex.

RNG parity with the reference's forked per-thread engines
(ref: worker.cpp:369-382): every (dp, sp) shard folds its mesh coordinates
into the base key, so results are deterministic for a fixed mesh shape and
seed, and differ per shard.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..camera.camera import Camera, shoot_rays
from ..core.config import RenderOptions
from ..integrator.film import pixel_camera_coords
from ..integrator.wavefront import trace
from ..scene.scene import SceneData


def _trace_shard(scene, camera, options, spp_local, differentiable, x, y, key,
                 k_batches=1):
    """Per-shard body: trace `k_batches * spp_local` samples for this pixel
    shard and psum-accumulate over the sample-parallel axis. With
    `k_batches > 1`, per-batch (sums [K,P,4], counts [K,P]) come back so the
    adaptive driver folds K stats batches from ONE sharded launch (the SPMD
    analog of film.render_chunk_batched)."""
    dp_i = jax.lax.axis_index("dp")
    sp_i = jax.lax.axis_index("sp")
    key = jax.random.fold_in(jax.random.fold_in(key, dp_i), sp_i)

    p = x.shape[0]
    spp = spp_local * k_batches
    xs = jnp.tile(x, spp)
    ys = jnp.tile(y, spp)
    k_cam, k_trace = jax.random.split(key)
    rays = shoot_rays(
        camera, xs, ys,
        1.0 / options.image_width, 1.0 / options.image_height, k_cam,
    )
    spectrum, collected = trace(scene, rays, options, k_trace, differentiable)
    spectrum = spectrum.reshape(k_batches, spp_local, p, 4)
    collected = collected.reshape(k_batches, spp_local, p)
    s = jnp.sum(jnp.where(collected[..., None], spectrum, 0.0), axis=1)
    c = jnp.sum(collected.astype(jnp.int32), axis=1)
    # Reduce partial sample sums across the sample-parallel axis.
    s = jax.lax.psum(s, "sp")
    c = jax.lax.psum(c, "sp")
    return s, c


@partial(
    jax.jit,
    static_argnames=("options", "mesh", "spp", "differentiable"),
)
def render_chunk_sharded(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    mesh: Mesh,
    x_cam: jnp.ndarray,  # [P] padded to a multiple of mesh dp size
    y_cam: jnp.ndarray,
    key,
    spp: int,
    differentiable: bool = False,
):
    """Sharded render of P pixels at `spp` samples; returns (sum [P,4],
    collected [P]) fully replicated."""
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    if x_cam.shape[0] % dp != 0:
        raise ValueError(f"pixel count {x_cam.shape[0]} not divisible by dp={dp}")
    if spp % sp != 0:
        raise ValueError(f"spp {spp} not divisible by sp={sp}")

    fn = jax.shard_map(
        partial(_trace_shard, scene, camera, options, spp // sp, differentiable),
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P()),
        out_specs=(P(None, "dp"), P(None, "dp")),
        check_vma=False,
    )
    s, c = fn(x_cam, y_cam, key)
    return s[0], c[0]


@partial(
    jax.jit,
    static_argnames=("options", "mesh", "spp_batch", "k_batches"),
)
def render_chunk_batched_sharded(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    mesh: Mesh,
    x_cam: jnp.ndarray,  # [P] padded to a multiple of mesh dp size
    y_cam: jnp.ndarray,
    key,
    spp_batch: int,
    k_batches: int,
):
    """Sharded analog of film.render_chunk_batched: `k_batches` stats
    batches of `spp_batch` samples in ONE sharded launch; returns per-batch
    (sums [K, P, 4], counts [K, P]) fully replicated."""
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    if x_cam.shape[0] % dp != 0:
        raise ValueError(f"pixel count {x_cam.shape[0]} not divisible by dp={dp}")
    if spp_batch % sp != 0:
        raise ValueError(
            f"stats batch size {spp_batch} not divisible by sp={sp}; "
            "use make_render_mesh(sample_axis=...) with a divisor of the "
            "adaptive stats batch size"
        )

    fn = jax.shard_map(
        partial(_trace_shard, scene, camera, options, spp_batch // sp, False,
                k_batches=k_batches),
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P()),
        out_specs=(P(None, "dp"), P(None, "dp")),
        check_vma=False,
    )
    return fn(x_cam, y_cam, key)


def render_sharded(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    mesh: Mesh,
    seed: int = 0,
    spp: int | None = None,
) -> np.ndarray:
    """Full-frame fixed-spp SPMD render; returns [H, W, 4] float32.

    The distributed analog of `render()` for parity/benchmark configs
    (fixed sample counts). Pixels are padded to the dp axis, sample sums are
    psum'd over sp, and the mean image is gathered to the host.
    """
    w, h = options.image_width, options.image_height
    spp = spp if spp is not None else options.max_sample_count
    dp = mesh.shape["dp"]

    px = np.arange(w, dtype=np.float32)
    py = np.arange(h, dtype=np.float32)
    xg, yg = np.meshgrid(px, py)
    x_cam, y_cam = pixel_camera_coords(options, xg.ravel(), yg.ravel())

    n = x_cam.size
    pad = (-n) % dp
    if pad:
        x_cam = np.concatenate([x_cam, np.zeros(pad, np.float32)])
        y_cam = np.concatenate([y_cam, np.zeros(pad, np.float32)])

    key = jax.random.PRNGKey(seed)
    s, c = render_chunk_sharded(
        scene, camera, options, mesh,
        jnp.asarray(x_cam, jnp.float32), jnp.asarray(y_cam, jnp.float32),
        key, spp,
    )
    s = np.asarray(s)[:n]
    c = np.asarray(c)[:n]
    img = s / np.maximum(c, 1)[:, None]
    img = np.where(c[:, None] > 0, img, 0.0).astype(np.float32)
    return img.reshape(h, w, 4)


def adaptive_sample_axis(options: RenderOptions, n_devices: int) -> int:
    """Largest valid `sample_axis` for an ADAPTIVE sharded render: must
    divide the device count AND the adaptive stats-batch size AND the
    final remainder chunk (so every sharded launch splits its samples
    evenly over `sp`)."""
    from ..integrator.film import adaptive_constants

    stats, _, _ = adaptive_constants(options)
    max_sc = options.max_sample_count
    remainder = max_sc - (max_sc // stats) * stats
    axis = 1
    for cand in (4, 2):
        if (
            n_devices % cand == 0
            and n_devices // cand >= cand
            and stats % cand == 0
            and remainder % cand == 0
        ):
            axis = cand
            break
    return axis


def render_sharded_adaptive(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    mesh: Mesh,
    seed: int = 0,
    progress_callback=None,
    rays_per_launch: int = 1 << 20,
) -> np.ndarray:
    """Full-frame ADAPTIVE SPMD render; returns [H, W, 4] float32.

    The distributed analog of the single-device `render()` — the same
    min/max-spp adaptive contract (Welford stats batches, consecutive-pass
    accept, candidate selection — ref: src/worker.cpp:149-322) driven over
    sharded chunk launches: film.render_tile runs unchanged, with its chunk
    renderers swapped for `render_chunk_sharded`/`render_chunk_batched_sharded`
    over `mesh`. The per-tile progress callback matches the reference's
    tiles-done contract (ref: include/PathTrace/worker.h:74-79).

    """
    from ..integrator.film import adaptive_constants, render_tile

    w, h = options.image_width, options.image_height
    if w <= 0 or h <= 0:
        return np.zeros((max(h, 0), max(w, 0), 4), np.float32)

    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    stats, _, _ = adaptive_constants(options)
    max_sc = options.max_sample_count
    remainder = max_sc - (max_sc // stats) * stats
    if stats % sp != 0 or remainder % sp != 0:
        raise ValueError(
            f"adaptive stats batches ({stats} spp, remainder {remainder}) "
            f"not divisible by the sample-parallel axis sp={sp}; build the "
            "mesh with make_render_mesh(sample_axis="
            f"{adaptive_sample_axis(options, mesh.size)})"
        )

    rows_per_tile = max(1, min(h, rays_per_launch // max(w * stats, 1)))
    n_tiles = math.ceil(h / rows_per_tile)

    px = np.arange(w, dtype=np.float32)
    image = np.zeros((h, w, 4), np.float32)
    key = jax.random.PRNGKey(seed)
    tile_keys = jax.random.split(key, n_tiles)

    for i in range(n_tiles):
        y0 = i * rows_per_tile
        rows = min(rows_per_tile, h - y0)
        py = np.arange(y0, y0 + rows, dtype=np.float32)
        xg, yg = np.meshgrid(px, py)
        x_cam, y_cam = pixel_camera_coords(options, xg.ravel(), yg.ravel())
        n = x_cam.size
        pad = (-n) % dp
        if pad:
            x_cam = np.concatenate([x_cam, np.zeros(pad, np.float32)])
            y_cam = np.concatenate([y_cam, np.zeros(pad, np.float32)])
        xj = jnp.asarray(x_cam, jnp.float32)
        yj = jnp.asarray(y_cam, jnp.float32)

        def _single(k, spp):
            return render_chunk_sharded(
                scene, camera, options, mesh, xj, yj, k, spp
            )

        def _batched(k, spp_batch, kb):
            return render_chunk_batched_sharded(
                scene, camera, options, mesh, xj, yj, k, spp_batch, kb
            )

        tile = render_tile(
            scene, camera, options, xj, yj, tile_keys[i],
            chunk_fns=(_single, _batched),
        )
        image[y0 : y0 + rows] = (
            np.asarray(tile)[:n].reshape(rows, w, 4).astype(np.float32)
        )
        if progress_callback is not None:
            progress_callback(i + 1, n_tiles)

    return image
