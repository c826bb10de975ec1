"""Film: sample accumulation, adaptive sampling, and the render driver.

Batched recast of the reference's per-pixel adaptive loop
(ref: src/worker.cpp:149-322 processItem): instead of each pixel sequentially
drawing samples until its own stopping rule fires, the driver launches
*chunks* of `stats_sample_count` samples for a whole pixel tile at once and
applies the stopping rule per pixel between chunks. A chunk mean is exactly
one of the reference's Welford "stats samples" (ref: worker.cpp:200-232);
accepted pixels freeze (stop accumulating), reproducing the early-`break`.

Deliberate deviation (documented): the reference counts only *collected*
(anything-hit) samples toward its statistics batches (ref: worker.cpp:197).
Chunked SPMD execution counts per-chunk collected means instead; identical in
closed scenes, and statistically equivalent elsewhere.

The biased candidate-selection fallback (ref: worker.cpp:273-317) only runs
when `RenderOptions.allow_bias=True` — the reference declares that flag but
never reads it (its biased path always runs); here the flag is honest.

Tiling: the image is processed in equally-sized pixel tiles to bound rays per
device launch — the analog of the reference's work-queue of 32x32 tiles
(ref: worker.cpp:398-414), except tiles are data-parallel lanes rather than
work items for a thread pool (the device mesh shards them; see
cpupathtrace_tpu/parallel).
"""
from __future__ import annotations

import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..camera.camera import Camera, shoot_rays
from ..core.config import RenderOptions
from ..scene.scene import SceneData
from ..utils.math import sqrt
from .wavefront import trace


def pixel_camera_coords(options: RenderOptions, px, py):
    """Pixel index -> [-1,1] sensor coordinates, y flipped
    (ref: worker.cpp:166-171)."""
    x_cam = 2.0 * ((px + 0.5) / options.image_width - 0.5)
    y_cam = -2.0 * ((py + 0.5) / options.image_height - 0.5)
    return x_cam, y_cam


def adaptive_constants(options: RenderOptions):
    """The reference's adaptive-sampling batch constants, integer-division
    semantics preserved (ref: worker.cpp:158-163)."""
    min_sc = options.min_sample_count
    max_sc = options.max_sample_count
    stats = min(max(min_sc // 4, 1), 64)
    candidate_batch = max(max(min_sc, max_sc // 4) // stats, 2)
    check = (
        min(max(min_sc // 2, (max_sc - min_sc) // 8, 8, stats), 1024) // stats
    )
    return stats, candidate_batch, check


def morton_perm(px: np.ndarray, py: np.ndarray) -> np.ndarray:
    """Permutation sorting integer pixel coords into Morton (Z-curve) order.

    Passed as `render_chunk(pixel_order=...)`, it launches rays pixel-major
    in Morton order, so consecutive rays form compact pixel tiles x spp
    samples — the tightest primary frustum per block of rays."""
    px = np.asarray(px, np.int64)
    py = np.asarray(py, np.int64)
    # 16 interleaved bits per axis: coords >= 2^16 would silently alias.
    if px.size and (px.max() >= 1 << 16 or py.max() >= 1 << 16):
        raise ValueError("morton_perm supports pixel coordinates < 65536")
    code = np.zeros_like(px)
    for b in range(16):
        code |= ((px >> b) & 1) << (2 * b)
        code |= ((py >> b) & 1) << (2 * b + 1)
    return np.argsort(code, kind="stable")


@partial(jax.jit, static_argnames=("options", "spp", "differentiable"))
def render_chunk(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    x_cam: jnp.ndarray,  # [P] sensor coords of the tile's pixels
    y_cam: jnp.ndarray,  # [P]
    key,
    spp: int,
    differentiable: bool = False,
    pixel_order=None,  # [P] i32 permutation (see morton_perm) or None
):
    """Trace `spp` samples for P pixels; returns (sum [P,4], collected [P]).

    With `pixel_order`, rays launch PIXEL-MAJOR over the permuted pixel
    list (each pixel's spp samples adjacent) and the sums are scattered
    back, so results are positionally identical to the unpermuted call
    (the RNG pairing differs — same estimator, different stream)."""
    p = x_cam.shape[0]
    if pixel_order is not None:
        xs = jnp.repeat(x_cam[pixel_order], spp)
        ys = jnp.repeat(y_cam[pixel_order], spp)
    else:
        xs = jnp.tile(x_cam, spp)
        ys = jnp.tile(y_cam, spp)
    k_cam, k_trace = jax.random.split(key)
    rays = shoot_rays(
        camera, xs, ys, 1.0 / options.image_width, 1.0 / options.image_height, k_cam
    )
    spectrum, collected = trace(scene, rays, options, k_trace, differentiable)
    if pixel_order is not None:
        spectrum = spectrum.reshape(p, spp, 4)
        collected = collected.reshape(p, spp)
        s = jnp.sum(jnp.where(collected[..., None], spectrum, 0.0), axis=1)
        c = jnp.sum(collected.astype(jnp.int32), axis=1)
        return (
            jnp.zeros_like(s).at[pixel_order].set(s),
            jnp.zeros_like(c).at[pixel_order].set(c),
        )
    spectrum = spectrum.reshape(spp, p, 4)
    collected = collected.reshape(spp, p)
    return (
        jnp.sum(jnp.where(collected[..., None], spectrum, 0.0), axis=0),
        jnp.sum(collected.astype(jnp.int32), axis=0),
    )


@partial(jax.jit, static_argnames=("options", "spp_batch", "k_batches"))
def render_chunk_batched(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    x_cam: jnp.ndarray,
    y_cam: jnp.ndarray,
    key,
    spp_batch: int,
    k_batches: int,
    pixel_order=None,
):
    """`k_batches` adaptive stats batches in ONE device launch: renders
    k_batches * spp_batch samples and returns per-batch
    (sums [K, P, 4], counts [K, P]) so the host-side adaptive driver
    launches K times fewer programs (each launch costs dispatch + sync
    on the host). k_batches=1 is bitwise identical to
    render_chunk(spp=spp_batch)."""
    p = x_cam.shape[0]
    spp = spp_batch * k_batches
    if pixel_order is not None:
        xs = jnp.repeat(x_cam[pixel_order], spp)
        ys = jnp.repeat(y_cam[pixel_order], spp)
    else:
        xs = jnp.tile(x_cam, spp)
        ys = jnp.tile(y_cam, spp)
    k_cam, k_trace = jax.random.split(key)
    rays = shoot_rays(
        camera, xs, ys, 1.0 / options.image_width,
        1.0 / options.image_height, k_cam,
    )
    spectrum, collected = trace(scene, rays, options, k_trace)
    if pixel_order is not None:
        # Pixel-major: [P, K, spp_batch] sample groups per pixel.
        spectrum = spectrum.reshape(p, k_batches, spp_batch, 4)
        collected = collected.reshape(p, k_batches, spp_batch)
        s = jnp.sum(jnp.where(collected[..., None], spectrum, 0.0), axis=2)
        c = jnp.sum(collected.astype(jnp.int32), axis=2)
        s = jnp.moveaxis(s, 0, 1)  # [K, P, 4]
        c = jnp.moveaxis(c, 0, 1)  # [K, P]
        inv = jnp.zeros_like(pixel_order).at[pixel_order].set(
            jnp.arange(p, dtype=pixel_order.dtype)
        )
        return s[:, inv], c[:, inv]
    spectrum = spectrum.reshape(k_batches, spp_batch, p, 4)
    collected = collected.reshape(k_batches, spp_batch, p)
    return (
        jnp.sum(jnp.where(collected[..., None], spectrum, 0.0), axis=1),
        jnp.sum(collected.astype(jnp.int32), axis=1),
    )


@partial(jax.jit, static_argnames=("kb", "min_sc", "check"))
def _apply_stats_batches(s_b, coll_b, c0, pixel_sum, n_collected, frozen,
                         accepted, remaining, stats_means, stats_valid,
                         kb, min_sc, check):
    """Sequentially fold `kb` stats-batch results into the adaptive state
    (same per-batch logic the unfused loop ran between launches —
    ref: worker.cpp:200-259 Welford batches + consecutive-pass rule).
    Returns the updated state plus the all-frozen early-break flag."""
    for j in range(kb):
        s = s_b[j]
        coll = coll_b[j]
        c = c0 + j
        live = ~frozen
        pixel_sum = jnp.where(live[:, None], pixel_sum + s, pixel_sum)
        n_collected = jnp.where(live, n_collected + coll, n_collected)
        chunk_mean = s / jnp.maximum(coll, 1)[:, None]
        chunk_ok = live & (coll > 0)
        stats_means = jax.lax.dynamic_update_index_in_dim(
            stats_means, jnp.where(chunk_ok[:, None], chunk_mean, 0.0), c, 1
        )
        stats_valid = jax.lax.dynamic_update_index_in_dim(
            stats_valid, chunk_ok, c, 1
        )

        ns = jnp.sum(stats_valid, axis=1)
        safe_ns = jnp.maximum(ns, 1)
        mean = jnp.sum(
            jnp.where(stats_valid[..., None], stats_means, 0.0), axis=1
        ) / safe_ns[:, None]
        dev = jnp.where(
            stats_valid[..., None], stats_means - mean[:, None, :], 0.0
        )
        m2 = jnp.sum(dev * dev, axis=1)
        m2w = m2 / jnp.maximum(ns - 1, 1)[:, None]
        stddev = sqrt(m2w[..., 0] + m2w[..., 1] + m2w[..., 2])
        mean_contrib = (mean[..., 0] + mean[..., 1] + mean[..., 2]) / 3.0

        checkable = live & (n_collected >= min_sc) & (ns >= 2)
        passed = checkable & (
            (stddev < 1e-4)
            | (stddev / (3.0 * 3.0 * mean_contrib + 1e-5) < 0.2)
        )
        remaining = jnp.where(
            passed, remaining - 1, jnp.where(checkable, check, remaining)
        )
        newly_accepted = passed & (remaining <= 0)
        accepted = accepted | newly_accepted
        frozen = frozen | newly_accepted
    return (pixel_sum, n_collected, frozen, accepted, remaining,
            stats_means, stats_valid, jnp.all(frozen | accepted))


def _candidate_select(stats_means, stats_valid, cbc, fallback, min_count):
    """Biased candidate selection (ref: worker.cpp:273-317), vectorized.

    stats_means: [P, NS, 4] per-stats-batch means; stats_valid: [P, NS].
    Candidates are consecutive groups of `cbc` stats batches. Returns [P,4].
    """
    p, ns, _ = stats_means.shape
    n_cand = math.ceil(ns / cbc)
    pad = n_cand * cbc - ns
    if pad:
        stats_means = jnp.pad(stats_means, ((0, 0), (0, pad), (0, 0)))
        stats_valid = jnp.pad(stats_valid, ((0, 0), (0, pad)))
    g_means = stats_means.reshape(p, n_cand, cbc, 4)
    g_valid = stats_valid.reshape(p, n_cand, cbc)

    count = jnp.sum(g_valid, axis=-1)  # [P, C]
    safe = jnp.maximum(count, 1)
    mean = jnp.sum(jnp.where(g_valid[..., None], g_means, 0.0), axis=2) / safe[..., None]
    dev = jnp.where(g_valid[..., None], g_means - mean[:, :, None, :], 0.0)
    m2 = jnp.sum(dev * dev, axis=2)  # [P, C, 4]
    # m2_weighted = m2 / count; stddev over the RGB channels
    # (ref: worker.cpp:287-290).
    m2w = m2 / safe[..., None]
    stddev = sqrt(m2w[..., 0] + m2w[..., 1] + m2w[..., 2])

    valid = count >= min_count
    stddev = jnp.where(valid, stddev, jnp.inf)

    order = jnp.argsort(stddev, axis=1)
    s_sorted = jnp.take_along_axis(stddev, order, axis=1)
    c_sorted = jnp.take_along_axis(mean, order[..., None], axis=1)

    any_valid = jnp.isfinite(s_sorted[:, 0])
    pixel = c_sorted[:, 0]
    cur_s = s_sorted[:, 0]
    still = any_valid
    # Near-tie progressive averaging (ref: worker.cpp:296-316).
    for i in range(1, n_cand):
        ok = still & (s_sorted[:, i] < jnp.maximum(cur_s + 0.005, cur_s * 1.01))
        pixel = jnp.where(
            ok[:, None], pixel + (c_sorted[:, i] - pixel) / (i + 1.0), pixel
        )
        cur_s = jnp.where(ok, s_sorted[:, i], cur_s)
        still = ok
    return jnp.where(any_valid[:, None], pixel, fallback)


def render_tile(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    x_cam: np.ndarray,
    y_cam: np.ndarray,
    key,
    pixel_order=None,
    chunk_fns=None,
) -> jnp.ndarray:
    """Adaptive render of one pixel tile; returns [P,4] pixel values.

    `chunk_fns`, when given, is a pair `(single, batched)` replacing the
    default single-device chunk renderers — `single(key, spp) -> (sum [P,4],
    collected [P])` and `batched(key, spp_batch, kb) -> ([K,P,4], [K,P])` —
    so the SPMD driver (parallel/render.py) runs the IDENTICAL adaptive
    stopping rule (Welford stats batches + consecutive-pass accept +
    candidate selection) over sharded chunk launches."""
    p = x_cam.shape[0]
    stats, cbc, check = adaptive_constants(options)
    min_sc = max(options.min_sample_count, 2)
    max_sc = options.max_sample_count
    n_full = max_sc // stats
    remainder = max_sc - n_full * stats

    pixel_sum = jnp.zeros((p, 4))
    n_collected = jnp.zeros(p, jnp.int32)
    frozen = jnp.zeros(p, bool)
    accepted = jnp.zeros(p, bool)
    remaining = jnp.full(p, check, jnp.int32)
    stats_means = jnp.zeros((p, max(n_full, 1), 4))
    stats_valid = jnp.zeros((p, max(n_full, 1)), bool)

    # LAUNCH FUSION: render PTX_ADAPTIVE_FUSE stats batches per device
    # launch (render_chunk_batched) and fold their per-batch sums into the
    # adaptive state with ONE jitted update (_apply_stats_batches) — the
    # per-batch freeze/accept semantics are applied sequentially inside
    # it, so the estimator is unchanged while the demo's 16-64 spp config
    # drops from 16 launches to 4. Fuse=1 reproduces the unfused RNG
    # stream bitwise. (Read per call, not hoisted: tests monkeypatch it.)
    fuse = max(1, int(os.environ.get("PTX_ADAPTIVE_FUSE", "4")))

    if chunk_fns is None:
        def _single(k, spp):
            return render_chunk(scene, camera, options, x_cam, y_cam, k,
                                spp, pixel_order=pixel_order)

        def _batched(k, spp_batch, kb):
            return render_chunk_batched(scene, camera, options, x_cam,
                                        y_cam, k, spp_batch, kb,
                                        pixel_order=pixel_order)
    else:
        _single, _batched = chunk_fns

    # Early-break flags are consumed LAGGED: launch L's all-frozen scalar
    # is checked only after launch L+K was enqueued, so the device keeps
    # K launches in flight while the flag's device->host round trip
    # rides under their compute.
    # Worst case K extra launches run after convergence — frozen pixels
    # no longer accumulate, so the output is bitwise unchanged.
    flag_lag = 3 if fuse == 1 else 1
    pending_flags: list = []

    n_launches = math.ceil(n_full / fuse) if n_full else 0
    keys = jax.random.split(key, n_full + 1)
    c0 = 0
    for li in range(n_launches):
        kb = min(fuse, n_full - c0)
        if kb == 1:
            s, coll = _single(keys[li], stats)
            s_b, coll_b = s[None], coll[None]
        else:
            s_b, coll_b = _batched(keys[li], stats, kb)
        (pixel_sum, n_collected, frozen, accepted, remaining,
         stats_means, stats_valid, flag) = _apply_stats_batches(
            s_b, coll_b, jnp.int32(c0), pixel_sum, n_collected, frozen,
            accepted, remaining, stats_means, stats_valid,
            kb=kb, min_sc=min_sc, check=check,
        )
        c0 += kb

        # Early break saves whole launches only in adaptive mode; for
        # fixed-spp renders skip the flags entirely. The host check is
        # PIPELINED (see flag_lag above): enqueue this launch's flag
        # asynchronously, consume the one from K launches ago.
        if max_sc > min_sc and c0 >= (min_sc // stats):
            try:
                flag.copy_to_host_async()
            except AttributeError:  # non-jax.Array backends (tracing)
                pass
            pending_flags.append(flag)
            if len(pending_flags) > flag_lag and bool(pending_flags.pop(0)):
                break

    if remainder > 0:
        s, coll = _single(keys[n_full], remainder)
        live = ~frozen
        pixel_sum = jnp.where(live[:, None], pixel_sum + s, pixel_sum)
        n_collected = jnp.where(live, n_collected + coll, n_collected)

    pixel_value = pixel_sum / jnp.maximum(n_collected, 1)[:, None]

    if options.allow_bias:
        min_count = max((cbc * 3) // 4, 2)
        biased = _candidate_select(stats_means, stats_valid, cbc, pixel_value, min_count)
        pixel_value = jnp.where(accepted[:, None], pixel_value, biased)

    # Pixels that never collected anything stay exactly zero
    # (ref: worker.cpp:261-263 + alpha contract).
    pixel_value = jnp.where((n_collected > 0)[:, None], pixel_value, 0.0)
    return pixel_value


def render(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    seed: int = 0,
    progress_callback=None,
    rays_per_launch: int = 1 << 20,
) -> np.ndarray:
    """Full-frame render — the processJob analog (ref: worker.cpp:389-427).

    Returns an [H, W, 4] float32 image (RGB radiance + any-hit alpha).
    """
    w, h = options.image_width, options.image_height
    if w <= 0 or h <= 0:
        return np.zeros((max(h, 0), max(w, 0), 4), np.float32)

    stats, _, _ = adaptive_constants(options)
    rows_per_tile = max(1, min(h, rays_per_launch // max(w * stats, 1)))
    n_tiles = math.ceil(h / rows_per_tile)

    px = np.arange(w, dtype=np.float32)
    image = np.zeros((h, w, 4), np.float32)
    key = jax.random.PRNGKey(seed)
    tile_keys = jax.random.split(key, n_tiles)

    for i in range(n_tiles):
        y0 = i * rows_per_tile
        rows = min(rows_per_tile, h - y0)  # exact tail tile: no overlap,
        # no re-rendered rows (ref: worker.cpp:398-414 tiles are disjoint);
        # a non-divisible height costs one extra jit specialization.
        py = np.arange(y0, y0 + rows, dtype=np.float32)
        xg, yg = np.meshgrid(px, py)
        x_cam, y_cam = pixel_camera_coords(options, xg.ravel(), yg.ravel())
        tile = render_tile(
            scene, camera, options,
            jnp.asarray(x_cam, jnp.float32), jnp.asarray(y_cam, jnp.float32),
            tile_keys[i],
        )
        image[y0 : y0 + rows] = np.asarray(tile).reshape(rows, w, 4)
        if progress_callback is not None:
            progress_callback(i + 1, n_tiles)

    return image
