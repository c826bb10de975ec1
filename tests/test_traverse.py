"""Binned layout (dense big-triangle set + sweep over the cluster blocks,
ops/intersect.py binned_intersect_ref): partition, exactness against
brute-force dense intersection, and the builder's cluster coarsening.
Nearest-hit comparisons accept prim mismatches only at exact t ties (two
triangles sharing the winning distance are both correct answers, matching
the reference's traversal-order-dependent tie behavior).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cpupathtrace_tpu.models.scenes import bench_dragon_scene
from cpupathtrace_tpu.ops.intersect import (
    binned_intersect_ref,
    dense_intersect,
    scene_intersect,
)


@pytest.fixture(scope="module")
def dragon_scene():
    return bench_dragon_scene(dragon_tris=1500, accel="binned", cluster_size=64)


def _rays(n, seed, inside=False):
    rng = np.random.default_rng(seed)
    if inside:
        o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
        o[:, 1] -= 0.5  # inside the dragon region: entry-t ties at 0
        d = rng.normal(size=(n, 3))
    else:
        o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
        o[: n // 2, 2] = -2.8
        tgt = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
        tgt[:, 1] -= 0.5
        d = tgt - o
        d[n // 2:] = rng.normal(size=(n - n // 2, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def _agree(tk, pk, tr, pr, mask=None):
    tk, pk, tr, pr = map(np.asarray, (tk, pk, tr, pr))
    same = (pk == pr) | (tk == tr)
    if mask is not None:
        same = same[np.asarray(mask)]
    return same.all()


def test_builder_partition(dragon_scene):
    s = dragon_scene
    assert s.accel == "binned"
    assert s.n_big == 14  # 12 box triangles + 2 light-panel triangles
    assert s.blk_lo.shape[0] >= 2
    # Cluster bounds are tight around the dragon, not the room.
    assert float(np.asarray(s.blk_hi)[:, 1].max()) < 0.0
    # Every triangle is exactly once in (big set) + (cluster blocks).
    blk = np.asarray(s.blk_prim)
    big = np.asarray(s.big_prim)
    got = np.sort(np.concatenate([blk[blk >= 0], big[big >= 0]]))
    assert np.array_equal(got, np.arange(s.n_tri))


def test_ref_path_matches_dense(dragon_scene):
    o, d = _rays(1024, 0)
    dense = dataclasses.replace(dragon_scene, accel="dense")
    t_r, p_r = binned_intersect_ref(dragon_scene, o, d)
    t_d, p_d = dense_intersect(dense, o, d)
    assert _agree(t_r, p_r, t_d, p_d)
    assert int(np.sum(np.asarray(p_d) >= 0)) > 100


def test_scene_intersect_dispatch(dragon_scene):
    """accel='binned' routes through scene_intersect to the binned path."""
    o, d = _rays(256, 7)
    t, p = scene_intersect(dragon_scene, o, d)
    t_r, p_r = binned_intersect_ref(dragon_scene, o, d)
    assert _agree(t, p, t_r, p_r)


def test_wavefront_render_binned_matches_sweep():
    """End-to-end estimator parity: the same scene built binned vs sweep
    renders bit-identically on CPU (identical keys, identical nearest
    hits; only the intersector implementation differs)."""
    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.integrator.film import (
        pixel_camera_coords,
        render_chunk,
    )
    from cpupathtrace_tpu.models.scenes import bench_camera

    opts = RenderOptions(12, 12, 4, 4, epsilon=1e-3, max_depth=6)
    xg, yg = np.meshgrid(
        np.arange(12, dtype=np.float32), np.arange(12, dtype=np.float32)
    )
    x_cam, y_cam = pixel_camera_coords(opts, xg.ravel(), yg.ravel())
    key = jax.random.PRNGKey(0)
    cam = bench_camera()

    imgs = []
    for accel in ("binned", "sweep"):
        scene = bench_dragon_scene(
            dragon_tris=900, accel=accel, cluster_size=64
        )
        s, c = render_chunk(
            scene, cam, opts,
            jnp.asarray(x_cam, jnp.float32), jnp.asarray(y_cam, jnp.float32),
            key, 4,
        )
        imgs.append((np.asarray(s), np.asarray(c)))
    np.testing.assert_array_equal(imgs[0][1], imgs[1][1])
    np.testing.assert_allclose(imgs[0][0], imgs[1][0], rtol=1e-6, atol=1e-6)


def test_giant_scene_auto_coarsens(monkeypatch):
    """Beyond the cluster budget (MAX_CLUSTERS) the builder grows
    cluster_size until the cut fits, and the scene still intersects
    exactly (the 7.2M-triangle real-dragon regime, scaled down by shrinking
    the budget)."""
    from cpupathtrace_tpu.scene import scene as scene_mod

    monkeypatch.setattr(scene_mod, "MAX_CLUSTERS", 16)
    scene = bench_dragon_scene(dragon_tris=5000, accel="binned")
    assert scene.accel == "binned"
    assert scene.blk_lo.shape[0] <= 16
    assert scene.cluster_size >= 5000 // 16

    ref = bench_dragon_scene(dragon_tris=5000, accel="sweep")
    o, d = _rays(512, 11, inside=True)
    t_b, p_b = scene_intersect(scene, o, d)
    t_r, p_r = scene_intersect(ref, o, d)
    assert _agree(t_b, p_b, t_r, p_r)
