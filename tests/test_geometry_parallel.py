"""Geometry-parallel (primitive-sharded) intersection and rendering on the
8-virtual-device CPU mesh — the TP/EP analog for scenes whose intersection
tables exceed one device's memory (no reference analog: the reference shares one
Scene across its pthread pool, src/worker.cpp:364-387)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from cpupathtrace_tpu import RenderOptions
from cpupathtrace_tpu.models.scenes import bench_camera, bench_dragon_scene
from cpupathtrace_tpu.ops.intersect import scene_intersect
from cpupathtrace_tpu.parallel.geometry import (
    gp_in_specs,
    make_gp_mesh,
    render_gp,
    shard_scene_geometry,
)


@pytest.fixture(scope="module")
def setup(cpu_devices):
    scene = bench_dragon_scene(dragon_tris=2000, accel="sweep")
    cam = bench_camera()
    opts = RenderOptions(12, 12, 4, 4, epsilon=1e-3, max_depth=6)
    return scene, cam, opts


def _random_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_gp_intersect_exact(setup, cpu_devices):
    """Sharded nearest-hit == unsharded nearest-hit, bit-exact: per-shard
    sweeps are exact over their cluster subset and the pmin combine takes
    the global min (ties broken toward the smaller prim id — the dragon's
    generic triangles produce none)."""
    scene, _, _ = setup
    mesh = make_gp_mesh(cpu_devices[:4])
    sc = shard_scene_geometry(scene, 4)
    o, d = _random_rays(512)

    fn = jax.shard_map(
        lambda s, o, d: scene_intersect(s, o, d),
        mesh=mesh,
        in_specs=(gp_in_specs(sc), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    t_gp, p_gp = jax.jit(fn)(sc, o, d)
    t_ref, p_ref = jax.jit(
        lambda o, d: scene_intersect(scene, o, d)
    )(o, d)
    np.testing.assert_array_equal(np.asarray(t_gp), np.asarray(t_ref))
    np.testing.assert_array_equal(np.asarray(p_gp), np.asarray(p_ref))
    assert int((np.asarray(p_gp) >= 0).sum()) > 100  # the query hits things


def test_gp_render_shard_invariant(setup, cpu_devices):
    """The full wavefront render is bit-identical on 1-way and 4-way
    geometry shardings: the combined hits are identical, so the replicated
    estimator draws identical sample streams."""
    scene, cam, opts = setup
    img1 = render_gp(scene, cam, opts, make_gp_mesh(cpu_devices[:1]), seed=3)
    img4 = render_gp(scene, cam, opts, make_gp_mesh(cpu_devices[:4]), seed=3)
    assert img1.shape == (12, 12, 4)
    np.testing.assert_array_equal(img1, img4)
    assert img1[..., 3].mean() == 1.0  # closed box: every sample collected
    assert img1[..., :3].mean() > 0.005


def test_gp_rejects_binned_scene(cpu_devices):
    scene = bench_dragon_scene(dragon_tris=2000, accel="binned")
    with pytest.raises(ValueError, match="big-triangle partition"):
        shard_scene_geometry(scene, 4)


def test_gp_cluster_padding(setup, cpu_devices):
    """Cluster counts not divisible by the axis are padded with void
    clusters (blk_prim = -1, inverted bounds)."""
    scene, _, _ = setup
    c = scene.blk_lo.shape[0]
    n = 7 if c % 7 else 5
    sc = shard_scene_geometry(scene, n)
    assert sc.blk_lo.shape[0] % n == 0
    assert sc.gp_axis == "gp"
    pad = sc.blk_prim[c:]
    assert bool((pad < 0).all())
