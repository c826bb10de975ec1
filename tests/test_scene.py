"""Scene-level intersection tests (ref: test/scene/scene_test.cpp) plus
BVH-vs-dense equivalence on randomized geometry."""
import jax
import jax.numpy as jnp
import numpy as np

from cpupathtrace_tpu.ops.intersect import bvh_intersect, dense_intersect, scene_intersect
from cpupathtrace_tpu.scene.scene import SceneBuilder


def two_sphere_scene(use_bvh):
    b = SceneBuilder()
    b.add_sphere((-1.0, -1.0, -1.0), 1.0)
    b.add_sphere((1.0, 1.0, 1.0), 1.0)
    return b.build(use_bvh=use_bvh)


def test_two_sphere_nearest_hit():
    for use_bvh in (False, True):
        scene = two_sphere_scene(use_bvh)
        o = jnp.array(
            [
                [-0.5, -0.5, -5.0],
                [0.5, 0.5, -5.0],
                [0.0, 0.0, 0.0],
            ]
        )
        d = jnp.array([[0.0, 0.0, 1.0]] * 3)
        t, prim = scene_intersect(scene, o, d)
        # Ray 0 hits sphere 1 (prim index n_tri+0), ray 1 hits sphere 2.
        assert float(t[0]) >= 0.0
        assert int(prim[0]) == scene.n_tri + 0
        assert float(t[1]) >= 0.0
        assert int(prim[1]) == scene.n_tri + 1
        # Ray from the origin: both spheres "behind"/tangent -> miss
        # (ref: scene_test.cpp:44-47).
        assert float(t[2]) < 0.0


def _random_tri_scene(n_tri, seed, use_bvh):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    from cpupathtrace_tpu.scene.geometry import HostTriangle

    centers = rng.uniform(-2, 2, size=(n_tri, 3))
    tris = []
    for c in centers:
        verts = c + rng.uniform(-0.3, 0.3, size=(3, 3))
        tris.append(HostTriangle(verts[0], verts[1], verts[2]))
    b.add_triangles(tris, material=0)
    return b.build(use_bvh=use_bvh)


def test_bvh_matches_dense_random_triangles():
    scene_b = _random_tri_scene(64, seed=3, use_bvh=True)
    scene_d = _random_tri_scene(64, seed=3, use_bvh=False)

    rng = np.random.default_rng(17)
    n_rays = 256
    o = jnp.asarray(rng.uniform(-4, 4, size=(n_rays, 3)), jnp.float32)
    d = rng.normal(size=(n_rays, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)

    t_b, p_b = bvh_intersect(scene_b, o, d)
    t_d, p_d = dense_intersect(scene_d, o, d)

    np.testing.assert_allclose(np.asarray(t_b), np.asarray(t_d), rtol=1e-4, atol=1e-5)
    # Primitive ids agree except where two hits tie within float noise.
    mismatch = np.asarray(p_b) != np.asarray(p_d)
    assert mismatch.mean() < 0.02


def test_bvh_matches_dense_mixed_primitives():
    b1, b2 = SceneBuilder(), SceneBuilder()
    from cpupathtrace_tpu.scene.geometry import make_box

    for b in (b1, b2):
        b.add_triangles(make_box((-1, -1, -1), (1, 1, 1)))
        b.add_sphere((0.0, 0.0, 0.0), 0.5)
        b.add_sphere((2.0, 0.0, 0.0), 0.25)
    sb = b1.build(use_bvh=True)
    sd = b2.build(use_bvh=False)

    rng = np.random.default_rng(5)
    o = jnp.asarray(rng.uniform(-3, 3, size=(128, 3)), jnp.float32)
    d = rng.normal(size=(128, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    t_b, p_b = bvh_intersect(sb, o, d)
    t_d, p_d = dense_intersect(sd, o, d)
    np.testing.assert_allclose(np.asarray(t_b), np.asarray(t_d), rtol=1e-4, atol=1e-5)


def test_emissive_registry():
    """Emissive CDF: power = (r+g+b)*a*area, normalized inclusive prefix sums
    (ref: src/scene/scene.cpp:183-208)."""
    from cpupathtrace_tpu.scene.geometry import make_plane

    b = SceneBuilder()
    m_dim = b.add_material(emission=(1.0, 0.0, 0.0, 1.0))  # power density 1
    m_bright = b.add_material(emission=(1.0, 1.0, 1.0, 1.0))  # power density 3
    # Equal-area unit planes (2 triangles each).
    b.add_triangles(make_plane((0, 0, 0), (1, 0, 1)), m_dim)
    b.add_triangles(make_plane((0, 2, 0), (1, 2, 1)), m_bright)
    scene = b.build()
    assert scene.n_emissive == 4
    cdf = np.asarray(scene.emissive_cdf[:4])
    np.testing.assert_allclose(cdf[-1], 1.0, rtol=1e-6)
    # Triangle powers: 0.5*1, 0.5*1, 0.5*3, 0.5*3 -> cdf 0.125, 0.25, 0.625, 1.
    np.testing.assert_allclose(cdf, [0.125, 0.25, 0.625, 1.0], rtol=1e-5)
    # Sample count: min(2 + log10(4+1), 4) = 2 (ref: scene.cpp:226).
    assert scene.emissive_sample_count == 2


def test_empty_scene_builds_and_misses():
    scene = SceneBuilder().build()
    t, prim = scene_intersect(scene, jnp.zeros((4, 3)), jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (4, 1)))
    assert bool(jnp.all(t < 0))
    assert bool(jnp.all(prim < 0))


def test_cluster_matches_dense_mixed():
    """Two-level cluster accel must agree with dense."""
    from cpupathtrace_tpu.ops.intersect import cluster_intersect
    from cpupathtrace_tpu.scene.geometry import HostTriangle

    def build(accel):
        rng = np.random.default_rng(11)
        b = SceneBuilder()
        tris = []
        for c in rng.uniform(-2, 2, (300, 3)):
            v = c + rng.uniform(-0.3, 0.3, (3, 3))
            tris.append(HostTriangle(v[0], v[1], v[2]))
        b.add_triangles(tris, 0)
        b.add_sphere((0.0, 0.0, 0.0), 0.4)
        b.add_sphere((1.5, 0.0, 0.0), 0.2)
        return b.build(accel=accel, cluster_size=32)

    sc = build("cluster")
    sd = build("dense")
    assert sc.accel == "cluster"
    rng = np.random.default_rng(12)
    o = jnp.asarray(rng.uniform(-4, 4, (512, 3)), jnp.float32)
    d = rng.normal(size=(512, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    tc, pc = cluster_intersect(sc, o, d)
    td, pd = scene_intersect(sd, o, d)
    np.testing.assert_allclose(np.asarray(tc), np.asarray(td), rtol=1e-4, atol=1e-5)
    mismatch = np.asarray(pc) != np.asarray(pd)
    assert mismatch.mean() < 0.02


def test_cluster_render_matches_dense_render():
    """Full wavefront render through the cluster intersector agrees with the
    dense intersector statistically (same estimator, different accel)."""
    import jax as _jax
    from cpupathtrace_tpu import RenderOptions, make_camera
    from cpupathtrace_tpu.integrator.film import pixel_camera_coords, render_chunk
    from tests.scenes_util import inward_box_scene

    # Rebuild the inward box with the cluster accel forced.
    from cpupathtrace_tpu.scene.geometry import make_plane

    def build(accel):
        b = SceneBuilder()
        white = b.add_material(diffuse=(1, 1, 1, 1))
        light = b.add_material(diffuse=(1, 1, 1, 1), emission=(1, 1, 1, 1))
        b.add_triangles(make_plane((1, -1, -1), (-1, -1, 1), True), white)
        b.add_triangles(make_plane((-1, 1, -1), (1, 1, 1), True), white)
        b.add_triangles(make_plane((-0.25, 0.99, -0.25), (0.25, 0.99, 0.25), True), light)
        b.add_triangles(make_plane((-1, -1, -1), (1, 1, -1), True), white)
        b.add_triangles(make_plane((-1, -1, -1), (-1, 1, 1), True), white)
        b.add_triangles(make_plane((1, -1, 1), (-1, 1, 1), True), white)
        b.add_triangles(make_plane((1, -1, 1), (1, 1, -1), True), white)
        return b.build(accel=accel, cluster_size=4)

    cam = make_camera((0, 0, 0), (0, 0, 0.9), (0, 1, 0))
    opts = RenderOptions(8, 8, 32, 32, max_depth=6)
    xg, yg = np.meshgrid(np.arange(8, dtype=np.float32), np.arange(8, dtype=np.float32))
    x_cam, y_cam = pixel_camera_coords(opts, xg.ravel(), yg.ravel())
    x_cam = jnp.asarray(x_cam, jnp.float32)
    y_cam = jnp.asarray(y_cam, jnp.float32)
    means = {}
    for accel in ("cluster", "dense"):
        s, c = render_chunk(build(accel), cam, opts, x_cam, y_cam,
                            _jax.random.PRNGKey(0), 32)
        means[accel] = float(np.median(np.asarray(s)[:, :3]))
        assert (np.asarray(c) == 32).all()
    a, b = means["cluster"], means["dense"]
    assert abs(a - b) / max(a, b) < 0.4, means


def test_triangle_batch_build_bit_identical():
    """The columnar TriangleBatch fast path (load_mesh(as_batch=True) +
    vectorized SceneBuilder packing/emissive registry) produces a SceneData
    bit-identical to the historical HostTriangle-list path, across mixed
    geometry, transforms, emissive triangles/spheres, and the binned accel
    tables."""
    import dataclasses

    from cpupathtrace_tpu.models.scenes import standin_dragon_obj
    from cpupathtrace_tpu.scene.geometry import (
        make_box,
        make_plane,
        transform_triangles,
    )
    from cpupathtrace_tpu.scene.mesh import load_mesh
    from cpupathtrace_tpu.scene.scene import BSDF_GLASS, BSDF_MIRROR

    obj = standin_dragon_obj(2000)
    tf = np.array(
        [[0.01, 0, 0, 0], [0, 0.01, 0, -0.5], [0, 0, 0.01, 0], [0, 0, 0, 1.0]]
    )
    rot = np.array(
        [[0.9, 0, 0.1, 0], [0, 2.0, 0, 0], [-0.1, 0, 0.9, 0], [0, 0, 0, 1.0]]
    )

    def build(as_batch):
        b = SceneBuilder()
        white = b.add_material(diffuse=(1, 1, 1, 1))
        light = b.add_material(diffuse=(1, 1, 1, 1), emission=(1, 2, 3, 1))
        glass = b.add_material(diffuse=(1, 1, 1, 1), ior=1.5, bsdf=BSDF_GLASS)
        em2 = b.add_material(diffuse=(1, 1, 1, 1), emission=(0.5, 0.5, 0.5, 1))
        b.add_triangles(make_box((-1, -1, -1), (1, 1, 1)), white)
        b.add_triangles(
            make_plane((-0.25, 0.99, -0.25), (0.25, 0.99, 0.25), True), light
        )
        b.add_triangles(
            load_mesh(obj, tf, cull_backface=False, smooth=True,
                      as_batch=as_batch),
            glass,
        )
        b.add_triangles(
            transform_triangles(
                load_mesh(obj, tf, cull_backface=False, smooth=True,
                          as_batch=as_batch),
                rot,
            ),
            em2,
        )
        mirror = b.add_material(diffuse=(0, 0, 1, 1), bsdf=BSDF_MIRROR)
        b.add_sphere((0.5, -0.5, 0.5), 0.5, mirror)
        b.add_sphere((0, 0.5, 0), 0.2, em2)
        b.add_point_light((0, 0, 0), (1, 1, 1, 1))
        return b.build(accel="binned", cluster_size=128)

    s_list = build(False)
    s_batch = build(True)
    for f in dataclasses.fields(type(s_list)):
        a = getattr(s_list, f.name)
        c = getattr(s_batch, f.name)
        if hasattr(a, "shape"):
            assert a.shape == c.shape, f.name
            assert bool((np.asarray(a) == np.asarray(c)).all()), f.name
        else:
            assert a == c, f.name


def test_cluster_cut_matches_sequential_reference():
    """The level-swept vectorized cluster cut (accel/cluster.py) emits
    exactly the clusters of the original sequential walk: same DFS order,
    same members, same bounds (DFS emission order keeps spatially adjacent
    clusters adjacent in the tables)."""
    from cpupathtrace_tpu.accel.build import build_bvh
    from cpupathtrace_tpu.accel.cluster import build_cluster_bvh

    def reference_cut(prim_lo, prim_hi, cluster_size, use_native):
        base = build_bvh(prim_lo, prim_hi, use_native=use_native)
        n_nodes = base.prim.shape[0]
        size = np.where(base.prim >= 0, 1, 0).astype(np.int64)
        for i in range(n_nodes - 1, -1, -1):
            if base.prim[i] < 0:
                size[i] = size[base.left[i]] + size[base.right[i]]

        def leaves_under(node):
            out, stack = [], [node]
            while stack:
                k = stack.pop()
                if base.prim[k] >= 0:
                    out.append(base.prim[k])
                else:
                    stack.append(base.right[k])
                    stack.append(base.left[k])
            return np.asarray(out, np.int64)

        clusters = []
        stack = [0]
        while stack:
            k = stack.pop()
            if size[k] <= cluster_size or base.prim[k] >= 0:
                clusters.append(leaves_under(k))
            else:
                stack.append(base.right[k])
                stack.append(base.left[k])
        c = len(clusters)
        members = np.full((c, cluster_size), -1, np.int32)
        c_lo = np.empty((c, 3), np.float32)
        c_hi = np.empty((c, 3), np.float32)
        for i, idx in enumerate(clusters):
            members[i, : idx.shape[0]] = idx
            c_lo[i] = prim_lo[idx].min(axis=0)
            c_hi[i] = prim_hi[idx].max(axis=0)
        return members, c_lo, c_hi

    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 7, 64, 701):
        for cs in (1, 4, 64):
            ctr = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
            ext = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
            lo, hi = ctr - ext, ctr + ext
            for native in (False, True):
                m_r, lo_r, hi_r = reference_cut(lo, hi, cs, native)
                cl = build_cluster_bvh(lo, hi, cluster_size=cs,
                                       use_native=native)
                assert np.array_equal(cl.members, m_r), (n, cs, native)
                assert np.array_equal(cl.c_lo, lo_r), (n, cs, native)
                assert np.array_equal(cl.c_hi, hi_r), (n, cs, native)
