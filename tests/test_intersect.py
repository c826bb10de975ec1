"""Primitive-intersection unit tests.

Mirrors the reference's exact-value geometry tests
(ref: test/scene/boundig_box_test.cpp, test/scene/scene_test.cpp) against the
batched jnp ops.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from cpupathtrace_tpu.ops.intersect import (
    intersect_aabb,
    intersect_spheres,
    intersect_triangles,
)

SQRT2_HALF = float(np.sqrt(2.0) / 2.0)


class TestAABB:
    """Unit-sphere bounding box [-1,1]^3 slab tests
    (ref: boundig_box_test.cpp:15-48)."""

    lo = jnp.array([-1.0, -1.0, -1.0])
    hi = jnp.array([1.0, 1.0, 1.0])

    @pytest.mark.parametrize("dim", [0, 1, 2])
    def test_axis_hits(self, dim):
        axis = np.zeros(3)
        axis[dim] = 1.0
        factor = -1.0
        o = jnp.asarray(axis * factor * 5.0, jnp.float32)
        d = jnp.asarray(axis * factor * -1.0, jnp.float32)
        t = intersect_aabb(o, d, self.lo, self.hi)
        np.testing.assert_allclose(t, 4.0, rtol=1e-6)

    @pytest.mark.parametrize("dim", [0, 1, 2])
    def test_angled_hits(self, dim):
        for dim2 in range(3):
            if dim2 == dim:
                continue
            axis = np.zeros(3)
            axis[dim] = 1.0
            axis2 = np.zeros(3)
            axis2[dim2] = 1.0
            o = jnp.asarray(axis * -1.5, jnp.float32)
            d = (axis + axis2) * 1.0
            d = jnp.asarray(d / np.linalg.norm(d), jnp.float32)
            t = intersect_aabb(o, d, self.lo, self.hi)
            np.testing.assert_allclose(t, SQRT2_HALF, rtol=1e-5)

    @pytest.mark.parametrize("dim", [0, 1, 2])
    def test_origin_inside_returns_zero(self, dim):
        axis = np.zeros(3)
        axis[dim] = 1.0
        o = jnp.asarray(axis * -0.5, jnp.float32)
        d = jnp.asarray(axis, jnp.float32)
        np.testing.assert_allclose(intersect_aabb(o, d, self.lo, self.hi), 0.0)

    @pytest.mark.parametrize("dim", [0, 1, 2])
    def test_misses(self, dim):
        axis = np.zeros(3)
        axis[dim] = 1.0
        # Pointing away.
        o = jnp.asarray(axis * -5.0, jnp.float32)
        d = jnp.asarray(-axis, jnp.float32)
        assert float(intersect_aabb(o, d, self.lo, self.hi)) < 0.0
        # Offset parallel miss (ref ray_miss2).
        o2 = jnp.asarray(-(7.0 * axis - 2.0), jnp.float32)
        d2 = jnp.asarray(axis, jnp.float32)
        assert float(intersect_aabb(o2, d2, self.lo, self.hi)) < 0.0

    def test_zero_direction_component(self):
        # Direction with zero components uses the FLT_MAX inverse
        # (ref: bounding_box.cpp:44-50): stays finite, hits when aligned.
        o = jnp.array([0.5, 0.5, -5.0])
        d = jnp.array([0.0, 0.0, 1.0])
        np.testing.assert_allclose(
            intersect_aabb(o, d, self.lo, self.hi), 4.0, rtol=1e-6
        )
        # Parallel but outside the slab: miss.
        o2 = jnp.array([2.0, 0.0, -5.0])
        assert float(intersect_aabb(o2, d, self.lo, self.hi)) < 0.0

    def test_batched(self):
        o = jnp.array([[0.0, 0.0, -5.0], [0.0, 0.0, 5.0]])
        d = jnp.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
        t = intersect_aabb(o, d, self.lo, self.hi)
        np.testing.assert_allclose(t[0], 4.0, rtol=1e-6)
        assert float(t[1]) < 0.0


class TestSphere:
    def test_frontal_hit(self):
        t = intersect_spheres(
            jnp.array([0.0, 0.0, -5.0]),
            jnp.array([0.0, 0.0, 1.0]),
            jnp.array([0.0, 0.0, 0.0]),
            jnp.array(1.0),
        )
        np.testing.assert_allclose(t, 4.0, rtol=1e-6)

    def test_miss(self):
        t = intersect_spheres(
            jnp.array([0.0, 2.0, -5.0]),
            jnp.array([0.0, 0.0, 1.0]),
            jnp.array([0.0, 0.0, 0.0]),
            jnp.array(1.0),
        )
        assert float(t) < 0.0

    def test_inside_reports_negative_near_root(self):
        # The reference returns the near quadratic root even when negative;
        # a ray starting inside "misses" (ref: object.cpp:72-84 + the scene
        # test's inside-ray expectation, scene_test.cpp:44-47).
        t = intersect_spheres(
            jnp.array([0.0, 0.0, 0.0]),
            jnp.array([0.0, 0.0, 1.0]),
            jnp.array([0.0, 0.0, 0.0]),
            jnp.array(1.0),
        )
        assert float(t) < 0.0

    def test_tangent_grazing(self):
        t = intersect_spheres(
            jnp.array([1.0, 0.0, -5.0]),
            jnp.array([0.0, 0.0, 1.0]),
            jnp.array([0.0, 0.0, 0.0]),
            jnp.array(1.0),
        )
        np.testing.assert_allclose(t, 5.0, atol=1e-2)


class TestTriangle:
    v0 = jnp.array([-1.0, -1.0, 0.0])
    v1 = jnp.array([1.0, -1.0, 0.0])
    v2 = jnp.array([0.0, 1.0, 0.0])

    def _hit(self, o, d, cull=False):
        return float(
            intersect_triangles(
                jnp.asarray(o, jnp.float32),
                jnp.asarray(d, jnp.float32),
                self.v0,
                self.v1,
                self.v2,
                jnp.asarray(cull),
            )
        )

    def test_center_hit(self):
        t = self._hit([0.0, 0.0, -3.0], [0.0, 0.0, 1.0])
        np.testing.assert_allclose(t, 3.0, rtol=1e-6)

    def test_outside_misses(self):
        assert self._hit([2.0, 0.0, -3.0], [0.0, 0.0, 1.0]) < 0.0
        assert self._hit([0.0, 1.5, -3.0], [0.0, 0.0, 1.0]) < 0.0

    def test_edge_and_vertex_hits(self):
        # Point strictly inside near an edge still hits.
        assert self._hit([0.0, -0.99, -3.0], [0.0, 0.0, 1.0]) > 0.0

    def test_backface_culling(self):
        # The winding normal of (v0,v1,v2) points +z and det = -dot(d, n)
        # (ref: object.cpp:150-158): a ray travelling along +z has det < 0
        # and is culled; a ray travelling along -z has det > 0 and hits.
        assert self._hit([0.0, 0.0, -3.0], [0.0, 0.0, 1.0], cull=True) < 0.0
        np.testing.assert_allclose(
            self._hit([0.0, 0.0, 3.0], [0.0, 0.0, -1.0], cull=True), 3.0, rtol=1e-6
        )
        # Without culling both sides hit.
        np.testing.assert_allclose(
            self._hit([0.0, 0.0, -3.0], [0.0, 0.0, 1.0], cull=False), 3.0, rtol=1e-6
        )

    def test_parallel_ray_misses(self):
        assert self._hit([0.0, 0.0, -1.0], [1.0, 0.0, 0.0]) < 0.0

    def test_behind_origin_negative_t(self):
        # Hit point behind the origin yields negative t (reference semantics:
        # t returned raw; caller discards negatives).
        t = self._hit([0.0, 0.0, 3.0], [0.0, 0.0, 1.0])
        np.testing.assert_allclose(t, -3.0, rtol=1e-6)


@pytest.mark.parametrize("accel", ["dense", "bvh"])
def test_scene_intersect_reports_the_winners_exact_t(accel):
    """The layouts test candidates with the backend's division; the winning
    hit's t is recomputed with the correctly rounded reciprocal, so a shadow
    ray's `t < t_max` decision rounds as in the reference."""
    import dataclasses

    from cpupathtrace_tpu.ops.intersect import _exact_t, intersect_prim, scene_intersect
    from tests.layouts_util import mixed_scene, rays

    scene = mixed_scene("bvh")
    scene = dataclasses.replace(scene, accel=accel) if accel == "dense" else scene
    o, d = rays(3)
    t, p = scene_intersect(scene, o, d)
    hit = np.asarray(p) >= 0
    assert hit.mean() > 0.5
    t_ex = intersect_prim(scene, jnp.maximum(p, 0), o, d, exact=True)
    np.testing.assert_array_equal(np.asarray(t)[hit], np.asarray(t_ex)[hit])
    # A layout t off by a little is replaced; misses keep their -1.
    t2 = np.asarray(_exact_t(scene, o, d, jnp.where(p >= 0, t + 1e-3, t), p))
    np.testing.assert_array_equal(t2, np.asarray(t))
