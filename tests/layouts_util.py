"""Shared checks for tests/test_layouts_*.py: every intersector layout
against brute-force `dense_intersect`, for the four query forms the
wavefront issues (nearest hit; shadow rays with `t_max`; `any_hit`
visibility; a `live` lane mask).

Agreement rule per ray: the same primitive or the same t (two triangles
sharing the winning distance are both correct answers)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from cpupathtrace_tpu.ops.intersect import scene_intersect
from cpupathtrace_tpu.scene.geometry import HostTriangle, make_box
from cpupathtrace_tpu.scene.scene import SceneBuilder

LAYOUTS = ("bvh", "cluster", "sweep", "binned")
QUERIES = ("nearest", "t_max", "any_hit", "live")
N_RAYS = 1024


def mixed_scene(accel):
    """~1200 small random triangles (half of them backface-culled) and two
    spheres inside a large 12-triangle room."""
    rng = np.random.default_rng(11)
    b = SceneBuilder()
    tris = []
    for c in rng.uniform(-1.5, 1.5, (1200, 3)):
        v = c + rng.uniform(-0.1, 0.1, (3, 3))
        tris.append(HostTriangle(v[0], v[1], v[2],
                                 cull_backface=bool(c[0] > 0)))
    b.add_triangles(tris, 0)
    b.add_triangles(make_box((-2, -2, -2), (2, 2, 2)), 0)
    b.add_sphere((0.0, 0.0, 0.0), 0.4)
    b.add_sphere((1.0, 0.5, 0.0), 0.2)
    return b.build(accel=accel, cluster_size=64)


def rays(seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.8, 1.8, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def _agree(ta, pa, tb, pb):
    return (pa == pb) | (ta == tb)


def check_layout_query(scene, query):
    """Assert `scene` (built with one layout) answers `query` like the
    dense intersector over the same primitives."""
    dense = dataclasses.replace(scene, accel="dense")
    o, d = rays()
    rng = np.random.default_rng(1)
    t_max = jnp.asarray(rng.uniform(0.05, 2.0, N_RAYS).astype(np.float32))
    live = jnp.asarray(rng.random(N_RAYS) < 0.5)
    kw = {
        "nearest": {},
        "t_max": {"t_max": t_max},
        "any_hit": {"t_max": t_max, "any_hit": True},
        "live": {"live": live},
    }[query]
    fn = jax.jit(lambda s, o, d: scene_intersect(s, o, d, **kw))
    t, p = map(np.asarray, fn(scene, o, d))
    ref_kw = {k: v for k, v in kw.items() if k == "t_max"}
    t_d, p_d = map(np.asarray, jax.jit(
        lambda s, o, d: scene_intersect(s, o, d, **ref_kw))(dense, o, d))
    assert int((p_d >= 0).sum()) > N_RAYS // 10  # the query hits things
    if query == "any_hit":
        # Visibility: occlusion agrees; a reported hit lies inside t_max.
        np.testing.assert_array_equal(p >= 0, p_d >= 0)
        assert np.all((p < 0) | (t < np.asarray(t_max)))
        return
    same = _agree(t, p, t_d, p_d)
    if query == "live":
        same = same[np.asarray(live)]
    assert same.all(), f"{int((~same).sum())} rays disagree"
