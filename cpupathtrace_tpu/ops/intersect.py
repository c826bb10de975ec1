"""Batched ray-primitive intersection ops (pure jnp).

Primitive math reproduces the reference exactly:
  * triangle: Moller-Trumbore with eps=1e-6 and optional backface culling
    (ref: src/scene/object.cpp:146-182 Triangle::getIntersection)
  * sphere: near-root quadratic; rays starting inside report the (negative)
    entry distance and therefore miss, matching the reference
    (ref: src/scene/object.cpp:72-84 Sphere::getIntersection)
  * AABB: slab test with FLT_MAX inverse for zero direction components,
    clamped to 0 when the origin is inside, -1 on miss
    (ref: src/scene/bounding_box.cpp:38-73 AABB::getIntersection)

Scene intersectors, one per `SceneData.accel` layout:
  * `dense_intersect` — all rays x all primitives; for small scenes a
    regular broadcast-test-argmin pattern with no traversal at all.
  * `bvh_intersect` — per-lane stack traversal of the flat BVH with
    nearest-hit pruning (the reference's layout).
  * `cluster_intersect` — the same walk over a two-level cluster tree.
  * `sweep_intersect` — candidate sweep over cluster bounds.
  * `binned_intersect_ref` — dense big-triangle set + sweep over the rest.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.math import cross, div, dot, sqrt
from ..scene.scene import SceneData

_TRI_EPS = 1e-6
_FLT_MAX = 3.4028234663852886e38


def intersect_triangles(o, d, v0, v1, v2, cull, exact: bool = False):
    """Moller-Trumbore. Broadcasts rays [...,3] against triangles [...,3].

    Returns t (may be negative when the hit is behind the origin, exactly like
    the reference); -1 encodes a miss. `exact=True` rounds `1 / det`
    correctly, like the reference's `1.0f / det`; by default it is the
    backend's division, which XLA:GPU computes to within two ulps.
    """
    ab = v1 - v0
    ac = v2 - v0
    pvec = cross(d, ac)
    det = dot(ab, pvec)

    miss_det = jnp.where(cull, det <= _TRI_EPS, jnp.abs(det) <= _TRI_EPS)

    inv_det = (div if exact else jnp.divide)(1.0, jnp.where(miss_det, 1.0, det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, ab)
    v = dot(d, qvec) * inv_det
    t = dot(ac, qvec) * inv_det

    miss = miss_det | (u < 0) | (u > 1) | (v < 0) | (u + v > 1)
    return jnp.where(miss, -1.0, t)


def intersect_spheres(o, d, center, radius):
    """Near-root sphere intersection (ref: object.cpp:72-84)."""
    co = o - center
    dd = dot(d, co)
    disc = dd * dd - dot(co, co) + radius * radius
    t = -(dd + sqrt(jnp.maximum(disc, 0.0)))
    return jnp.where(disc >= 0, t, -1.0)


def intersect_aabb(o, d, lo, hi):
    """Slab test (ref: bounding_box.cpp:38-73). Returns entry distance,
    clamped to 0 if the origin is inside; -1 on miss."""
    inv = jnp.where(jnp.abs(d) > 0.0, 1.0 / jnp.where(d == 0, 1.0, d), _FLT_MAX)
    t_lo = (lo - o) * inv
    t_hi = (hi - o) * inv
    t_min = jnp.max(jnp.minimum(t_lo, t_hi), axis=-1)
    t_max = jnp.min(jnp.maximum(t_lo, t_hi), axis=-1)
    t = jnp.where(t_min < 0.0, 0.0, t_min)
    return jnp.where((t_max < 0.0) | (t_min > t_max), -1.0, t)


def _gather_triangle(scene: SceneData, idx):
    idx = jnp.clip(idx, 0, scene.tri_v0.shape[0] - 1)
    return (
        scene.tri_v0[idx],
        scene.tri_v1[idx],
        scene.tri_v2[idx],
        scene.tri_cull[idx],
    )


def intersect_prim(scene: SceneData, prim, o, d, exact: bool = False):
    """Intersect rays against the global primitive index `prim` (triangles
    first, then spheres). Shapes broadcast; prim is [...]."""
    is_tri = prim < scene.n_tri
    v0, v1, v2, cull = _gather_triangle(scene, jnp.where(is_tri, prim, 0))
    t_tri = intersect_triangles(o, d, v0, v1, v2, cull, exact)

    sidx = jnp.clip(prim - scene.n_tri, 0, scene.sph_center.shape[0] - 1)
    t_sph = intersect_spheres(o, d, scene.sph_center[sidx], scene.sph_radius[sidx])
    return jnp.where(is_tri, t_tri, t_sph)


def dense_intersect(scene: SceneData, o, d):
    """Nearest-hit over all primitives, brute force.

    o, d: [R,3]. Returns (t [R], prim [R]) with t=-1 / prim=-1 on miss.
    """
    # [R, T]
    t_tri = intersect_triangles(
        o[:, None, :], d[:, None, :],
        scene.tri_v0[None], scene.tri_v1[None], scene.tri_v2[None],
        scene.tri_cull[None],
    )
    t_tri = jnp.where(scene.tri_valid[None], t_tri, -1.0)
    # [R, S]
    t_sph = intersect_spheres(
        o[:, None, :], d[:, None, :],
        scene.sph_center[None], scene.sph_radius[None],
    )
    t_sph = jnp.where(scene.sph_valid[None], t_sph, -1.0)

    t_all = jnp.concatenate([t_tri, t_sph], axis=1)  # [R, Tpad + Spad]
    t_pos = jnp.where(t_all >= 0.0, t_all, jnp.inf)
    best = jnp.argmin(t_pos, axis=1)
    best_t = jnp.take_along_axis(t_pos, best[:, None], axis=1)[:, 0]
    hit = jnp.isfinite(best_t)
    # Map the concatenated (padded) slot index to the global primitive index
    # space: [0, n_tri) triangles, [n_tri, n_tri + n_sph) spheres.
    tpad = t_tri.shape[1]
    best = best.astype(jnp.int32)
    prim = jnp.where(best < tpad, best, best - tpad + scene.n_tri)
    return (
        jnp.where(hit, best_t, -1.0),
        jnp.where(hit, prim, -1),
    )


def bvh_intersect(scene: SceneData, o, d):
    """SIMT wavefront BVH traversal: every ray walks the flat tree with its
    own short stack; nearest hit with t_max pruning (behaviorally equivalent
    to the reference's ordered near/far recursion, ref: scene.cpp:104-150).

    o, d: [R,3]. Returns (t [R], prim [R]).
    """
    n_rays = o.shape[0]
    stack_depth = scene.bvh_depth + 2

    stack = jnp.zeros((n_rays, stack_depth), jnp.int32)
    sp = jnp.zeros(n_rays, jnp.int32)
    node = jnp.zeros(n_rays, jnp.int32)  # start at root
    best_t = jnp.full(n_rays, jnp.inf)
    best_prim = jnp.full(n_rays, -1, jnp.int32)
    active = jnp.ones(n_rays, bool)

    # Root test: rays missing the root box are immediately done
    # (ref: scene.cpp:210-220 Scene::getIntersection root slab test).
    t_root = intersect_aabb(o, d, scene.bvh_lo[0], scene.bvh_hi[0])
    active = active & (t_root >= 0.0)

    def cond(state):
        return jnp.any(state[5])

    def body(state):
        stack, sp, node, best_t, best_prim, active = state

        prim = scene.bvh_prim[node]
        is_leaf = prim >= 0

        # --- Leaf: intersect the one primitive, keep nearest non-negative t.
        t_leaf = intersect_prim(scene, jnp.maximum(prim, 0), o, d)
        better = active & is_leaf & (t_leaf >= 0.0) & (t_leaf < best_t)
        best_t = jnp.where(better, t_leaf, best_t)
        best_prim = jnp.where(better, prim, best_prim)

        # --- Internal: slab-test both children, descend near, push far.
        li = scene.bvh_left[node]
        ri = scene.bvh_right[node]
        t_l = intersect_aabb(o, d, scene.bvh_lo[li], scene.bvh_hi[li])
        t_r = intersect_aabb(o, d, scene.bvh_lo[ri], scene.bvh_hi[ri])
        hit_l = (t_l >= 0.0) & (t_l < best_t)
        hit_r = (t_r >= 0.0) & (t_r < best_t)

        l_near = jnp.where(hit_l & hit_r, t_l <= t_r, hit_l)
        near = jnp.where(l_near, li, ri)
        far = jnp.where(l_near, ri, li)
        n_hits = hit_l.astype(jnp.int32) + hit_r.astype(jnp.int32)

        push = active & (~is_leaf) & (n_hits == 2)
        stack = jnp.where(
            push[:, None]
            & (jnp.arange(stack_depth)[None, :] == sp[:, None]),
            far[:, None],
            stack,
        )
        sp = jnp.where(push, sp + 1, sp)

        descend = active & (~is_leaf) & (n_hits > 0)
        # Pop when at a leaf or when no child was hit.
        want_pop = active & ~descend
        can_pop = sp > 0
        sp_new = jnp.where(want_pop & can_pop, sp - 1, sp)
        popped = jnp.take_along_axis(stack, jnp.maximum(sp_new, 0)[:, None], axis=1)[:, 0]

        node = jnp.where(descend, near, jnp.where(want_pop & can_pop, popped, node))
        active = active & (descend | (want_pop & can_pop))
        sp = sp_new

        return stack, sp, node, best_t, best_prim, active

    state = (stack, sp, node, best_t, best_prim, active)
    state = jax.lax.while_loop(cond, body, state)
    _, _, _, best_t, best_prim, _ = state

    hit = best_prim >= 0
    return jnp.where(hit, best_t, -1.0), best_prim


def cluster_intersect(scene: SceneData, o, d):
    """Two-level traversal (accel/cluster.py): short-stack walk of the
    small top tree over clusters; every leaf visit gathers one pre-blocked
    [L]-triangle cluster per lane and dense-tests it — regular vector work
    instead of per-primitive gathers.

    o, d: [R,3]. Returns (t [R], prim [R] global indices).
    """
    n_rays = o.shape[0]
    stack_depth = scene.cl_depth + 2

    stack = jnp.zeros((n_rays, stack_depth), jnp.int32)
    sp = jnp.zeros(n_rays, jnp.int32)
    node = jnp.zeros(n_rays, jnp.int32)
    best_t = jnp.full(n_rays, jnp.inf)
    best_prim = jnp.full(n_rays, -1, jnp.int32)

    t_root = intersect_aabb(o, d, scene.cl_lo[0], scene.cl_hi[0])
    active = t_root >= 0.0

    def cond(state):
        return jnp.any(state[5])

    def body(state):
        stack, sp, node, best_t, best_prim, active = state

        leaf = scene.cl_leaf[node]
        is_leaf = leaf >= 0

        # --- Leaf: dense-test the whole cluster block for each lane.
        cid = jnp.maximum(leaf, 0)
        v0 = scene.blk_v0[cid]  # [R, L, 3]
        v1 = scene.blk_v1[cid]
        v2 = scene.blk_v2[cid]
        cull = scene.blk_cull[cid]
        pid = scene.blk_prim[cid]  # [R, L]
        t_blk = intersect_triangles(
            o[:, None, :], d[:, None, :], v0, v1, v2, cull
        )
        t_blk = jnp.where((pid >= 0) & (t_blk >= 0.0), t_blk, jnp.inf)
        j = jnp.argmin(t_blk, axis=1)
        t_leaf = jnp.take_along_axis(t_blk, j[:, None], axis=1)[:, 0]
        p_leaf = jnp.take_along_axis(pid, j[:, None], axis=1)[:, 0]
        better = active & is_leaf & (t_leaf < best_t)
        best_t = jnp.where(better, t_leaf, best_t)
        best_prim = jnp.where(better, p_leaf, best_prim)

        # --- Internal: slab-test children, descend near, push far.
        li = scene.cl_left[node]
        ri = scene.cl_right[node]
        t_l = intersect_aabb(o, d, scene.cl_lo[li], scene.cl_hi[li])
        t_r = intersect_aabb(o, d, scene.cl_lo[ri], scene.cl_hi[ri])
        hit_l = (t_l >= 0.0) & (t_l < best_t)
        hit_r = (t_r >= 0.0) & (t_r < best_t)

        l_near = jnp.where(hit_l & hit_r, t_l <= t_r, hit_l)
        near = jnp.where(l_near, li, ri)
        far = jnp.where(l_near, ri, li)
        n_hits = hit_l.astype(jnp.int32) + hit_r.astype(jnp.int32)

        push = active & (~is_leaf) & (n_hits == 2)
        stack = jnp.where(
            push[:, None]
            & (jnp.arange(stack_depth)[None, :] == sp[:, None]),
            far[:, None],
            stack,
        )
        sp = jnp.where(push, sp + 1, sp)

        descend = active & (~is_leaf) & (n_hits > 0)
        want_pop = active & ~descend
        can_pop = sp > 0
        sp_new = jnp.where(want_pop & can_pop, sp - 1, sp)
        popped = jnp.take_along_axis(
            stack, jnp.maximum(sp_new, 0)[:, None], axis=1
        )[:, 0]

        node = jnp.where(descend, near, jnp.where(want_pop & can_pop, popped, node))
        active = active & (descend | (want_pop & can_pop))
        sp = sp_new

        return stack, sp, node, best_t, best_prim, active

    state = (stack, sp, node, best_t, best_prim, active)
    state = jax.lax.while_loop(cond, body, state)
    best_t, best_prim = state[3], state[4]

    # Spheres: dense test (scenes carry at most a handful).
    if scene.n_sph > 0:
        t_sph = intersect_spheres(
            o[:, None, :], d[:, None, :],
            scene.sph_center[None], scene.sph_radius[None],
        )
        t_sph = jnp.where(scene.sph_valid[None] & (t_sph >= 0.0), t_sph, jnp.inf)
        js = jnp.argmin(t_sph, axis=1)
        ts = jnp.take_along_axis(t_sph, js[:, None], axis=1)[:, 0]
        sph_better = ts < best_t
        best_t = jnp.where(sph_better, ts, best_t)
        best_prim = jnp.where(
            sph_better, js.astype(jnp.int32) + scene.n_tri, best_prim
        )

    hit = best_prim >= 0
    return jnp.where(hit, best_t, -1.0), best_prim


_SWEEP_K = 4


def sweep_intersect(scene: SceneData, o, d, k: int = _SWEEP_K):
    """Dense-top sweep intersector.

    Per-lane tree traversal serializes ~O(tree depth * visited nodes) gather
    iterations. This intersector instead:

      1. slab-tests every ray against ALL C cluster bounds at once — a
         dense, gather-free [R, C] pass over broadcast cluster bounds;
      2. selects each ray's k nearest candidate clusters with `top_k`;
      3. gathers those k pre-blocked [L]-triangle clusters (one large
         contiguous block per candidate) and dense-tests [R, k, L]
         Moller-Trumbore in a single pass;
      4. repeats (2-3) only while some ray still has an unprocessed cluster
         whose entry distance beats its current best hit — typically 1-2
         rounds total.

    Exact nearest-hit (never approximate): the loop runs until no candidate
    can beat the recorded hit. o, d: [R,3] -> (t [R], prim [R]).
    """
    n_rays = o.shape[0]
    c = scene.blk_lo.shape[0]
    k = min(k, c)
    l = scene.blk_prim.shape[1]

    # [R, C] entry distances; inf where missed.
    t_c = intersect_aabb(
        o[:, None, :], d[:, None, :], scene.blk_lo[None], scene.blk_hi[None]
    )
    cluster_valid = jnp.any(scene.blk_prim >= 0, axis=1)  # padding clusters
    t_c = jnp.where((t_c >= 0.0) & cluster_valid[None, :], t_c, jnp.inf)

    best_t = jnp.full(n_rays, jnp.inf)
    best_prim = jnp.full(n_rays, -1, jnp.int32)

    def round_pending(t_c, best_t):
        return t_c < best_t[:, None]

    def cond(state):
        t_c, best_t, _ = state
        return jnp.any(round_pending(t_c, best_t))

    def body(state):
        t_c, best_t, best_prim = state
        pend = jnp.where(round_pending(t_c, best_t), t_c, jnp.inf)
        # k nearest pending clusters per ray.
        neg, idx = jax.lax.top_k(-pend, k)  # [R, k]
        has = jnp.isfinite(neg)

        cid = jnp.where(has, idx, 0)
        v0 = scene.blk_v0[cid]  # [R, k, L, 3]
        v1 = scene.blk_v1[cid]
        v2 = scene.blk_v2[cid]
        cull = scene.blk_cull[cid]
        pid = scene.blk_prim[cid]  # [R, k, L]

        t_tri = intersect_triangles(
            o[:, None, None, :], d[:, None, None, :], v0, v1, v2, cull
        )
        t_tri = jnp.where(
            has[..., None] & (pid >= 0) & (t_tri >= 0.0), t_tri, jnp.inf
        )
        t_flat = t_tri.reshape(n_rays, k * l)
        j = jnp.argmin(t_flat, axis=1)
        t_min = jnp.take_along_axis(t_flat, j[:, None], axis=1)[:, 0]
        p_min = jnp.take_along_axis(
            pid.reshape(n_rays, k * l), j[:, None], axis=1
        )[:, 0]

        better = t_min < best_t
        best_t = jnp.where(better, t_min, best_t)
        best_prim = jnp.where(better, p_min, best_prim)

        # Mark the selected clusters processed.
        t_c = jnp.where(
            jnp.zeros_like(t_c, bool).at[
                jnp.arange(n_rays)[:, None], idx
            ].set(has),
            jnp.inf,
            t_c,
        )
        return t_c, best_t, best_prim

    state = (t_c, best_t, best_prim)
    state = jax.lax.while_loop(cond, body, state)
    _, best_t, best_prim = state

    if scene.n_sph > 0:
        t_sph = intersect_spheres(
            o[:, None, :], d[:, None, :],
            scene.sph_center[None], scene.sph_radius[None],
        )
        t_sph = jnp.where(scene.sph_valid[None] & (t_sph >= 0.0), t_sph, jnp.inf)
        js = jnp.argmin(t_sph, axis=1)
        ts = jnp.take_along_axis(t_sph, js[:, None], axis=1)[:, 0]
        sph_better = ts < best_t
        best_t = jnp.where(sph_better, ts, best_t)
        best_prim = jnp.where(
            sph_better, js.astype(jnp.int32) + scene.n_tri, best_prim
        )

    hit = best_prim >= 0
    return jnp.where(hit, best_t, -1.0), best_prim


def _dense_part(scene: SceneData, o, d):
    """Nearest hit over the big-triangle set + spheres of a binned scene
    (both sets are tiny for partitioned scenes); (inf, -1) on miss."""
    big = jnp.int32(2 ** 30)
    best_t = jnp.full(o.shape[0], jnp.inf)
    best_p = jnp.full(o.shape[0], -1, jnp.int32)
    if scene.n_big > 0:
        t = intersect_triangles(
            o[:, None, :], d[:, None, :],
            scene.big_v0[None], scene.big_v1[None], scene.big_v2[None],
            scene.big_cull[None],
        )
        t = jnp.where((scene.big_prim[None] >= 0) & (t >= 0.0), t, jnp.inf)
        tb = jnp.min(t, axis=1)
        pb = jnp.min(
            jnp.where(t <= tb[:, None], scene.big_prim[None], big), axis=1
        )
        hit = jnp.isfinite(tb)
        best_t = jnp.where(hit, tb, best_t)
        best_p = jnp.where(hit, pb, best_p)
    if scene.n_sph > 0:
        t = intersect_spheres(
            o[:, None, :], d[:, None, :],
            scene.sph_center[None], scene.sph_radius[None],
        )
        t = jnp.where(scene.sph_valid[None] & (t >= 0.0), t, jnp.inf)
        ts = jnp.min(t, axis=1)
        sl = jnp.arange(t.shape[1], dtype=jnp.int32)[None] + scene.n_tri
        ps = jnp.min(jnp.where(t <= ts[:, None], sl, big), axis=1)
        better = ts < best_t
        best_t = jnp.where(better, ts, best_t)
        best_p = jnp.where(better, ps, best_p)
    return best_t, best_p


def binned_intersect_ref(scene: SceneData, o, d):
    """Nearest hit of a binned (big/small partitioned) scene: the dense
    big-triangle + sphere set, then the sweep over the small-triangle
    cluster blocks. o, d: [R,3] -> (t [R], prim [R]), -1 on miss."""
    t0, p0 = _dense_part(scene, o, d)
    ts, ps = sweep_intersect(scene, o, d)
    ts = jnp.where(ts >= 0.0, ts, jnp.inf)
    better = ts < t0
    t = jnp.where(better, ts, t0)
    p = jnp.where(better, ps, p0)
    hit = (p >= 0) & jnp.isfinite(t)
    return jnp.where(hit, t, -1.0), jnp.where(hit, p, -1)


def scene_intersect(scene: SceneData, o, d, t_max=None, live=None,
                    any_hit: bool = False):
    """Dispatch on the scene's layout (static choice at trace time).

    Query qualifiers:
      * t_max [R]: hits at t >= t_max are reported as misses (shadow rays)
      * live [R] bool: lanes with live=False may return an arbitrary result
      * any_hit: the returned hit need not be the nearest (visibility)
    Every layout here computes the exact nearest hit for every lane, so
    `live` and `any_hit` change nothing today. Callers pass them so that a
    traversal which can prune on them (the GPU traversal of ROADMAP Reach 1)
    needs no change at the call sites. The winning hit's t is recomputed
    with correctly rounded arithmetic (`_exact_t`) before `t_max` applies.
    """
    del live, any_hit  # permissive qualifiers: the exact answer honors both
    if scene.accel == "binned":
        t, p = binned_intersect_ref(scene, o, d)
    elif scene.accel == "sweep":
        t, p = sweep_intersect(scene, o, d)
    elif scene.accel == "cluster":
        t, p = cluster_intersect(scene, o, d)
    elif scene.accel == "bvh":
        t, p = bvh_intersect(scene, o, d)
    else:
        t, p = dense_intersect(scene, o, d)
    t = _exact_t(scene, o, d, t, p)
    if t_max is not None:
        miss = (t < 0.0) | (t >= t_max)
        t = jnp.where(miss, -1.0, t)
        p = jnp.where(miss, -1, p)
    if scene.gp_axis is not None:
        t, p = _gp_combine(t, p, scene.gp_axis)
    return t, p


def _exact_t(scene: SceneData, o, d, t, p):
    """The layouts test candidates with the backend's fast division; the
    winner's t is computed again with the reference's correctly rounded
    reciprocal. A shadow ray to a point sampled on a triangle light meets
    that triangle at exactly `t == dist - eps`, so the rounding of t decides
    the light's visibility. Where the exact test misses (a grazing edge),
    the layout's t stays."""
    hit = p >= 0
    t_exact = intersect_prim(scene, jnp.where(hit, p, 0), o, d, exact=True)
    return jnp.where(hit & (t_exact >= 0.0), t_exact, t)


def _gp_combine(t, p, axis_name: str):
    """Combine per-shard nearest hits across the geometry-parallel mesh
    axis (parallel/geometry.py): the winning t is the min over shards; on
    exact-t ties the smallest primitive id wins (deterministic, matching
    no single-device tie order in particular — ties are measure-zero for
    generic scenes). Misses travel as +inf so they never win."""
    t_c = jnp.where(p >= 0, t, jnp.inf)
    t_min = jax.lax.pmin(t_c, axis_name)
    cand = jnp.where(
        (p >= 0) & (t_c <= t_min), p, jnp.int32(2 ** 31 - 1)
    )
    p_min = jax.lax.pmin(cand, axis_name)
    hit = jnp.isfinite(t_min)
    return jnp.where(hit, t_min, -1.0), jnp.where(hit, p_min, -1)
