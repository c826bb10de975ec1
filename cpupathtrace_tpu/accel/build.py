"""Flat BVH construction (host-side).

Same construction policy as the reference (ref: src/scene/scene.cpp:12-102
impl::constructBVH): top-down, per-axis median of box minima via
partial-selection, split axis chosen to minimize the summed surface area of
the two merged child boxes, stable partition by `low[axis] <= median`, and the
left/right rebalance guard (left <= 2*right). One primitive per leaf, exactly
like the reference's one-object-per-leaf tree.

The output is a *flat* SoA node array (lo/hi bounds, child indices, leaf prim
index) instead of a pointer tree, so traversal is a gather-based wavefront op
rather than pointer chasing.

Implementation is iterative (explicit work stack) to handle multi-million-
primitive meshes without Python recursion limits. A C++ builder for very large
meshes lives in cpupathtrace_tpu/native.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FlatBVH:
    lo: np.ndarray  # [N,3] f32
    hi: np.ndarray  # [N,3] f32
    left: np.ndarray  # [N] i32 child node index (valid on internal nodes)
    right: np.ndarray  # [N] i32
    prim: np.ndarray  # [N] i32 primitive index on leaves, -1 on internal
    depth: int  # max tree depth (root = 1); traversal stack bound


def _surface_area_cost(lo: np.ndarray, hi: np.ndarray, mask: np.ndarray) -> float:
    """Sum of surface areas of the two boxes induced by `mask` partition
    (ref: src/scene/scene.cpp:41-62)."""
    total = 0.0
    for side in (mask, ~mask):
        if not side.any():
            # Empty side contributes the reference's degenerate -inf-extent
            # box; its 'surface area' is +inf * 0 ... the reference sums
            # 2*(d0*d1 + d1*d2 + d0*d2) of (-inf)-sized deltas, i.e. +inf.
            # Reproduce by treating it as +inf so such splits are avoided.
            total += np.inf
            continue
        l = lo[side].min(axis=0)
        h = hi[side].max(axis=0)
        d = h - l
        total += 2.0 * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2])
    return total


#: Primitive count above which the native C++ builder is preferred.
NATIVE_THRESHOLD = 512


def build_bvh(
    prim_lo: np.ndarray, prim_hi: np.ndarray, use_native: bool | None = None
) -> FlatBVH:
    """Build the flat BVH over primitive bounds [P,3]/[P,3].

    `use_native=None` auto-selects the C++ builder (native/ptx_native.cpp,
    identical tree) for large primitive counts; True/False forces a path.
    """
    n = prim_lo.shape[0]
    prim_lo = np.asarray(prim_lo, np.float32)
    prim_hi = np.asarray(prim_hi, np.float32)

    if use_native is None:
        use_native = n >= NATIVE_THRESHOLD
    if use_native and n > 0:
        from ..native import build_bvh_native

        built = build_bvh_native(prim_lo, prim_hi)
        if built is not None:
            lo, hi, left, right, prim, depth = built
            return FlatBVH(lo=lo, hi=hi, left=left, right=right, prim=prim,
                           depth=depth)

    max_nodes = max(2 * n - 1, 1)
    lo = np.zeros((max_nodes, 3), np.float32)
    hi = np.zeros((max_nodes, 3), np.float32)
    left = np.full(max_nodes, -1, np.int32)
    right = np.full(max_nodes, -1, np.int32)
    leaf_prim = np.full(max_nodes, -1, np.int32)

    next_node = 0
    max_depth = 0

    def alloc() -> int:
        nonlocal next_node
        i = next_node
        next_node += 1
        return i

    # Work stack of (node_index, prim_indices array, depth).
    root = alloc()
    stack: list[tuple[int, np.ndarray, int]] = [(root, np.arange(n, dtype=np.int64), 1)]

    while stack:
        node, idx, depth = stack.pop()
        max_depth = max(max_depth, depth)
        k = idx.shape[0]
        l_sub = prim_lo[idx]
        h_sub = prim_hi[idx]
        lo[node] = l_sub.min(axis=0)
        hi[node] = h_sub.max(axis=0)

        if k == 1:
            leaf_prim[node] = idx[0]
            continue

        # Median of box minima per axis: the (k//2 - 1)-th order statistic
        # (ref: src/scene/scene.cpp:25-36; nth_element at size/2 - 1).
        m_pos = max(k // 2 - 1, 0)
        best_cost, best_mask = None, None
        for axis in range(3):
            med = np.partition(l_sub[:, axis], m_pos)[m_pos]
            mask = l_sub[:, axis] <= med
            cost = _surface_area_cost(l_sub, h_sub, mask)
            # Ties keep the lowest axis, like the reference's strict '<' scan
            # (ref: scene.cpp:65-72).
            if best_cost is None or cost < best_cost:
                best_cost, best_mask = cost, mask

        mask = best_mask
        left_idx = idx[mask]
        right_idx = idx[~mask]

        # Rebalance guard: move the *last* left entries over until
        # left <= 2*right (ref: src/scene/scene.cpp:90-94).
        n_left = left_idx.shape[0]
        n_right = right_idx.shape[0]
        move = 0
        while n_left - move > 1 and (n_left - move) > 2 * (n_right + move):
            move += 1
        if move:
            right_idx = np.concatenate([right_idx, left_idx[n_left - move:][::-1]])
            left_idx = left_idx[: n_left - move]

        cl = alloc()
        cr = alloc()
        left[node] = cl
        right[node] = cr
        stack.append((cr, right_idx, depth + 1))
        stack.append((cl, left_idx, depth + 1))

    return FlatBVH(
        lo=lo[:next_node],
        hi=hi[:next_node],
        left=left[:next_node],
        right=right[:next_node],
        prim=leaf_prim[:next_node],
        depth=max_depth,
    )
