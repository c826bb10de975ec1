"""Two-level cluster acceleration structure.

One-primitive-per-leaf trees (the reference's layout, scene.cpp:12-102) make
traversal on a vector machine gather-bound: every leaf visit gathers a
single triangle per lane. Here the flat BVH is *cut* into spatially coherent
clusters of up to `cluster_size` primitives; the top-level tree is built over
cluster bounds and each leaf visit dense-tests an aligned block of
`cluster_size` triangles for the whole lane — traversal depth shrinks by
~log2(cluster_size) and the inner loop becomes regular vector work over
contiguous [C, L] blocks.

The cut preserves the reference build's spatial partition (clusters are
subtrees of the same median-split tree), so traversal remains behaviorally a
nearest-hit query with identical results.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .build import NATIVE_THRESHOLD, FlatBVH, build_bvh


@dataclasses.dataclass
class ClusterBVH:
    """Top-level flat BVH over primitive clusters."""

    # Top-level tree (over clusters): prim field holds cluster ids.
    lo: np.ndarray  # [N,3]
    hi: np.ndarray  # [N,3]
    left: np.ndarray  # [N]
    right: np.ndarray  # [N]
    cluster: np.ndarray  # [N] i32 cluster id on leaves, -1 internal
    depth: int

    # Cluster-blocked primitive data: global prim indices, padded with -1.
    members: np.ndarray  # [C, L] i32
    c_lo: np.ndarray  # [C, 3] cluster bounds (flat, for the sweep intersector)
    c_hi: np.ndarray  # [C, 3]
    n_clusters: int
    cluster_size: int


def build_cluster_bvh(
    prim_lo: np.ndarray,
    prim_hi: np.ndarray,
    cluster_size: int = 64,
    use_native: bool | None = None,
) -> ClusterBVH:
    """Build the two-level structure from primitive bounds [P,3]."""
    n = prim_lo.shape[0]

    # Fast path: the native builder hands back per-node subtree info
    # (first-leaf DFS rank + subtree size + the DFS primitive order), so
    # the cluster cut needs no tree sweeps at all — the numpy
    # level-by-level passes below cost ~8 s at 7.2M primitives. Falls
    # through to the sweep path when the native library is unavailable.
    if (use_native is None and n >= NATIVE_THRESHOLD) or use_native:
        from ..native import build_bvh_native

        built = build_bvh_native(
            np.asarray(prim_lo, np.float32), np.asarray(prim_hi, np.float32),
            want_subtree_info=True,
        )
        if built is not None:
            lo, hi, left, right, prim, depth, begin, size, dfs = built
            leaf = prim >= 0
            parent_size = np.full(size.shape[0], np.iinfo(np.int32).max,
                                  np.int64)
            internal = np.flatnonzero(~leaf)
            l64 = left.astype(np.int64)[internal]
            r64 = right.astype(np.int64)[internal]
            parent_size[l64] = size[internal]
            parent_size[r64] = size[internal]
            cut_nodes = np.flatnonzero(
                (size <= cluster_size) & (parent_size > cluster_size)
            )
            cut_nodes = cut_nodes[
                np.argsort(begin[cut_nodes], kind="stable")
            ]
            starts = begin[cut_nodes].astype(np.int64)
            lens = size[cut_nodes].astype(np.int64)
            c_lo = lo[cut_nodes].astype(np.float32)
            c_hi = hi[cut_nodes].astype(np.float32)
            c = starts.shape[0]
            members = np.full((c, cluster_size), -1, np.int32)
            cols = np.arange(cluster_size, dtype=np.int64)
            in_run = cols[None, :] < lens[:, None]
            gather = starts[:, None] + np.minimum(
                cols[None, :], lens[:, None] - 1
            )
            members[in_run] = dfs[gather[in_run]]
            top = build_bvh(c_lo, c_hi, use_native=use_native)
            return ClusterBVH(
                lo=top.lo, hi=top.hi, left=top.left, right=top.right,
                cluster=top.prim, depth=top.depth, members=members,
                c_lo=c_lo, c_hi=c_hi, n_clusters=c,
                cluster_size=cluster_size,
            )

    base = build_bvh(prim_lo, prim_hi, use_native=use_native)

    # Cut the base tree at the first node (walking from the root) whose
    # subtree holds <= cluster_size primitives. All array work, swept one
    # tree LEVEL at a time (O(depth) numpy passes instead of O(nodes)
    # Python steps):
    #   * levels: frontier expansion root -> children;
    #   * subtree primitive counts: bottom-up by level;
    #   * DFS-pre-order leaf offsets: top-down by level
    #     (left child inherits, right child adds the left subtree's count)
    #     — this is what keeps clusters emitted in the left-first DFS
    #     order (spatially consecutive clusters are adjacent);
    #   * cut nodes: size fits and the parent's doesn't (sizes shrink
    #     monotonically down the tree);
    #   * members: each cluster is a contiguous run of the DFS leaf
    #     sequence; bounds are the cut node's stored bounds.
    n_nodes = base.prim.shape[0]
    leaf = base.prim >= 0
    left = base.left.astype(np.int64)
    right = base.right.astype(np.int64)

    levels: list[np.ndarray] = [np.zeros(1, np.int64)]
    while True:
        inner = levels[-1][~leaf[levels[-1]]]
        if inner.size == 0:
            break
        levels.append(np.concatenate([left[inner], right[inner]]))

    size = np.where(leaf, 1, 0).astype(np.int64)
    for lvl in reversed(levels):
        inner = lvl[~leaf[lvl]]
        size[inner] = size[left[inner]] + size[right[inner]]

    leaf_start = np.zeros(n_nodes, np.int64)  # DFS rank of first leaf
    for lvl in levels:
        inner = lvl[~leaf[lvl]]
        leaf_start[left[inner]] = leaf_start[inner]
        leaf_start[right[inner]] = leaf_start[inner] + size[left[inner]]

    parent_size = np.full(n_nodes, np.iinfo(np.int64).max, np.int64)
    internal = np.flatnonzero(~leaf)
    parent_size[left[internal]] = size[internal]
    parent_size[right[internal]] = size[internal]
    cut_nodes = np.flatnonzero(
        (size <= cluster_size) & (parent_size > cluster_size)
    )
    cut_nodes = cut_nodes[np.argsort(leaf_start[cut_nodes], kind="stable")]

    leaf_nodes = np.flatnonzero(leaf)
    ordered_prims = np.empty(n, np.int64)  # leaves in DFS order
    ordered_prims[leaf_start[leaf_nodes]] = base.prim[leaf_nodes]
    starts = leaf_start[cut_nodes]
    lens = size[cut_nodes]
    c_lo = base.lo[cut_nodes].astype(np.float32)
    c_hi = base.hi[cut_nodes].astype(np.float32)

    c = starts.shape[0]
    members = np.full((c, cluster_size), -1, np.int32)
    cols = np.arange(cluster_size, dtype=np.int64)
    in_run = cols[None, :] < lens[:, None]
    gather = starts[:, None] + np.minimum(cols[None, :], lens[:, None] - 1)
    members[in_run] = ordered_prims[gather[in_run]]

    top = build_bvh(c_lo, c_hi, use_native=use_native)
    return ClusterBVH(
        lo=top.lo,
        hi=top.hi,
        left=top.left,
        right=top.right,
        cluster=top.prim,
        depth=top.depth,
        members=members,
        c_lo=c_lo,
        c_hi=c_hi,
        n_clusters=c,
        cluster_size=cluster_size,
    )
