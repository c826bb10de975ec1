"""Scene container: SoA device arrays + host-side builder.

Array-native inversion of the reference's pointer-based scene
(ref: include/PathTrace/scene/scene.h, src/scene/scene.cpp): virtual `Object`s
become flat primitive arrays, `MaterialHandler` indirection becomes an integer
material id per primitive, and the emissive-object registry + CDF
(ref: src/scene/scene.cpp:165-208) becomes a prefix-sum array sampled with
`searchsorted`.

Primitive index space: 0..n_tri-1 are triangles, n_tri..n_tri+n_sph-1 spheres.
Arrays are padded so no shape is ever zero-length (XLA-friendly); padding
lanes are masked off via `tri_valid`/`sph_valid`.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np
import jax.numpy as jnp

from .geometry import HostTriangle, TriangleBatch
from ..utils.math import PI

# BSDF type codes (ref classes: LambertianBRDF / GlassBDF / MirrorBRDF,
# include/PathTrace/scene/propagation.h:57-108).
BSDF_LAMBERTIAN = 0
BSDF_GLASS = 1
BSDF_MIRROR = 2

# Upper bound on the binned layout's cluster count: the builder coarsens
# clusters until the cut fits. The value was sized for the scalar-memory
# bounds table of a kernel written for another machine; it still bounds
# the sweep's [rays, clusters] candidate matrix.
MAX_CLUSTERS = 4096


# Static (non-array) SceneData fields. Single source of truth shared by the
# register_dataclass meta_fields below and scene.cache's header/blob split —
# a field added to only one of the two would otherwise be silently misrouted
# on save/load.
STATIC_FIELDS = (
    "n_tri", "n_sph", "n_point_lights", "n_emissive",
    "emissive_sample_count", "accel", "bvh_depth", "cl_depth",
    "cluster_size", "n_big", "gp_axis",
)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "tri_v0", "tri_v1", "tri_v2",
        "tri_n0", "tri_n1", "tri_n2",
        "tri_cull", "tri_material", "tri_valid",
        "sph_center", "sph_radius", "sph_material", "sph_valid",
        "mat_diffuse", "mat_specular", "mat_ior", "mat_emission",
        "mat_bsdf", "mat_one_way",
        "light_pos", "light_spectrum",
        "emissive_prim", "emissive_cdf",
        "bvh_lo", "bvh_hi", "bvh_left", "bvh_right", "bvh_prim",
        "cl_lo", "cl_hi", "cl_left", "cl_right", "cl_leaf",
        "blk_v0", "blk_v1", "blk_v2", "blk_cull", "blk_prim",
        "blk_lo", "blk_hi",
        "big_v0", "big_v1", "big_v2", "big_cull", "big_prim",
    ],
    meta_fields=list(STATIC_FIELDS),
)
@dataclasses.dataclass(frozen=True)
class SceneData:
    # Triangles (padded to >=1).
    tri_v0: jnp.ndarray  # [T,3] f32
    tri_v1: jnp.ndarray  # [T,3]
    tri_v2: jnp.ndarray  # [T,3]
    tri_n0: jnp.ndarray  # [T,3] per-vertex shading normals
    tri_n1: jnp.ndarray  # [T,3]
    tri_n2: jnp.ndarray  # [T,3]
    tri_cull: jnp.ndarray  # [T] bool — backface culling flag
    tri_material: jnp.ndarray  # [T] i32
    tri_valid: jnp.ndarray  # [T] bool — False on padding lanes

    # Spheres (padded to >=1).
    sph_center: jnp.ndarray  # [S,3]
    sph_radius: jnp.ndarray  # [S]
    sph_material: jnp.ndarray  # [S] i32
    sph_valid: jnp.ndarray  # [S] bool

    # Material table — the differentiable leaves of the scene
    # (ref Material/ConstantMaterial: include/PathTrace/scene/material.h).
    mat_diffuse: jnp.ndarray  # [M,4] RGBA
    mat_specular: jnp.ndarray  # [M,4] RGBA (default white, ref material.cpp:15-17)
    mat_ior: jnp.ndarray  # [M] refractive index (default 1, ref material.cpp:3-5)
    mat_emission: jnp.ndarray  # [M,4] RGBA radiance
    mat_bsdf: jnp.ndarray  # [M] i32 BSDF type code
    mat_one_way: jnp.ndarray  # [M] bool (MirrorBRDF one_way flag)

    # Explicit point lights (ref PointLightSource: scene/light.h:55).
    light_pos: jnp.ndarray  # [L,3]
    light_spectrum: jnp.ndarray  # [L,4]

    # Emissive-primitive sampling CDF (ref: src/scene/scene.cpp:165-208).
    emissive_prim: jnp.ndarray  # [E] i32 global prim index
    emissive_cdf: jnp.ndarray  # [E] f32 inclusive prefix sums, last == 1

    # Flat BVH, one primitive per leaf (ref builds one object per leaf,
    # src/scene/scene.cpp:12-102). bvh_prim >= 0 marks a leaf.
    bvh_lo: jnp.ndarray  # [N,3]
    bvh_hi: jnp.ndarray  # [N,3]
    bvh_left: jnp.ndarray  # [N] i32
    bvh_right: jnp.ndarray  # [N] i32
    bvh_prim: jnp.ndarray  # [N] i32, -1 on internal nodes

    # Two-level cluster BVH over triangles (accel/cluster.py): top tree
    # over clusters, triangle data pre-blocked
    # [C, L] so each leaf visit dense-tests a full cluster per lane.
    cl_lo: jnp.ndarray  # [Nc,3]
    cl_hi: jnp.ndarray  # [Nc,3]
    cl_left: jnp.ndarray  # [Nc] i32
    cl_right: jnp.ndarray  # [Nc] i32
    cl_leaf: jnp.ndarray  # [Nc] i32 cluster id on leaves, -1 internal
    blk_v0: jnp.ndarray  # [C, L, 3]
    blk_v1: jnp.ndarray  # [C, L, 3]
    blk_v2: jnp.ndarray  # [C, L, 3]
    blk_cull: jnp.ndarray  # [C, L] bool
    blk_prim: jnp.ndarray  # [C, L] i32 global prim index, -1 padding
    blk_lo: jnp.ndarray  # [C, 3] cluster bounds (sweep intersector)
    blk_hi: jnp.ndarray  # [C, 3]

    # Binned partition (accel="binned", ops/intersect.py
    # binned_intersect_ref): "big" triangles (AABB diagonal above a
    # fraction of the scene diagonal — walls, ground planes) are
    # dense-tested for every ray; only the small mesh triangles live in the
    # cluster blocks, so the cluster bounds stay tight.
    big_v0: jnp.ndarray  # [B,3]
    big_v1: jnp.ndarray  # [B,3]
    big_v2: jnp.ndarray  # [B,3]
    big_cull: jnp.ndarray  # [B] bool
    big_prim: jnp.ndarray  # [B] i32 global tri index, -1 padding

    # Static metadata (compile-time constants).
    n_tri: int
    n_sph: int
    n_point_lights: int
    n_emissive: int
    emissive_sample_count: int
    accel: str  # "dense" | "bvh" | "cluster" | "sweep" | "binned"
    bvh_depth: int
    cl_depth: int
    cluster_size: int
    n_big: int
    # Name of the mesh axis the cluster tables are sharded over
    # (geometry-parallel intersection, parallel/geometry.py). When set,
    # `scene_intersect` combines per-shard nearest hits with pmin
    # collectives; must be None outside shard_map.
    gp_axis: str | None = None

    @property
    def use_bvh(self) -> bool:
        return self.accel != "dense"

    @property
    def n_prims(self) -> int:
        return self.n_tri + self.n_sph

    @property
    def num_materials(self) -> int:
        return self.mat_diffuse.shape[0]


@dataclasses.dataclass
class HostSphere:
    center: np.ndarray
    radius: float
    material: int = -1


@dataclasses.dataclass
class Material:
    """Host-side material description (ref ConstantMaterial defaults:
    src/scene/material.cpp:19-36 + base Material defaults :3-17)."""

    diffuse: tuple = (1.0, 1.0, 1.0, 1.0)
    specular: tuple = (1.0, 1.0, 1.0, 1.0)
    ior: float = 1.0
    emission: tuple = (0.0, 0.0, 0.0, 0.0)
    bsdf: int = BSDF_LAMBERTIAN
    one_way: bool = False


class SceneBuilder:
    """Assembles primitives/materials/lights on the host, then packs SoA
    device arrays. The analog of constructing `Scene` in the reference
    (ref: src/scene/scene.cpp:153-181)."""

    def __init__(self):
        self._batches: list[TriangleBatch] = []
        self._spheres: list[HostSphere] = []
        self._materials: list[Material] = [Material()]  # id 0 = default white
        self._point_lights: list[tuple[np.ndarray, np.ndarray]] = []

    # -- materials -----------------------------------------------------------
    def add_material(self, material: Material | None = None, **kwargs) -> int:
        if material is None:
            material = Material(**kwargs)
        self._materials.append(material)
        return len(self._materials) - 1

    # -- geometry ------------------------------------------------------------
    def add_triangles(
        self,
        triangles: list[HostTriangle] | TriangleBatch,
        material: int | None = None,
    ):
        """Append triangles (a `HostTriangle` list or a columnar
        `TriangleBatch`); `material` overrides their material ids. Unset ids
        (-1) fall back to the default white material 0."""
        if isinstance(triangles, TriangleBatch):
            batch = triangles
        else:
            if material is not None:
                # Preserve the historical mutation contract for lists.
                for t in triangles:
                    t.material = material
            batch = TriangleBatch.from_triangles(triangles)
        if material is not None:
            batch = dataclasses.replace(
                batch,
                material=np.full(len(batch), material, np.int32),
            )
        else:
            batch = dataclasses.replace(
                batch, material=np.maximum(batch.material, 0).astype(np.int32)
            )
        self._batches.append(batch)
        return self

    def add_sphere(self, center, radius: float, material: int = 0):
        self._spheres.append(HostSphere(np.asarray(center, dtype=np.float64), float(radius), material))
        return self

    # -- lights ---------------------------------------------------------------
    def add_point_light(self, pos, spectrum):
        self._point_lights.append(
            (np.asarray(pos, dtype=np.float32), np.asarray(spectrum, dtype=np.float32))
        )
        return self

    # -- build ----------------------------------------------------------------
    def build(
        self,
        use_bvh: bool | None = None,
        dense_threshold: int = 128,
        accel: str | None = None,
        cluster_size: int | None = None,
        binned_threshold: int = 4096,
        big_diag_frac: float = 0.05,
    ) -> SceneData:
        """Pack the scene into SoA device arrays.

        `accel` selects the intersector: "dense" (all rays x all prims,
        best for small scenes), "bvh" (per-primitive-leaf tree, the
        reference layout), "cluster" (two-level cluster tree), "sweep"
        (dense-top candidate sweep), "binned" (big triangles dense-tested,
        the rest swept by cluster). Default: dense below `dense_threshold`
        primitives, binned above `binned_threshold` small triangles, sweep
        in between. `use_bvh` (bool) is the legacy switch mapping to
        "bvh"/"dense".
        """
        from ..accel.build import build_bvh
        from ..accel.cluster import build_cluster_bvh

        f32 = np.float32
        n_tri = sum(len(b) for b in self._batches)
        n_sph = len(self._spheres)

        tpad = max(n_tri, 1)
        spad = max(n_sph, 1)

        tri_v = np.zeros((3, tpad, 3), f32)
        tri_n = np.zeros((3, tpad, 3), f32)
        tri_n[:, :, 1] = 1.0  # harmless unit normal on padding lanes
        tri_cull = np.zeros(tpad, bool)
        tri_mat = np.zeros(tpad, np.int32)
        # Fill the padded f32 tables batch by batch instead of
        # concatenating the f64 batches first: the concat alone copies
        # ~1.4 GB (and costs ~8 s) at the 7.2M-triangle scale, all of it
        # immediately re-cast to f32 here anyway.
        off = 0
        for bt in self._batches:
            nb = len(bt)
            sl = slice(off, off + nb)
            tri_v[0, sl] = bt.v0
            tri_v[1, sl] = bt.v1
            tri_v[2, sl] = bt.v2
            tri_n[0, sl] = bt.n0
            tri_n[1, sl] = bt.n1
            tri_n[2, sl] = bt.n2
            tri_cull[sl] = bt.cull
            tri_mat[sl] = bt.material
            off += nb

        sph_c = np.full((spad, 3), 1e30, f32)
        sph_r = np.zeros(spad, f32)
        sph_mat = np.zeros(spad, np.int32)
        for i, s in enumerate(self._spheres):
            sph_c[i] = s.center
            sph_r[i] = s.radius
            sph_mat[i] = s.material

        n_mat = len(self._materials)
        mat_diffuse = np.zeros((n_mat, 4), f32)
        mat_specular = np.zeros((n_mat, 4), f32)
        mat_ior = np.zeros(n_mat, f32)
        mat_emission = np.zeros((n_mat, 4), f32)
        mat_bsdf = np.zeros(n_mat, np.int32)
        mat_one_way = np.zeros(n_mat, bool)
        for i, m in enumerate(self._materials):
            mat_diffuse[i] = m.diffuse
            mat_specular[i] = m.specular
            mat_ior[i] = m.ior
            mat_emission[i] = m.emission
            mat_bsdf[i] = m.bsdf
            mat_one_way[i] = m.one_way

        lpad = max(len(self._point_lights), 1)
        light_pos = np.zeros((lpad, 3), f32)
        light_spec = np.zeros((lpad, 4), f32)
        for i, (p, s) in enumerate(self._point_lights):
            light_pos[i] = p
            light_spec[i] = s

        # Emissive registry: power = (r+g+b)*a * surface area
        # (ref: src/scene/scene.cpp:183-208 registerEmissiveObjects).
        mat_em64 = np.array(
            [np.asarray(m.emission, np.float64) for m in self._materials]
        )
        mat_p = (mat_em64[:, 0] + mat_em64[:, 1] + mat_em64[:, 2]) * mat_em64[:, 3]
        tri_p = mat_p[tri_mat[:n_tri]]
        # Areas only for emissive-material candidates: a full-mesh
        # surface_areas() pass costs ~9 s at 7.2M triangles to weight the
        # (typically ~dozen) emitters. f64 math over the f32 vertices
        # (same math as TriangleBatch.surface_areas).
        cand = np.flatnonzero(tri_p > 0)
        e1 = (tri_v[1, cand] - tri_v[0, cand]).astype(np.float64)
        e2 = (tri_v[2, cand] - tri_v[0, cand]).astype(np.float64)
        cand_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        cand_power = tri_p[cand] * cand_area
        keep = cand_power > 0
        em_tri_idx = cand[keep]
        em_prims: list[int] = [int(i) for i in em_tri_idx]
        em_power: list[float] = [float(p) for p in cand_power[keep]]
        for i, s in enumerate(self._spheres):
            p = float(mat_p[s.material])
            if p > 0:
                area = 4.0 * PI * s.radius * s.radius
                if p * area > 0:
                    em_prims.append(n_tri + i)
                    em_power.append(p * area)

        n_emissive = len(em_prims)
        epad = max(n_emissive, 1)
        emissive_prim = np.zeros(epad, np.int32)
        emissive_cdf = np.ones(epad, f32)  # cdf 1 on padding so searchsorted stays in range
        if n_emissive > 0:
            emissive_prim[:n_emissive] = em_prims
            cdf = np.cumsum(np.asarray(em_power, np.float64))
            cdf /= cdf[-1]
            emissive_cdf[:n_emissive] = cdf.astype(f32)
        # Per-vertex NEE sample count (ref: src/scene/scene.cpp:226).
        emissive_sample_count = min(2 + int(np.log10(n_emissive + 1)), n_emissive)

        # BVH over all valid primitives.
        lo_tri = np.minimum(np.minimum(tri_v[0], tri_v[1]), tri_v[2])
        hi_tri = np.maximum(np.maximum(tri_v[0], tri_v[1]), tri_v[2])
        lo_sph = sph_c - sph_r[:, None]
        hi_sph = sph_c + sph_r[:, None]
        prim_lo = np.concatenate([lo_tri[:n_tri], lo_sph[:n_sph]], axis=0)
        prim_hi = np.concatenate([hi_tri[:n_tri], hi_sph[:n_sph]], axis=0)

        n_prims = n_tri + n_sph

        # Big/small triangle partition for the binned intersector: a
        # triangle whose AABB diagonal exceeds big_diag_frac of the scene
        # diagonal (walls, ground planes) is dense-tested per ray; small
        # mesh triangles go into the cluster blocks so the cluster set has
        # a tight root AABB that most rays never enter.
        if n_tri > 0:
            tri_diag = np.linalg.norm(hi_tri[:n_tri] - lo_tri[:n_tri], axis=1)
            scene_lo = np.minimum(
                lo_tri[:n_tri].min(axis=0),
                lo_sph[:n_sph].min(axis=0) if n_sph else np.full(3, np.inf),
            )
            scene_hi = np.maximum(
                hi_tri[:n_tri].max(axis=0),
                hi_sph[:n_sph].max(axis=0) if n_sph else np.full(3, -np.inf),
            )
            scene_diag = float(np.linalg.norm(scene_hi - scene_lo))
            big_mask = tri_diag > big_diag_frac * max(scene_diag, 1e-30)
            # Emissive triangles are forced into the dense partition (when
            # few): keeping emitters out of the cluster set spares every
            # shadow ray a cluster test that ends just short of the light.
            em_tri = np.asarray(
                [p for p in em_prims if p < n_tri], np.int64
            )
            if em_tri.size and em_tri.size <= 256:
                big_mask[em_tri] = True
        else:
            big_mask = np.zeros(0, bool)
        n_small = int(n_tri - big_mask.sum())

        if accel is None:
            if use_bvh is True:
                import warnings

                # The pointer-chasing per-lane walk is the reference's
                # layout, kept for parity testing.
                warnings.warn(
                    "use_bvh=True selects the per-lane BVH walk; prefer "
                    "accel=None (auto) or accel='binned' for large scenes.",
                    stacklevel=2,
                )
                accel = "bvh"
            elif use_bvh is False:
                accel = "dense"
            elif n_prims <= dense_threshold:
                accel = "dense"
            elif n_small >= binned_threshold:
                accel = "binned"
            else:
                accel = "sweep"
        if accel not in ("dense", "bvh", "cluster", "sweep", "binned"):
            raise ValueError(f"unknown accel {accel!r}")
        if accel == "binned" and n_small < 64:
            accel = "sweep"  # partition degenerate; candidate scan pointless
        if accel in ("cluster", "sweep", "binned") and n_tri == 0:
            accel = "dense" if n_prims <= dense_threshold else "bvh"

        if n_prims > 0:
            bvh = build_bvh(prim_lo, prim_hi)
        else:
            bvh = build_bvh(np.zeros((1, 3), f32), np.zeros((1, 3), f32))

        # Cluster structure over triangles (spheres are dense-tested by the
        # cluster intersector; scenes are sphere-light in practice).
        # For "binned" only the small-triangle partition is clustered; for
        # "cluster"/"sweep" every triangle is.
        n_big = 0
        big_idx = np.zeros(0, np.int64)
        if accel == "binned":
            small_idx = np.flatnonzero(~big_mask)
            big_idx = np.flatnonzero(big_mask)
            n_big = int(big_idx.shape[0])
            if cluster_size is None:
                # Keep the cluster count in the hundreds: the candidate
                # pass costs ~ n_clusters per ray, each candidate visit
                # ~ cluster_size.
                target = max(small_idx.shape[0] // 700, 128)
                cluster_size = int(
                    min(512, max(128, 1 << int(np.ceil(np.log2(target)))))
                )
                # Giant meshes: grow clusters so the cut fits MAX_CLUSTERS
                # (the BVH cut underfills, so aim well below the cap).
                floor = -(-int(small_idx.shape[0]) // (MAX_CLUSTERS // 2))
                cluster_size = max(cluster_size, floor)
            cluster_size = max(64, (cluster_size + 63) // 64 * 64)
        elif accel in ("cluster", "sweep"):
            small_idx = np.arange(n_tri)
            if cluster_size is None:
                cluster_size = 128
        if accel in ("cluster", "sweep", "binned"):
            cl = build_cluster_bvh(
                lo_tri[small_idx], hi_tri[small_idx], cluster_size=cluster_size
            )
            while accel == "binned" and cl.members.shape[0] > MAX_CLUSTERS:
                # The cut emits more clusters than MAX_CLUSTERS (possible
                # for adversarial BVH shapes even with the sizing above):
                # coarsen and retry.
                cluster_size *= 2
                cl = build_cluster_bvh(
                    lo_tri[small_idx], hi_tri[small_idx],
                    cluster_size=cluster_size,
                )
            # Remap cluster members (small-set local) to global tri indices.
            members = np.where(
                cl.members >= 0, small_idx[np.maximum(cl.members, 0)], -1
            ).astype(np.int32)
            blk_idx = np.maximum(members, 0)
            blk_v0 = tri_v[0][blk_idx]
            blk_v1 = tri_v[1][blk_idx]
            blk_v2 = tri_v[2][blk_idx]
            blk_cull = tri_cull[blk_idx]
            blk_prim = members
            blk_lo, blk_hi = cl.c_lo, cl.c_hi
            cl_arrays = (cl.lo, cl.hi, cl.left, cl.right, cl.cluster)
            cl_depth = cl.depth
        else:
            blk_v0 = blk_v1 = blk_v2 = np.zeros((1, 1, 3), f32)
            blk_cull = np.zeros((1, 1), bool)
            blk_prim = np.full((1, 1), -1, np.int32)
            blk_lo = np.zeros((1, 3), f32)
            blk_hi = np.zeros((1, 3), f32)
            cl_arrays = (
                np.zeros((1, 3), f32), np.zeros((1, 3), f32),
                np.full(1, -1, np.int32), np.full(1, -1, np.int32),
                np.full(1, -1, np.int32),
            )
            cl_depth = 1
            cluster_size = 1

        # Big-triangle dense set (binned only; empty rows otherwise).
        bpad = max(n_big, 1)
        big_v0 = np.zeros((bpad, 3), f32)
        big_v1 = np.zeros((bpad, 3), f32)
        big_v2 = np.zeros((bpad, 3), f32)
        big_cull = np.zeros(bpad, bool)
        big_prim = np.full(bpad, -1, np.int32)
        if n_big:
            big_v0[:n_big] = tri_v[0][big_idx]
            big_v1[:n_big] = tri_v[1][big_idx]
            big_v2[:n_big] = tri_v[2][big_idx]
            big_cull[:n_big] = tri_cull[big_idx]
            big_prim[:n_big] = big_idx

        return SceneData(
            tri_v0=jnp.asarray(tri_v[0]), tri_v1=jnp.asarray(tri_v[1]), tri_v2=jnp.asarray(tri_v[2]),
            tri_n0=jnp.asarray(tri_n[0]), tri_n1=jnp.asarray(tri_n[1]), tri_n2=jnp.asarray(tri_n[2]),
            tri_cull=jnp.asarray(tri_cull), tri_material=jnp.asarray(tri_mat),
            tri_valid=jnp.asarray(np.arange(tpad) < n_tri),
            sph_center=jnp.asarray(sph_c), sph_radius=jnp.asarray(sph_r),
            sph_material=jnp.asarray(sph_mat),
            sph_valid=jnp.asarray(np.arange(spad) < n_sph),
            mat_diffuse=jnp.asarray(mat_diffuse), mat_specular=jnp.asarray(mat_specular),
            mat_ior=jnp.asarray(mat_ior), mat_emission=jnp.asarray(mat_emission),
            mat_bsdf=jnp.asarray(mat_bsdf), mat_one_way=jnp.asarray(mat_one_way),
            light_pos=jnp.asarray(light_pos), light_spectrum=jnp.asarray(light_spec),
            emissive_prim=jnp.asarray(emissive_prim), emissive_cdf=jnp.asarray(emissive_cdf),
            bvh_lo=jnp.asarray(bvh.lo), bvh_hi=jnp.asarray(bvh.hi),
            bvh_left=jnp.asarray(bvh.left), bvh_right=jnp.asarray(bvh.right),
            bvh_prim=jnp.asarray(bvh.prim),
            cl_lo=jnp.asarray(cl_arrays[0]), cl_hi=jnp.asarray(cl_arrays[1]),
            cl_left=jnp.asarray(cl_arrays[2]), cl_right=jnp.asarray(cl_arrays[3]),
            cl_leaf=jnp.asarray(cl_arrays[4]),
            blk_v0=jnp.asarray(blk_v0), blk_v1=jnp.asarray(blk_v1),
            blk_v2=jnp.asarray(blk_v2), blk_cull=jnp.asarray(blk_cull),
            blk_prim=jnp.asarray(blk_prim),
            blk_lo=jnp.asarray(blk_lo), blk_hi=jnp.asarray(blk_hi),
            big_v0=jnp.asarray(big_v0), big_v1=jnp.asarray(big_v1),
            big_v2=jnp.asarray(big_v2), big_cull=jnp.asarray(big_cull),
            big_prim=jnp.asarray(big_prim),
            n_big=n_big,
            n_tri=n_tri, n_sph=n_sph,
            n_point_lights=len(self._point_lights),
            n_emissive=n_emissive,
            emissive_sample_count=emissive_sample_count,
            accel=accel,
            bvh_depth=int(bvh.depth),
            cl_depth=int(cl_depth),
            cluster_size=int(cluster_size),
        )
