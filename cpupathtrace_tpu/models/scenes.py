"""Built-in scenes, mirroring the reference's demo and benchmark scenes.

  * cornell_demo_scene — the demo app's Cornell-box-type scene: colored walls,
    emissive ceiling panel, glass dragon mesh, blue mirror sphere, rotated
    stretched white box (ref: demo/main.cpp:36-205)
  * bench_box_scene — closed 2x2x2 Cornell box, 12 wall triangles + 2 emissive
    ceiling triangles (ref: benchmark/main.cpp:34-57)
  * bench_dragon_scene — same box + the dragon mesh as glass, IOR 1.5
    (ref: benchmark/main.cpp:59-105)

The upstream xyzrgb_dragon.obj asset is a missing LFS blob in the reference
checkout; `standin_dragon_obj` procedurally generates a high-triangle-count
stand-in (a displaced icosphere) so the BVH/benchmark paths can be exercised
at a configurable triangle count.
"""
from __future__ import annotations

import math

import numpy as np

from ..camera.camera import APERTURE_CIRCULAR, Camera, make_camera
from ..core.config import RenderOptions
from ..scene.geometry import make_box, make_plane, transform_triangles
from ..scene.mesh import load_mesh, mesh_from_arrays
from ..scene.scene import (
    BSDF_GLASS,
    BSDF_LAMBERTIAN,
    BSDF_MIRROR,
    Material,
    SceneBuilder,
    SceneData,
)


def cornell_demo_camera(width: int = 256, height: int = 256) -> Camera:
    """The demo camera: thin lens, circular aperture 0.05, focal plane 3.5,
    negative aspect ratio (ref: demo/main.cpp:36-48)."""
    aspect = width / height
    return make_camera(
        origin=(0.0, 0.0, -3.0),
        look_at=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        focal_length=1.0,
        height=1.0,
        aspect_ratio=-aspect,
        aperture_width=0.05,
        aperture_height=0.05,
        aperture=APERTURE_CIRCULAR,
        focal_plane_dist=3.5,
    )


def cornell_demo_scene(
    dragon_obj: str | None = None,
    dragon_tris: int = 20000,
    include_dragon: bool = True,
) -> SceneData:
    """The demo scene (ref: demo/main.cpp:50-205). `dragon_obj` may point to a
    real xyzrgb_dragon.obj; otherwise a procedural stand-in is used."""
    b = SceneBuilder()
    epsilon = 1e-3
    light_intensity = 1.0
    ground_y, ceiling_y = -1.0, 1.0
    walls_x, walls_z = 1.0, 1.0

    white = b.add_material(diffuse=(1, 1, 1, 1))
    blue = b.add_material(diffuse=(0, 0, 1, 1))
    red = b.add_material(diffuse=(1, 0, 0, 1))
    green = b.add_material(diffuse=(0, 1, 0, 1))
    light = b.add_material(
        diffuse=(1, 1, 1, 1),
        emission=(light_intensity, light_intensity, light_intensity, 1.0),
    )

    b.add_triangles(make_plane((20, ground_y, -20), (-20, ground_y, 20), True), white)
    b.add_triangles(make_plane((-20, ceiling_y, -20), (20, ceiling_y, 20), True), white)
    b.add_triangles(
        make_plane((-0.25, ceiling_y - epsilon, -0.25), (0.25, ceiling_y - epsilon, 0.25), True),
        light,
    )
    b.add_triangles(make_plane((-walls_x, ground_y, -walls_z), (walls_x, ceiling_y, -walls_z), True), blue)
    b.add_triangles(make_plane((-walls_x, ground_y, -walls_z), (-walls_x, ceiling_y, walls_z), True), red)
    b.add_triangles(make_plane((walls_x, ground_y, walls_z), (-walls_x, ceiling_y, walls_z), True), white)
    b.add_triangles(make_plane((walls_x, ground_y, walls_z), (walls_x, ceiling_y, -walls_z), True), green)

    if include_dragon:
        # Glass dragon, scale 0.005, offset (0.4, -0.8, -0.75), IOR 1.5
        # (ref: demo/main.cpp:144-165).
        glass = b.add_material(diffuse=(1, 1, 1, 1), ior=1.5, bsdf=BSDF_GLASS)
        transform = np.array(
            [
                [0.005, 0, 0, 0.4],
                [0, 0.005, 0, -0.8],
                [0, 0, 0.005, -0.75],
                [0, 0, 0, 1.0],
            ]
        )
        if dragon_obj is not None:
            tris = load_mesh(dragon_obj, transform, cull_backface=False,
                             smooth=True, as_batch=True)
        else:
            verts, faces = standin_dragon_arrays(dragon_tris)
            tris = mesh_from_arrays(
                verts, faces, transform,
                cull_backface=False, smooth=True, as_batch=True,
            )
        b.add_triangles(tris, glass)

    # Blue mirror sphere (ref: demo/main.cpp:168-177).
    mirror_blue = b.add_material(diffuse=(0, 0, 1, 1), bsdf=BSDF_MIRROR)
    b.add_sphere((0.5, -0.5, 0.5), 0.5, mirror_blue)

    # Rotated, vertically stretched white box (ref: demo/main.cpp:179-203).
    rot_y = 0.25
    c, s = math.cos(rot_y), math.sin(rot_y)
    transform = np.array(
        [
            [c, 0, s, -0.5],
            [0, 3.0, 0, -0.25],
            [-s, 0, c, 0.5],
            [0, 0, 0, 1.0],
        ]
    )
    box = transform_triangles(make_box((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3)), transform)
    b.add_triangles(box, white)

    return b.build()


def cornell_demo_options(width: int = 256, height: int = 256, **kw) -> RenderOptions:
    defaults = dict(
        image_width=width, image_height=height,
        min_sample_count=16, max_sample_count=64,
        epsilon=1e-3, allow_bias=True,
    )
    defaults.update(kw)
    return RenderOptions(**defaults)


def bench_box_scene() -> SceneData:
    """Closed Cornell box benchmark scene (ref: benchmark/main.cpp:34-57)."""
    b = SceneBuilder()
    white = b.add_material(diffuse=(1, 1, 1, 1))
    light = b.add_material(diffuse=(1, 1, 1, 1), emission=(1, 1, 1, 1))
    b.add_triangles(make_box((-1, -1, -1), (1, 1, 1)), white)
    b.add_triangles(make_plane((-0.25, 1.0 - 0.01, -0.25), (0.25, 1.0 - 0.01, 0.25)), light)
    return b.build()


def bench_camera() -> Camera:
    """Pinhole benchmark camera with aspect -1 (ref: benchmark/main.cpp:35,60)."""
    return make_camera(
        origin=(0, 0, -3), look_at=(0, 0, 0), up=(0, 1, 0),
        focal_length=1.0, height=1.0, aspect_ratio=-1.0,
    )


def bench_dragon_scene(
    dragon_obj: str | None = None,
    dragon_tris: int = 200000,
    accel: str | None = None,
    cluster_size: int | None = None,
) -> SceneData:
    """Box + glass dragon at scale 0.01, offset (0,-0.5,0)
    (ref: benchmark/main.cpp:59-105)."""
    b = SceneBuilder()
    white = b.add_material(diffuse=(1, 1, 1, 1))
    light = b.add_material(diffuse=(1, 1, 1, 1), emission=(1, 1, 1, 1))
    glass = b.add_material(diffuse=(1, 1, 1, 1), ior=1.5, bsdf=BSDF_GLASS)
    b.add_triangles(make_box((-1, -1, -1), (1, 1, 1)), white)
    b.add_triangles(
        make_plane((-0.25, 1.0 - 0.01, -0.25), (0.25, 1.0 - 0.01, 0.25), True), light
    )
    transform = np.array(
        [[0.01, 0, 0, 0], [0, 0.01, 0, -0.5], [0, 0, 0.01, 0], [0, 0, 0, 1.0]]
    )
    if dragon_obj is not None:
        tris = load_mesh(dragon_obj, transform, cull_backface=False,
                         smooth=True, as_batch=True)
    else:
        # Procedural stand-in straight from arrays: same geometry as the
        # OBJ text route at its %.6f precision, minus ~60 s of text
        # serialization at the 7.2M-triangle scale.
        verts, faces = standin_dragon_arrays(dragon_tris)
        tris = mesh_from_arrays(
            verts, faces, transform, cull_backface=False,
            smooth=True, as_batch=True,
        )
    b.add_triangles(tris, glass)
    return b.build(accel=accel, cluster_size=cluster_size)


def standin_dragon_arrays(
    target_tris: int = 200000, seed: int = 7
) -> tuple[np.ndarray, np.ndarray]:
    """The stand-in dragon as (verts [V,3] f64, faces [F,3] 0-based i64),
    with vertices rounded to 6 decimals — the precision the OBJ text path
    (`standin_dragon_obj`, "%.6f") carries — so feeding these through
    `mesh_from_arrays` matches the write-OBJ-then-parse route without
    paying ~60 s of text serialization at the 7.2M-triangle scale."""
    verts, faces = _standin_dragon_geometry(target_tris, seed)
    return np.round(verts.reshape(-1, 3), 6), faces - 1


def standin_dragon_obj(target_tris: int = 200000, seed: int = 7) -> str:
    """Procedural stand-in for the missing xyzrgb_dragon.obj LFS asset
    (.MISSING_LARGE_BLOBS:1): a UV sphere displaced by a few octaves of
    sinusoidal noise, scaled to roughly the dragon's coordinate range
    (the demo transform's 0.005 scale suggests an asset spanning ~100 units).

    Returns OBJ text with ~target_tris triangles.
    """
    verts, faces = _standin_dragon_geometry(target_tris, seed)
    out = ["# procedural stand-in for xyzrgb_dragon.obj"]
    vflat = verts.reshape(-1, 3)
    out.extend(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in vflat)
    out.extend(f"f {f[0]} {f[1]} {f[2]}" for f in faces)
    return "\n".join(out) + "\n"


def _standin_dragon_geometry(
    target_tris: int, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """Raw stand-in geometry: verts [rows+1, cols, 3] f64 (unquantized)
    and 1-BASED faces [F, 3] i64 (OBJ convention)."""
    # A UV sphere with R rows and C columns has 2*R*C triangles.
    rows = max(int(math.sqrt(target_tris / 4)), 3)
    cols = 2 * rows
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0, 2 * np.pi, size=(3, 3))

    theta = np.linspace(0, np.pi, rows + 1)
    phi = np.linspace(0, 2 * np.pi, cols, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    x = np.sin(t) * np.cos(p)
    y = np.cos(t)
    z = np.sin(t) * np.sin(p)

    # Low-frequency displacement for BVH-relevant irregularity.
    disp = np.zeros_like(x)
    for o in range(3):
        f = 2.0 ** (o + 1)
        disp += (
            np.sin(f * t + phases[o, 0])
            * np.cos(f * p + phases[o, 1])
            * (0.25 / f)
        )
    r = 1.0 + disp
    # Stretch to a dragon-ish elongated shape, scale to ~80-unit span.
    verts = np.stack([x * r * 1.6, y * r * 0.9, z * r * 0.7], axis=-1) * 40.0

    vid = np.arange((rows + 1) * cols).reshape(rows + 1, cols)
    faces = []
    for i in range(rows):
        a = vid[i]
        bb = vid[i + 1]
        a_n = np.roll(a, -1)
        b_n = np.roll(bb, -1)
        if i > 0:  # skip degenerate fan at the pole
            faces.append(np.stack([a, bb, a_n], axis=-1))
        if i < rows - 1:
            faces.append(np.stack([a_n, bb, b_n], axis=-1))
    faces = np.concatenate(faces, axis=0) + 1  # OBJ is 1-based
    return verts, faces
