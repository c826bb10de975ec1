"""Shared test scenes.

The reference never flips shading normals: orientation comes purely from
triangle winding (ref: src/scene/object.cpp:126-144, worker.cpp:55). For
interior-lit tests the walls must therefore wind inward, exactly like the
demo app's corner ordering (ref: demo/main.cpp:66-135).
"""
from cpupathtrace_tpu.scene.scene import SceneBuilder
from cpupathtrace_tpu.scene.geometry import make_plane


def inward_box_scene(light_intensity: float = 1.0):
    """A closed 2x2x2 Cornell box with inward-facing walls and an emissive
    ceiling panel (demo-style windings, ref: demo/main.cpp:66-135)."""
    b = SceneBuilder()
    white = b.add_material(diffuse=(1, 1, 1, 1))
    li = light_intensity
    light = b.add_material(diffuse=(1, 1, 1, 1), emission=(li, li, li, 1.0))
    # Corner orders copied from the demo so every normal faces the interior.
    b.add_triangles(make_plane((1, -1, -1), (-1, -1, 1), True), white)   # floor +y
    b.add_triangles(make_plane((-1, 1, -1), (1, 1, 1), True), white)     # ceiling -y
    b.add_triangles(make_plane((-0.25, 0.99, -0.25), (0.25, 0.99, 0.25), True), light)
    b.add_triangles(make_plane((-1, -1, -1), (1, 1, -1), True), white)   # back +z
    b.add_triangles(make_plane((-1, -1, -1), (-1, 1, 1), True), white)   # left +x
    b.add_triangles(make_plane((1, -1, 1), (-1, 1, 1), True), white)     # front -z
    b.add_triangles(make_plane((1, -1, 1), (1, 1, -1), True), white)     # right -x
    return b.build()


def specular_box_scene(light_intensity: float = 1.0):
    """inward_box_scene plus a tinted mirror sphere and a glass sphere —
    the smallest scene whose image depends on `mat_specular` through both
    specular eval paths (glass reflection + mirror bounce,
    ref: src/scene/propagation.cpp:120-214).

    Returns (scene, mirror_material_id, glass_material_id)."""
    from cpupathtrace_tpu.scene.scene import BSDF_GLASS, BSDF_MIRROR

    b = SceneBuilder()
    white = b.add_material(diffuse=(1, 1, 1, 1))
    li = light_intensity
    light = b.add_material(diffuse=(1, 1, 1, 1), emission=(li, li, li, 1.0))
    b.add_triangles(make_plane((1, -1, -1), (-1, -1, 1), True), white)
    b.add_triangles(make_plane((-1, 1, -1), (1, 1, 1), True), white)
    b.add_triangles(make_plane((-0.25, 0.99, -0.25), (0.25, 0.99, 0.25), True), light)
    b.add_triangles(make_plane((-1, -1, -1), (1, 1, -1), True), white)
    b.add_triangles(make_plane((-1, -1, -1), (-1, 1, 1), True), white)
    b.add_triangles(make_plane((1, -1, 1), (-1, 1, 1), True), white)
    b.add_triangles(make_plane((1, -1, 1), (1, 1, -1), True), white)
    mirror = b.add_material(
        diffuse=(0, 0, 1, 1), specular=(0.2, 0.4, 0.9, 1.0), bsdf=BSDF_MIRROR
    )
    glass = b.add_material(
        diffuse=(1, 1, 1, 1), specular=(0.9, 0.6, 0.3, 1.0), ior=1.5,
        bsdf=BSDF_GLASS,
    )
    b.add_sphere((-0.4, -0.3, 0.5), 0.4, mirror)
    b.add_sphere((0.45, -0.35, 0.45), 0.35, glass)
    return b.build(), mirror, glass


EMSPHERE_CENTER = (0.0, 0.55, 0.5)
EMSPHERE_RADIUS = 0.25


def emissive_sphere_scene():
    """The closed white box lit only by an emissive sphere
    (golden_emsphere_32.raw, tests/golden/make_golden_lens.cpp)."""
    b = SceneBuilder()
    white = b.add_material(diffuse=(1, 1, 1, 1))
    em = b.add_material(diffuse=(1, 1, 1, 1), emission=(2, 2, 2, 1))
    b.add_triangles(make_plane((1, -1, -1), (-1, -1, 1), True), white)
    b.add_triangles(make_plane((-1, 1, -1), (1, 1, 1), True), white)
    b.add_triangles(make_plane((-1, -1, -1), (1, 1, -1), True), white)
    b.add_triangles(make_plane((-1, -1, -1), (-1, 1, 1), True), white)
    b.add_triangles(make_plane((1, -1, 1), (-1, 1, 1), True), white)
    b.add_triangles(make_plane((1, -1, 1), (1, 1, -1), True), white)
    b.add_sphere(EMSPHERE_CENTER, EMSPHERE_RADIUS, em)
    return b.build()
