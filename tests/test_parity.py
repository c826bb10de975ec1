"""Golden-image parity vs the compiled C++ reference.

The fixtures in tests/golden/ were rendered by the reference library built
from /root/reference (-O3, gcc 12.2) via a harness replicating its worker
call path (`processJob`), dumped as raw float32 [w,h | RGBA...] before any
post-processing:

  * golden_box_32.raw    — the inward-wound Cornell box of
    tests/scenes_util.py, camera (0,0,0)->(0,0,0.9), 32x32 @ 512 spp fixed
  * golden_sphere_32.raw — test/render_test.cpp SimpleSceneRenderTest
    geometry (point light + sphere), 32x32 @ 512 spp

The reference does not match *itself* pointwise at this sample count (median
per-pixel relative error between two reference runs: ~0.21, dominated by
NEE 1/r^2 fireflies), so parity is asserted on distribution statistics —
pixel quantiles, which two reference runs reproduce to ~1e-3 — plus the
exact alpha coverage mask.
"""
import dataclasses
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpupathtrace_tpu import RenderOptions, make_camera, SceneBuilder
from cpupathtrace_tpu.integrator.film import pixel_camera_coords, render_chunk

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def read_golden(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        w, h = struct.unpack("ii", f.read(8))
        return np.frombuffer(f.read(), np.float32).reshape(h, w, 4)


def render_fixed(scene, cam, size, spp, seed=3, max_depth=40, chunk=64):
    chunk = min(chunk, spp)  # spp < chunk would silently render 0 chunks
    opts = RenderOptions(size, size, spp, spp, max_depth=max_depth)
    xg, yg = np.meshgrid(
        np.arange(size, dtype=np.float32), np.arange(size, dtype=np.float32)
    )
    x, y = pixel_camera_coords(opts, xg.ravel(), yg.ravel())
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    tot = np.zeros((size * size, 4))
    cnt = np.zeros(size * size)
    for k in jax.random.split(jax.random.PRNGKey(seed), spp // chunk):
        s, c = render_chunk(scene, cam, opts, x, y, k, chunk)
        tot += np.asarray(s)
        cnt += np.asarray(c)
    img = tot / np.maximum(cnt, 1)[:, None]
    img[:, 3] = (cnt > 0).astype(np.float32)
    return img.reshape(size, size, 4).astype(np.float32)


def render_emissive_sphere():
    """The emissive-sphere golden's scene and camera, 32x32 @ 256 spp, on
    JAX's default device."""
    from tests.scenes_util import emissive_sphere_scene

    cam = make_camera((0, 0, 0), (0, 0, 0.9), (0, 1, 0), 1.0, 1.0, 1.0)
    return render_fixed(emissive_sphere_scene(), cam, 32, 256, seed=13)


def assert_quantile_parity(ours, golden, qs=(0.25, 0.5, 0.75), rtol=0.08):
    for q in qs:
        a = float(np.quantile(ours[..., :3], q))
        b = float(np.quantile(golden[..., :3], q))
        assert abs(a - b) <= rtol * max(abs(b), 1e-3), (q, a, b)


@pytest.mark.slow
def test_box_interior_parity():
    from tests.scenes_util import inward_box_scene

    golden = read_golden("golden_box_32.raw")
    scene = inward_box_scene()
    cam = make_camera((0, 0, 0), (0, 0, 0.9), (0, 1, 0), 1.0, 1.0, 1.0)
    ours = render_fixed(scene, cam, 32, 512)
    # Coverage identical: interior camera, every pixel hits.
    np.testing.assert_array_equal(ours[..., 3], golden[..., 3])
    # Radiance distribution parity (two reference runs agree to ~1e-3 on
    # the median; allow MC slack on ours).
    assert_quantile_parity(ours, golden)
    # q95 (tail shoulder) also within tolerance.
    assert_quantile_parity(ours, golden, qs=(0.95,), rtol=0.12)


@pytest.mark.slow
def test_sphere_point_light_parity():
    golden = read_golden("golden_sphere_32.raw")
    b = SceneBuilder()
    b.add_point_light((0.0, 1.0, 0.0), (1.0, 1.0, 1.0, 1.0))
    b.add_sphere((0.0, 0.0, 0.6), 0.5)
    scene = b.build()
    cam = make_camera((0, 0, 0), (0, 0, 1), (0, 1, 0), 0.1, 1.0, 1.0)
    ours = render_fixed(scene, cam, 32, 256)
    # Sphere silhouette: the alpha masks agree except possibly a 1-px rim
    # (sub-pixel jitter at the silhouette edge).
    diff = ours[..., 3] != golden[..., 3]
    assert diff.mean() < 0.02, diff.mean()
    # Lit-region radiance: compare means over the common coverage.
    mask = (ours[..., 3] > 0) & (golden[..., 3] > 0)
    a = ours[..., :3][mask].mean()
    g = golden[..., :3][mask].mean()
    assert abs(a - g) <= 0.1 * g, (a, g)


@pytest.mark.slow
def test_specular_box_parity():
    """Tinted mirror + glass spheres in the closed box (scenes_util.py::
    specular_box_scene) vs the compiled C++ reference — the only golden
    that exercises `mat_specular` through both specular eval paths
    (MirrorBRDF reflection tint + GlassBDF reflect/refract,
    ref: src/scene/propagation.cpp:120-214). Generated by
    tests/golden/make_golden_specular.cpp at 512 spp.

    Measured anchors (2026-08-18): reference-vs-reference central
    quantiles agree to <=3.4%; ours-vs-reference at 512 spp to <=1.8%.
    The q95 tail differs systematically (+13%): the reference ALWAYS runs
    its biased lowest-stddev candidate selection (worker.cpp:273-317,
    allow_bias is never read), clamping fireflies that our honest
    unbiased mean keeps — hence the wide documented tail bound."""
    from tests.scenes_util import specular_box_scene

    golden = read_golden("golden_specular_32.raw")
    scene, _, _ = specular_box_scene()
    cam = make_camera((0, 0, 0), (0, 0, 0.9), (0, 1, 0), 1.0, 1.0, 1.0)
    ours = render_fixed(scene, cam, 32, 512, seed=7)
    np.testing.assert_array_equal(ours[..., 3], golden[..., 3])
    assert_quantile_parity(ours, golden, qs=(0.25, 0.5, 0.75), rtol=0.10)
    assert_quantile_parity(ours, golden, qs=(0.95,), rtol=0.25)


@pytest.mark.slow
def test_thin_lens_parity():
    """Thin lens + circular aperture over the panel-lit box vs the C++
    reference (golden by tests/golden/make_golden_lens.cpp, 512 spp) — the
    only golden through the aperture/lens ray path (camera.cpp:78-113,
    incl. the up/right offset quirk at :99). Measured rel err at 256 spp:
    <=5% on central quantiles (the dark q25 converges one-sidedly and
    needs the full 256 spp; 128 spp overshoots the 0.10 bound)."""
    from tests.scenes_util import inward_box_scene
    from cpupathtrace_tpu.camera.camera import APERTURE_CIRCULAR

    golden = read_golden("golden_lens_32.raw")
    scene = inward_box_scene()
    cam = make_camera(
        (0, 0, 0), (0, 0, 0.9), (0, 1, 0), 1.0, 1.0, 1.0,
        aperture_width=0.1, aperture_height=0.1,
        aperture=APERTURE_CIRCULAR, focal_plane_dist=1.5,
    )
    ours = render_fixed(scene, cam, 32, 256, seed=9)
    np.testing.assert_array_equal(ours[..., 3], golden[..., 3])
    assert_quantile_parity(ours, golden, qs=(0.25, 0.5, 0.75), rtol=0.10)


@pytest.mark.slow
def test_hex_aperture_parity():
    """Hexagonal aperture (ratio 0.6) + thin lens vs the C++ reference:
    validates the fixed-round rejection sampler's distribution against the
    reference's unbounded rejection loop (camera.cpp:21-49) end-to-end.
    Measured rel err at 256 spp: <=5.7% on central quantiles."""
    from tests.scenes_util import inward_box_scene
    from cpupathtrace_tpu.camera.camera import APERTURE_HEXAGONAL

    golden = read_golden("golden_hex_32.raw")
    scene = inward_box_scene()
    cam = make_camera(
        (0, 0, 0), (0, 0, 0.9), (0, 1, 0), 1.0, 1.0, 1.0,
        aperture_width=0.12, aperture_height=0.12,
        aperture=APERTURE_HEXAGONAL, hex_horizontal_ratio=0.6,
        focal_plane_dist=1.5,
    )
    ours = render_fixed(scene, cam, 32, 256, seed=21)
    np.testing.assert_array_equal(ours[..., 3], golden[..., 3])
    assert_quantile_parity(ours, golden, qs=(0.25, 0.5, 0.75), rtol=0.10)


@pytest.mark.slow
def test_emissive_sphere_parity():
    """An emissive SPHERE as the only light vs the C++ reference (golden by
    tests/golden/make_golden_lens.cpp, 512 spp): pins sphere area-light
    registration (power = (r+g+b)*a*4*pi*r^2), the emissive CDF, uniform
    sphere surface sampling and the area->solid-angle pdf conversion
    (scene.cpp:183-289, object.cpp:101-116). Measured rel err at 256 spp:
    <=4.5% on central quantiles."""
    golden = read_golden("golden_emsphere_32.raw")
    ours = render_emissive_sphere()
    np.testing.assert_array_equal(ours[..., 3], golden[..., 3])
    assert_quantile_parity(ours, golden, qs=(0.25, 0.5, 0.75), rtol=0.10)


@pytest.mark.slow
def test_dragon_box_parity():
    """Dragon-box benchmark scene (20k-tri stand-in mesh as glass, cluster
    accel) vs the reference golden at 32x32 @ 256 spp — validates the
    large-scene path end-to-end (OBJ load, smooth normals, cluster BVH,
    glass BSDF) against the compiled C++ reference."""
    from cpupathtrace_tpu.models.scenes import bench_dragon_scene, bench_camera

    golden = read_golden("golden_dragon_32.raw")
    scene = bench_dragon_scene(dragon_tris=20000)
    assert scene.accel in ("cluster", "sweep", "binned")
    cam = bench_camera()
    ours = render_fixed(scene, cam, 32, 64, seed=11, max_depth=32)
    # Coverage: camera outside the closed box; every pixel that hits in one
    # render hits in the other (deterministic geometry).
    np.testing.assert_array_equal(ours[..., 3], golden[..., 3])
    # 64 spp (suite-time budget): central quantiles are stable (measured
    # rel err 0.02-0.08 at this spp); the dark q25 converges one-sidedly
    # through glass caustics (measured 0.21 at 64 spp vs 0.07 at 128) and
    # gets a correspondingly wider MC bound.
    assert_quantile_parity(ours, golden, qs=(0.5, 0.75), rtol=0.12)
    assert_quantile_parity(ours, golden, qs=(0.25,), rtol=0.3)


@pytest.mark.slow
def test_adaptive_bias_parity():
    """ADAPTIVE sampling (min 16 < max 64) vs the C++ reference
    (tests/golden/make_golden_adaptive.cpp): engages the Welford
    early-accept rule and the candidate-batch selection
    (worker.cpp:158-317) — the estimator surface fixed-spp goldens skip.
    The reference's candidate selection always runs (its allow_bias flag
    is dead) and biases DOWNWARD on right-skewed radiance, so parity
    holds only with allow_bias=True; the honest unbiased default renders
    ~16% brighter. Measured: ours-vs-golden <=5% on central quantiles
    (two reference runs self-agree to ~8% at q75); bounded at 15%."""
    from tests.scenes_util import inward_box_scene
    from cpupathtrace_tpu import render

    golden = read_golden("golden_adaptive_32.raw")
    scene = inward_box_scene()
    cam = make_camera((0, 0, 0), (0, 0, 0.9), (0, 1, 0), 1.0, 1.0, 1.0)
    opts = RenderOptions(
        32, 32, 16, 64, epsilon=1e-3, max_depth=40, allow_bias=True
    )
    ours = np.asarray(render(scene, cam, opts, seed=5))
    np.testing.assert_array_equal(ours[..., 3], golden[..., 3])
    assert_quantile_parity(ours, golden, qs=(0.25, 0.5, 0.75), rtol=0.15)

    # The honest unbiased estimator must sit ABOVE the biased one (the
    # reference's selection discards firefly-heavy candidate batches).
    unbiased = np.asarray(
        render(scene, cam, dataclasses.replace(opts, allow_bias=False),
               seed=5)
    )
    assert unbiased[..., :3].mean() > ours[..., :3].mean() * 1.05


@pytest.mark.slow
def test_one_way_mirror_parity():
    """One-way mirror pane (MirrorBRDF(one_way=true)) in the panel-lit box
    vs the C++ reference (tests/golden/make_golden_oneway.cpp, 512 spp):
    pins the backface pass-through branch and the dot(in,out)-based tint
    opt-out (propagation.cpp:184-217) that no other golden exercises.
    The scene is firefly-heavy (specular chains to the panel: two
    reference runs' MEANS differ 3x), so parity needs the reference's
    always-on candidate selection replicated — allow_bias=True at matched
    512 spp agrees to ~2% on central quantiles (cross-run golden spread
    ~2-4%); plain 256-spp means sit a systematic ~7% off at q25."""
    from tests.scenes_util import inward_box_scene  # noqa: F401 (doc link)
    from cpupathtrace_tpu import render
    from cpupathtrace_tpu.scene.geometry import make_plane
    from cpupathtrace_tpu.scene.scene import BSDF_MIRROR

    golden = read_golden("golden_oneway_32.raw")
    b = SceneBuilder()
    white = b.add_material(diffuse=(1, 1, 1, 1))
    light = b.add_material(diffuse=(1, 1, 1, 1), emission=(1, 1, 1, 1))
    oneway = b.add_material(
        diffuse=(1, 1, 1, 1), specular=(1, 0.35, 0.35, 1),
        bsdf=BSDF_MIRROR, one_way=True,
    )
    b.add_triangles(make_plane((1, -1, -1), (-1, -1, 1), True), white)
    b.add_triangles(make_plane((-1, 1, -1), (1, 1, 1), True), white)
    b.add_triangles(
        make_plane((-0.25, 0.99, -0.25), (0.25, 0.99, 0.25), True), light
    )
    b.add_triangles(make_plane((-1, -1, -1), (1, 1, -1), True), white)
    b.add_triangles(make_plane((-1, -1, -1), (-1, 1, 1), True), white)
    b.add_triangles(make_plane((1, -1, 1), (-1, 1, 1), True), white)
    b.add_triangles(make_plane((1, -1, 1), (1, 1, -1), True), white)
    b.add_triangles(make_plane((-0.6, -0.6, 0.3), (0.6, 0.6, 0.3), False),
                    oneway)
    scene = b.build()
    cam = make_camera((0, 0, 0), (0, 0, 0.9), (0, 1, 0), 1.0, 1.0, 1.0)
    opts = RenderOptions(
        32, 32, 512, 512, epsilon=1e-3, max_depth=40, allow_bias=True
    )
    ours = np.asarray(render(scene, cam, opts, seed=11))
    np.testing.assert_array_equal(ours[..., 3], golden[..., 3])
    assert_quantile_parity(ours, golden, qs=(0.25, 0.5, 0.75), rtol=0.10)
