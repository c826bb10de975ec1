"""Differentiable-rendering tests: the north-star gradient contract —
analytic gradients match finite differences under common random numbers
(capability absent from the C++ reference)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpupathtrace_tpu import RenderOptions, make_camera
from cpupathtrace_tpu.diff import (
    apply_material_params,
    finite_difference_grad,
    get_material_params,
    image_loss,
    inverse_render,
    render_image_diff,
)
from tests.scenes_util import inward_box_scene, specular_box_scene


@pytest.fixture(scope="module")
def setup():
    scene = inward_box_scene()
    cam = make_camera((0, 0, 0), (0, 0, 0.9), (0, 1, 0))
    # max_depth=4: roulette p == 1, so there are no detached decision
    # thresholds and FD matches the analytic gradient exactly (see
    # diff/render.py module docstring).
    opts = RenderOptions(6, 6, 8, 8, max_depth=4)
    key = jax.random.PRNGKey(0)
    target = render_image_diff(scene, cam, opts, jax.random.PRNGKey(99), 8)
    target = jax.lax.stop_gradient(target)
    return scene, cam, opts, key, target


def test_render_image_diff_matches_forward(setup):
    scene, cam, opts, key, _ = setup
    img = render_image_diff(scene, cam, opts, key, 8)
    assert img.shape == (36, 4)
    assert bool(jnp.all(jnp.isfinite(img)))
    assert float(img[:, :3].mean()) > 0.0


@pytest.mark.parametrize(
    "field,index",
    [
        ("mat_diffuse", (1, 0)),   # wall albedo red channel (material 1)
        ("mat_diffuse", (1, 1)),
        ("mat_emission", (2, 0)),  # panel emission red channel (material 2)
        ("mat_emission", (2, 2)),
    ],
)
def test_gradient_matches_finite_difference(setup, field, index):
    scene, cam, opts, key, target = setup
    params = get_material_params(scene)

    grad_fn = jax.grad(image_loss)
    g = grad_fn(params, scene, cam, opts, target, key, 8)
    analytic = float(g[field][index])

    fd = finite_difference_grad(
        params, scene, cam, opts, target, key, 8, field, index, eps=2e-3
    )
    assert np.isfinite(analytic)
    # Common random numbers: both sides share every sampling decision, so
    # the only difference is the smooth radiance dependence.
    np.testing.assert_allclose(analytic, fd, rtol=0.05, atol=1e-4)


def test_gradients_nonzero_where_expected(setup):
    scene, cam, opts, key, target = setup
    params = get_material_params(scene)
    g = jax.grad(image_loss)(params, scene, cam, opts, target, key, 8)
    # Wall albedo and panel emission both influence the image.
    assert float(jnp.abs(g["mat_diffuse"][1]).sum()) > 0.0
    assert float(jnp.abs(g["mat_emission"][2]).sum()) > 0.0
    # The default material 0 is unused by any primitive: zero gradient.
    np.testing.assert_allclose(np.asarray(g["mat_diffuse"][0]), 0.0)
    assert bool(jnp.all(jnp.isfinite(g["mat_diffuse"])))


@pytest.fixture(scope="module")
def spec_setup():
    scene, mirror, glass = specular_box_scene()
    cam = make_camera((0, 0, -0.9), (0, -0.25, 0.5), (0, 1, 0))
    opts = RenderOptions(8, 8, 8, 8, max_depth=4)
    key = jax.random.PRNGKey(3)
    target = render_image_diff(scene, cam, opts, jax.random.PRNGKey(77), 8)
    return scene, cam, opts, key, jax.lax.stop_gradient(target), mirror, glass


@pytest.mark.parametrize("which,channel", [
    ("mirror", 0), ("mirror", 2), ("glass", 0), ("glass", 1),
])
def test_specular_gradient_matches_finite_difference(spec_setup, which, channel):
    """mat_specular gradients flow through the glass-reflection and mirror
    bounce eval paths (ref: propagation.cpp:120-214) — FD parity under
    common random numbers."""
    scene, cam, opts, key, target, mirror, glass = spec_setup
    mat = mirror if which == "mirror" else glass
    params = get_material_params(scene)

    g = jax.grad(image_loss)(params, scene, cam, opts, target, key, 8)
    analytic = float(g["mat_specular"][mat, channel])
    fd = finite_difference_grad(
        params, scene, cam, opts, target, key, 8,
        "mat_specular", (mat, channel), eps=2e-3,
    )
    assert np.isfinite(analytic)
    assert abs(analytic) > 0.0, "specular gradient unexpectedly zero"
    np.testing.assert_allclose(analytic, fd, rtol=0.05, atol=1e-4)


def test_inverse_rendering_recovers_specular_tint(spec_setup):
    """Gradient descent recovers a perturbed mirror specular tint — the
    specular analog of the albedo recovery demo."""
    scene, cam, opts, key, _, mirror, glass = spec_setup
    true_params = get_material_params(scene)
    target = render_image_diff(scene, cam, opts, jax.random.PRNGKey(11), 16)
    target = jax.lax.stop_gradient(target)

    init = {
        "mat_specular": true_params["mat_specular"].at[mirror, :3].set(0.55)
    }
    recovered, losses = inverse_render(
        scene, cam, opts, target, init, steps=50, learning_rate=0.05, spp=8
    )
    assert losses[-1] < losses[0]
    rec = np.asarray(recovered["mat_specular"][mirror, :3])
    true = np.asarray(true_params["mat_specular"][mirror, :3])
    init_v = np.full(3, 0.55)
    # Each channel moves toward its true value (blue up, red down).
    assert np.abs(rec - true).sum() < np.abs(init_v - true).sum(), rec


def test_inverse_rendering_recovers_albedo(setup):
    """Gradient descent recovers a perturbed wall albedo (tiny version of
    examples/inverse_render.py)."""
    scene, cam, opts, key, _ = setup
    true_params = get_material_params(scene)
    target = render_image_diff(scene, cam, opts, jax.random.PRNGKey(7), 16)
    target = jax.lax.stop_gradient(target)

    # Optimize only the diffuse table: with emission also free, a darker
    # albedo + emissive walls explains the target equally well (inverse
    # problem ambiguity), so pin the emitters at truth.
    init = {"mat_diffuse": true_params["mat_diffuse"].at[1, :3].set(0.3)}

    recovered, losses = inverse_render(
        scene, cam, opts, target, init, steps=60, learning_rate=0.05, spp=8
    )
    # Loss decreases and the wall albedo moves toward white.
    assert losses[-1] < losses[0]
    rec = np.asarray(recovered["mat_diffuse"][1, :3])
    assert np.all(rec > 0.55), rec


def test_gradients_flow_through_binned_scene():
    """Material gradients are finite and nonzero through the binned
    large-scene path (clusters are geometry — non-differentiable — but the
    radiance-side material products must still carry grads)."""
    from cpupathtrace_tpu.models.scenes import bench_camera, bench_dragon_scene

    scene = bench_dragon_scene(dragon_tris=4000, accel="binned")
    cam = bench_camera()
    opts = RenderOptions(12, 12, 4, 4, epsilon=1e-3, max_depth=5)
    params = get_material_params(scene)

    def loss(p):
        img = render_image_diff(
            apply_material_params(scene, p), cam, opts,
            jax.random.PRNGKey(0), 4,
        )
        return jnp.mean(img[..., :3])

    g = jax.grad(loss)(params)
    gd = np.asarray(g["mat_diffuse"])
    assert np.isfinite(gd).all()
    assert (np.abs(gd) > 0).any()
