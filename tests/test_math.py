"""Vector-math unit tests (ref analog: util/vector.h semantics)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpupathtrace_tpu.utils.math import (
    cross,
    dot,
    length,
    local_to_global,
    normalize,
    normalize_safely,
    orthonormal_frame,
    reflect,
    transform_points,
)


def test_dot_cross_basic():
    a = jnp.array([[1.0, 2.0, 3.0], [0.0, 1.0, 0.0]])
    b = jnp.array([[4.0, -5.0, 6.0], [0.0, 0.0, 1.0]])
    np.testing.assert_allclose(dot(a, b), [12.0, 0.0])
    np.testing.assert_allclose(cross(a, b)[1], [1.0, 0.0, 0.0])
    # anti-commutativity and orthogonality
    c = cross(a, b)
    np.testing.assert_allclose(c, -cross(b, a))
    np.testing.assert_allclose(dot(c, a), 0.0, atol=1e-5)
    np.testing.assert_allclose(dot(c, b), 0.0, atol=1e-5)


def test_normalize():
    v = jnp.array([3.0, 0.0, 4.0])
    np.testing.assert_allclose(length(normalize(v)), 1.0, rtol=1e-6)
    np.testing.assert_allclose(normalize(v), [0.6, 0.0, 0.8], rtol=1e-6)


def test_normalize_safely_zero_vector():
    v = jnp.zeros(3)
    out = normalize_safely(v)
    assert bool(jnp.all(jnp.isfinite(out)))
    np.testing.assert_allclose(out, 0.0)


def test_reflect():
    # Incoming ray pointing down onto y-up plane reflects up.
    v = normalize(jnp.array([1.0, -1.0, 0.0]))
    n = jnp.array([0.0, 1.0, 0.0])
    r = reflect(v, n)
    np.testing.assert_allclose(r, normalize(jnp.array([1.0, 1.0, 0.0])), atol=1e-6)
    # Reflection preserves length.
    np.testing.assert_allclose(length(r), 1.0, rtol=1e-6)


@pytest.mark.parametrize(
    "n",
    [
        [0.0, 0.0, 1.0],
        [0.0, 1.0, 0.0],
        [1.0, 0.0, 0.0],
        [0.577350269, 0.577350269, 0.577350269],
        [0.0, -0.707106781, 0.707106781],
    ],
)
def test_orthonormal_frame(n):
    n = jnp.array(n)
    b1, b2 = orthonormal_frame(n)
    for v in (b1, b2):
        np.testing.assert_allclose(length(v), 1.0, rtol=1e-5)
    np.testing.assert_allclose(dot(b1, b2), 0.0, atol=1e-6)
    np.testing.assert_allclose(dot(b1, n), 0.0, atol=1e-6)
    np.testing.assert_allclose(dot(b2, n), 0.0, atol=1e-6)


def test_local_to_global_z_maps_to_normal():
    n = normalize(jnp.array([1.0, 2.0, -0.5]))
    out = local_to_global(jnp.array([0.0, 0.0, 1.0]), n)
    np.testing.assert_allclose(out, n, atol=1e-6)


def test_transform_points_affine_and_perspective():
    # Affine: scale + translate (row-major, ref: util/matrix.h:50-55).
    m = jnp.array(
        [
            [2.0, 0.0, 0.0, 1.0],
            [0.0, 3.0, 0.0, -1.0],
            [0.0, 0.0, 1.0, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    p = jnp.array([[1.0, 1.0, 1.0]])
    np.testing.assert_allclose(transform_points(m, p), [[3.0, 2.0, 1.0]], atol=1e-6)
    # Perspective divide by w.
    m2 = m.at[3, 3].set(2.0)
    np.testing.assert_allclose(transform_points(m2, p), [[1.5, 1.0, 0.5]], atol=1e-6)


# --- Correctly rounded sqrt and division ------------------------------------
# XLA:GPU's f32 sqrt and division are approximate; `sqrt` and `div` move the
# backend's estimate to the IEEE result. The CPU backend is already exact, so
# these tests feed the rounding step estimates that are off by whole ulps.

from cpupathtrace_tpu.utils import math as pmath  # noqa: E402


def _ulps_off(v, k):
    v = np.asarray(v, np.float32)
    for _ in range(abs(k)):
        v = np.nextafter(v, np.float32(np.inf if k > 0 else 0.0))
    return v


def _sqrt_operands(n=1 << 16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(1.0, 4.0, n) * 4.0 ** rng.integers(-37, 62, n)
    # Around powers of two, where the ulp of the root changes.
    p = 2.0 ** np.arange(-70, 120, dtype=np.float64)
    edges = np.concatenate([_ulps_off(p, k) for k in (-2, -1, 0, 1, 2)])
    sq = np.float32(np.sqrt(p[p < 2.0 ** 100])).astype(np.float64)
    return np.concatenate([x, edges, sq * sq]).astype(np.float32)


def _div_operands(n=1 << 16, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(1, 2, n) * 2.0 ** rng.integers(-50, 50, n) * rng.choice([-1, 1], n)
    b = rng.uniform(1, 2, n) * 2.0 ** rng.integers(-50, 50, n) * rng.choice([-1, 1], n)
    # Quotients at and next to powers of two.
    bb = rng.uniform(1, 2, 4096).astype(np.float32)
    aa = np.concatenate([_ulps_off(bb * np.float32(2.0 ** k), j)
                         for k in (-3, 0, 5) for j in (-1, 0, 1)])
    return (np.concatenate([a, aa]).astype(np.float32),
            np.concatenate([b, np.tile(bb, 9)]).astype(np.float32))


@pytest.mark.parametrize("off", [-1, 0, 1])
def test_sqrt_rounds_estimate_to_ieee(off):
    x = _sqrt_operands()
    exact = np.sqrt(x)  # numpy's f32 sqrt is IEEE
    guess = _ulps_off(exact, off)
    got = np.asarray(jax.jit(lambda x, s: pmath._round_step(
        s, lambda s, d: pmath._square_below(x, s, d)))(x, guess))
    np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("off", [-2, -1, 0, 1, 2])
def test_div_rounds_estimate_to_ieee(off):
    a, b = _div_operands()
    exact = np.abs(a / b)  # numpy's f32 division is IEEE
    guess = _ulps_off(exact, off)

    def two_steps(a, b, q):
        for _ in range(2):
            q = pmath._round_step(q, lambda q, d: pmath._product_below(a, b, q, d))
        return q

    got = np.asarray(jax.jit(two_steps)(np.abs(a), np.abs(b), guess))
    np.testing.assert_array_equal(got, exact)


def test_sqrt_div_match_ieee_and_pass_edge_inputs_through():
    x = _sqrt_operands(4096)
    np.testing.assert_array_equal(np.asarray(jax.jit(pmath.sqrt)(x)), np.sqrt(x))
    a, b = _div_operands(4096)
    np.testing.assert_array_equal(np.asarray(jax.jit(pmath.div)(a, b)), a / b)
    # Outside the exact range the backend's own result passes through.
    x = np.array([0.0, -0.0, -1.0, np.inf, np.nan, 1e-40, 2.0 ** -80, 3e38],
                 np.float32)
    np.testing.assert_array_equal(np.asarray(jax.jit(pmath.sqrt)(x)),
                                  np.asarray(jax.jit(jnp.sqrt)(x)))
    a = np.array([0.0, 1.0, 1.0, np.inf, np.nan, 1e-30, 1e30, 1e-20], np.float32)
    b = np.array([1.0, 0.0, np.inf, 1.0, 1.0, 1e30, 1e-30, 3e20], np.float32)
    np.testing.assert_array_equal(np.asarray(jax.jit(pmath.div)(a, b)),
                                  np.asarray(jax.jit(jnp.divide)(a, b)))
    # Broadcasting, as `normalize` uses it.
    v = np.array([[3.0, -4.0, 12.0]], np.float32)
    np.testing.assert_array_equal(np.asarray(pmath.div(v, np.float32(13.0))),
                                  v / np.float32(13.0))


def test_sqrt_div_differentiate_like_jnp():
    x = jnp.array([0.3, 2.0, 9.0])
    np.testing.assert_allclose(jax.grad(lambda x: pmath.sqrt(x).sum())(x),
                               jax.grad(lambda x: jnp.sqrt(x).sum())(x), rtol=1e-6)
    a, b = jnp.array([1.5, -2.0, 7.0]), jnp.array([3.0, 0.25, -5.0])
    for argnum in (0, 1):
        np.testing.assert_allclose(
            jax.grad(lambda a, b: pmath.div(a, b).sum(), argnum)(a, b),
            jax.grad(lambda a, b: (a / b).sum(), argnum)(a, b), rtol=1e-6)
    v = jnp.array([[0.3, -1.2, 2.0]])
    np.testing.assert_allclose(
        jax.jacfwd(lambda v: normalize(v))(v),
        jax.jacfwd(lambda v: v / jnp.sqrt(jnp.sum(v * v, -1, keepdims=True)))(v),
        rtol=1e-5, atol=1e-7)


def test_sphere_light_knife_edge_cpu_matches_ieee():
    """The NEE knife edge (tests/rounding_util.py) on the CPU backend against
    the numpy IEEE f32 emulation of the same chain: the share of near-side
    samples counted visible agrees within one point."""
    from tests import rounding_util as ru
    from tests.scenes_util import emissive_sphere_scene

    n = 200000
    pos = ru.floor_points(n)
    key = jax.random.PRNGKey(0)
    vis, near = ru.near_side_visible(emissive_sphere_scene(), pos, key,
                                     jax.devices("cpu")[0])
    vis_e, near_e = ru.near_side_visible_ieee(pos, *ru.light_sample_uniforms(n, key))
    np.testing.assert_array_equal(near, near_e)
    assert 0.45 < ru.share(vis_e, near_e) < 0.6
    assert abs(ru.share(vis, near) - ru.share(vis_e, near_e)) <= 0.01
