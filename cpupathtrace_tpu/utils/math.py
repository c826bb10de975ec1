"""Batched vector math for the path tracer.

All functions operate on arrays whose last axis is the vector axis (3 for
directions/positions, 4 for RGBA spectra), mirroring the semantics of the
reference's scalar vector library (reference: include/PathTrace/util/vector.h)
but as SoA/batched jnp ops so they vectorize.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

PI = 3.14159265358979323846


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the last axis (ref: util/vector.h:192)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3D cross product (ref: util/vector.h:234)."""
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def length_squared(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(v * v, axis=-1)


# --- Correctly rounded f32 sqrt and division -------------------------------
#
# XLA's GPU backend computes f32 `sqrt` and `/` approximately (sqrt within
# one ulp and biased low, division within two), while the CPU backend and
# the C++ reference round them correctly. The reference's geometric
# predicates sit on such ulps: a sampled sphere-light point occludes itself
# or not by the rounding of `t < dist - eps`. `sqrt` and `div` below take
# the backend's estimate and move it to the correctly rounded neighbour by
# an exact midpoint test, so they return the IEEE result on every backend.
#
# The test needs no FMA and no wider type: the operands are cut into 8- and
# 12-bit pieces by bit masks, every product of two pieces is exact in f32,
# and the partial sums are subtracted largest first, each one exact because
# its value fits 24 bits at its quantum. Only the last comparison rounds,
# and rounding keeps the sign. FMA contraction cannot change the result,
# since every product is already exact.

def _bits(x):
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def _from_bits(b):
    return jax.lax.bitcast_convert_type(b, jnp.float32)


def _leading(x, n: int):
    """Positive normal f32 `x` cut to its leading `n` significant bits."""
    return _from_bits(_bits(x) & jnp.uint32((0xFFFFFFFF << (24 - n)) & 0xFFFFFFFF))


def _neighbours(s):
    """(next f32 above, next below) of a positive normal `s`."""
    b = _bits(s)
    return _from_bits(b + jnp.uint32(1)), _from_bits(b - jnp.uint32(1))


def _square_below(x, s, d):
    """Exactly `(s + d)**2 < x`, for `s` > 0 within a few ulps of sqrt(x)
    and `d` half the gap from `s` to a neighbour."""
    a = _leading(s, 8)
    m = _leading(s, 16)
    b = m - a
    c = (s - m) + d  # s + d = a + b + c, each piece exact
    a2 = a + a
    t = (x - a * a) - a2 * b
    t = t - (b * b + a2 * c)
    t = t - (b + b) * c
    return t > c * c


def _product_below(a, b, q, d):
    """Exactly `(q + d) * b < a`, for positive normal `a`, `b`, `q` within a
    few ulps of a / b and `d` half the gap from `q` to a neighbour."""
    b1 = _leading(b, 8)
    bm = _leading(b, 16)
    b2 = bm - b1
    b3 = b - bm
    q1 = _leading(q, 12)
    q2 = (q - q1) + d  # q + d = q1 + q2, each piece exact
    t = (a - q1 * b1) - q1 * b2
    t = t - q2 * b1
    t = t - q1 * b3
    t = t - q2 * b2
    return t > q2 * b3


def _round_step(s, below):
    """Move `s` one ulp toward the correctly rounded value. `below(s, d)`
    says whether the midpoint `s + d` lies below the exact result; it never
    equals it."""
    up, down = _neighbours(s)
    return jnp.where(
        below(s, (up - s) * 0.5), up,
        jnp.where(below(s, (down - s) * 0.5), s, down),
    )


@jax.custom_jvp
def sqrt(x: jnp.ndarray) -> jnp.ndarray:
    """f32 square root, correctly rounded on every backend. Inputs outside
    [2**-76, 2**126] (zero, subnormals, inf, nan, negatives) take the
    backend's `jnp.sqrt` unchanged. Differentiates like `jnp.sqrt`."""
    s = jnp.sqrt(x)
    ok = (x >= 2.0 ** -76) & (x <= 2.0 ** 126)
    s_ok = jnp.where(ok, s, 1.0)
    x_ok = jnp.where(ok, x, 1.0)
    r = _round_step(s_ok, lambda s, d: _square_below(x_ok, s, d))
    return jnp.where(ok, r, s)


@sqrt.defjvp
def _sqrt_jvp(primals, tangents):
    (x,), (tx,) = primals, tangents
    y = sqrt(x)
    return y, tx * (0.5 / y)


@jax.custom_jvp
def div(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """f32 `a / b`, correctly rounded on every backend where |a| and |b| lie
    in [2**-60, 2**60] and |a / b| in [2**-100, 2**100] (every piece of the
    test then stays a normal number); elsewhere the backend's division.
    Differentiates like `a / b`."""
    a, b = jnp.broadcast_arrays(a, b)
    q = a / b
    abs_a, abs_b, abs_q = jnp.abs(a), jnp.abs(b), jnp.abs(q)
    ok = ((abs_a >= 2.0 ** -60) & (abs_a <= 2.0 ** 60)
          & (abs_b >= 2.0 ** -60) & (abs_b <= 2.0 ** 60)
          & (abs_q >= 2.0 ** -100) & (abs_q <= 2.0 ** 100))
    pa = jnp.where(ok, abs_a, 1.0)
    pb = jnp.where(ok, abs_b, 1.0)
    r = jnp.where(ok, abs_q, 1.0)
    # The backend's estimate may be two ulps off: two steps.
    for _ in range(2):
        r = _round_step(r, lambda q, d: _product_below(pa, pb, q, d))
    r = jnp.where((a < 0) != (b < 0), -r, r)
    return jnp.where(ok, r, q)


@div.defjvp
def _div_jvp(primals, tangents):
    (a, b), (ta, tb) = primals, tangents
    y = div(a, b)
    return y, ta / b - y * tb / b


def length(v: jnp.ndarray) -> jnp.ndarray:
    return sqrt(length_squared(v))


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    """Normalize over last axis. Division by a zero norm yields inf/nan like
    the reference's unchecked normalize (ref: util/vector.h)."""
    return div(v, length(v)[..., None])


def normalize_safely(v: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Normalize, returning v unchanged when the norm underflows
    (ref: util/vector.h normalizeSafely)."""
    n2 = length_squared(v)
    safe = jnp.maximum(sqrt(n2), eps)
    return jnp.where(n2[..., None] > 0, div(v, safe[..., None]), v)


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Reflect direction v (pointing toward the surface) about unit normal n
    (ref: util/vector.h:250)."""
    return v - n * (2.0 * dot(v, n))[..., None]


def orthonormal_frame(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Build tangent/bitangent (b1, b2) so {b1, b2, n} is an orthonormal basis.

    Reproduces the branch structure of the reference's tangent-frame
    construction (ref: src/scene/propagation.cpp:24-62 impl::localToGlobal) as
    masked selects so every lane is branch-free:
      |nx|>0 & |ny|>0 -> d = (0, -nx, ny)
      |nx|>0 & ny==0  -> d = (0, -nx, nz)
      nx==0 & |ny|>0  -> d = (-ny, nz, 0)
      nx==0 & ny==0   -> d = (1, 0, 0)
    then b1 = normalize(cross(d, n)), b2 = normalize(cross(b1, n)).
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    zero = jnp.zeros_like(nx)
    one = jnp.ones_like(nx)
    has_x = jnp.abs(nx) > 0.0
    has_y = jnp.abs(ny) > 0.0
    d = jnp.where(
        has_x[..., None],
        jnp.where(
            has_y[..., None],
            jnp.stack([zero, -nx, ny], axis=-1),
            jnp.stack([zero, -nx, nz], axis=-1),
        ),
        jnp.where(
            has_y[..., None],
            jnp.stack([-ny, nz, zero], axis=-1),
            jnp.stack([one, zero, zero], axis=-1),
        ),
    )
    d = normalize(d)
    b1 = normalize(cross(d, n))
    b2 = normalize(cross(b1, n))
    return b1, b2


def local_to_global(vec: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Transform a tangent-space vector (z = normal axis) to world space
    (ref: src/scene/propagation.cpp:24-62)."""
    b1, b2 = orthonormal_frame(n)
    return (
        b1 * vec[..., 0:1] + b2 * vec[..., 1:2] + n * vec[..., 2:3]
    )


def transform_points(mat4: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply a 4x4 row-major affine matrix to [..., 3] points with perspective
    divide (ref: util/matrix.h:50-55 mat4::operator*(vec3))."""
    ones = jnp.ones(pts.shape[:-1] + (1,), dtype=pts.dtype)
    h = jnp.concatenate([pts, ones], axis=-1)
    out = jnp.matmul(h, mat4.T, precision=jax.lax.Precision.HIGHEST)
    return out[..., :3] / out[..., 3:4]


# numpy (not jnp): module import must not force device-backend
# initialization; jnp ops accept numpy operands.
import numpy as _np

MAT3_IDENTITY = _np.eye(3, dtype=_np.float32)
MAT4_IDENTITY = _np.eye(4, dtype=_np.float32)


def mat3_vec(mat3: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Row-major 3x3 matrix times [..., 3] vectors
    (ref: util/matrix.h:41-47 mat3::operator*)."""
    return jnp.matmul(v, mat3.T, precision=jax.lax.Precision.HIGHEST)


def transform_directions(mat4: jnp.ndarray, dirs: jnp.ndarray) -> jnp.ndarray:
    """Apply only the linear (rotation/scale) part of a 4x4 transform to
    direction vectors — no translation, no perspective divide."""
    return jnp.matmul(
        dirs, mat4[:3, :3].T, precision=jax.lax.Precision.HIGHEST
    )
