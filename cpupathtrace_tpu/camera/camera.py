"""Batched perspective camera with aperture + thin lens.

Behavioral parity with the reference camera (ref: src/camera.cpp:51-113,
include/PathTrace/camera.h):
  * look-at frame construction with signed aspect ratio (the demo passes a
    *negative* aspect ratio, flipping `right`; ref: demo/main.cpp:47)
  * per-sample sub-pixel jitter uniform over the pixel footprint
  * circular aperture (polar sqrt warp, ref: camera.cpp:7-19)
  * hexagonal aperture (rejection + sign flips, ref: camera.cpp:21-49) —
    recast as a fixed-round vectorized rejection (16 candidate rounds,
    acceptance probability >= 1/2, so the miss probability is < 2^-16)
  * the reference's aperture-axis quirk: the x offset is applied along `up`
    and y along `right` (ref: camera.cpp:99) — reproduced exactly
  * thin-lens focal plane (ref: camera.cpp:102-110)
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.rays import Rays
from ..utils.math import PI, cross, dot, normalize, sqrt

APERTURE_NONE = "none"
APERTURE_CIRCULAR = "circular"
APERTURE_HEXAGONAL = "hexagonal"

_HEX_ROUNDS = 16


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "origin", "forward", "up", "right",
        "aperture_width_half", "aperture_height_half",
        "hex_horizontal_ratio", "focal_plane_dist",
    ],
    meta_fields=["aperture"],
)
@dataclasses.dataclass(frozen=True)
class Camera:
    origin: jnp.ndarray  # [3]
    forward: jnp.ndarray  # [3] forward_dir * focal_length
    up: jnp.ndarray  # [3] up_dir * height/2
    right: jnp.ndarray  # [3] right_dir * height/2 * aspect_ratio
    aperture_width_half: jnp.ndarray  # scalar
    aperture_height_half: jnp.ndarray  # scalar
    hex_horizontal_ratio: jnp.ndarray  # scalar, hexagonal sampler only
    focal_plane_dist: jnp.ndarray  # scalar; <= 0 disables the thin lens
    aperture: str  # one of APERTURE_*


def make_camera(
    origin,
    look_at,
    up,
    focal_length: float = 1.0,
    height: float = 1.0,
    aspect_ratio: float = 1.0,
    aperture_width: float = 0.0,
    aperture_height: float = 0.0,
    aperture: str = APERTURE_NONE,
    hex_horizontal_ratio: float = 0.5,
    focal_plane_dist: float = 0.0,
) -> Camera:
    """Look-at construction (ref: src/camera.cpp:54-76)."""
    origin = np.asarray(origin, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up = np.asarray(up, np.float32)

    forward_dir = look_at - origin
    forward_dir = forward_dir / np.linalg.norm(forward_dir)
    forward = forward_dir * focal_length

    up_dir = up / np.linalg.norm(up)
    height_half = height / 2.0
    up_v = up_dir * height_half
    right_dir = np.cross(forward, up_v)
    right_dir = right_dir / np.linalg.norm(right_dir)
    right = right_dir * (height_half * aspect_ratio)

    hr = min(max(float(hex_horizontal_ratio), 0.0), 1.0)

    return Camera(
        origin=jnp.asarray(origin),
        forward=jnp.asarray(forward.astype(np.float32)),
        up=jnp.asarray(up_v.astype(np.float32)),
        right=jnp.asarray(right.astype(np.float32)),
        aperture_width_half=jnp.float32(aperture_width / 2.0),
        aperture_height_half=jnp.float32(aperture_height / 2.0),
        hex_horizontal_ratio=jnp.float32(hr),
        focal_plane_dist=jnp.float32(focal_plane_dist),
        aperture=aperture,
    )


def _sample_circular(key, shape):
    """r = sqrt(u) polar warp (ref: camera.cpp:7-19)."""
    u = jax.random.uniform(key, shape + (2,))
    r = sqrt(u[..., 0])
    theta = 2.0 * PI * u[..., 1]
    return r * jnp.cos(theta), r * jnp.sin(theta)


def _sample_hexagonal(key, shape, horizontal_ratio):
    """Fixed-round rejection matching the reference's accept rule
    `rel_x <= 0 || rel_x/(1-hr) >= y`, then independent sign flips
    (ref: camera.cpp:25-49)."""
    k_xy, k_flip = jax.random.split(key)
    cand = jax.random.uniform(k_xy, shape + (_HEX_ROUNDS, 2))
    x = cand[..., 0]
    y = cand[..., 1]
    rel_x = x - horizontal_ratio
    accept = (rel_x <= 0.0) | (rel_x / (1.0 - horizontal_ratio) >= y)
    # First accepted round; fall back to the last candidate (prob < 2^-16).
    first = jnp.argmax(accept, axis=-1)
    any_acc = jnp.any(accept, axis=-1)
    pick = jnp.where(any_acc, first, _HEX_ROUNDS - 1)
    x = jnp.take_along_axis(x, pick[..., None], axis=-1)[..., 0]
    y = jnp.take_along_axis(y, pick[..., None], axis=-1)[..., 0]
    flips = jax.random.bernoulli(k_flip, 0.5, shape + (2,))
    x = jnp.where(flips[..., 0], -x, x)
    y = jnp.where(flips[..., 1], -y, y)
    return x, y


def shoot_rays(
    camera: Camera,
    x: jnp.ndarray,
    y: jnp.ndarray,
    pixel_width,
    pixel_height,
    key,
) -> Rays:
    """Generate one camera ray per (x, y) in [-1,1] sensor coordinates
    (ref: src/camera.cpp:78-113 Camera::shootRay)."""
    shape = x.shape
    k_jit, k_ap = jax.random.split(key)

    jit = jax.random.uniform(k_jit, shape + (2,), minval=-0.5, maxval=0.5)
    sensor_x = x + jit[..., 0] * pixel_width
    sensor_y = y + jit[..., 1] * pixel_height

    sensor_pos = (
        camera.origin
        - camera.forward
        - camera.up * sensor_y[..., None]
        - camera.right * sensor_x[..., None]
    )

    if camera.aperture == APERTURE_CIRCULAR:
        ap_x, ap_y = _sample_circular(k_ap, shape)
    elif camera.aperture == APERTURE_HEXAGONAL:
        ap_x, ap_y = _sample_hexagonal(k_ap, shape, camera.hex_horizontal_ratio)
    else:
        ap_x = jnp.zeros(shape)
        ap_y = jnp.zeros(shape)

    ap_x = ap_x * camera.aperture_width_half
    ap_y = ap_y * camera.aperture_height_half

    # NB: x offset along `up`, y along `right` — reference quirk
    # (ref: camera.cpp:99), reproduced for pixel parity.
    ray_origin = camera.origin + camera.up * ap_x[..., None] + camera.right * ap_y[..., None]

    # Thin lens (ref: camera.cpp:102-110); both branches are cheap, select.
    base_dir = normalize(camera.origin - sensor_pos)
    denom = dot(jnp.broadcast_to(camera.forward, base_dir.shape), base_dir)
    ray_target = camera.origin + base_dir * (camera.focal_plane_dist / denom)[..., None]
    dir_lens = normalize(ray_target - ray_origin)
    dir_pinhole = normalize(ray_origin - sensor_pos)
    use_lens = camera.focal_plane_dist > 0.0
    ray_dir = jnp.where(use_lens, dir_lens, dir_pinhole)

    return Rays(origin=jnp.broadcast_to(ray_origin, shape + (3,)), direction=ray_dir)
