"""f32 rounding checks shared by tests/test_gpu.py, tests/test_math.py and
benchmarks/probe_rounding.py.

* `ulp_row`: how far a jnp function's f32 results lie from the correctly
  rounded value (float64 evaluation rounded to f32), on one device.
* The sphere-light knife edge. NEE samples a point on an emissive sphere and
  asks whether anything blocks the segment to it. For a point on the near
  side the shadow ray meets the sphere exactly at the sampled point, at
  `t == dist - eps` in exact arithmetic, and the strict test `t < dist - eps`
  is decided by rounding alone. About half of such samples count as visible;
  which half depends on how every step of the chain rounds, so a biased sqrt,
  division or sine moves the image. `near_side_visible` runs the package's own
  chain (`sample_lights`, `light_visibility`) on a device;
  `near_side_visible_ieee` runs the same chain in numpy f32, whose
  + - * / sqrt are IEEE and whose sin, cos and arccos are float64 rounded to
  f32: the arithmetic of the C++ reference without FMA contraction.
"""
import jax
import jax.numpy as jnp
import numpy as np

from tests.scenes_util import EMSPHERE_CENTER, EMSPHERE_RADIUS

EPS = 1e-3


def ulp_inputs(n=1 << 20, seed=0):
    """Random f32 operands: x, y in [0.01, 4), a in (-1, 1), th in [0, 2 pi)."""
    rng = np.random.default_rng(seed)
    return {
        "x": rng.uniform(0.01, 4.0, n).astype(np.float32),
        "y": rng.uniform(0.01, 4.0, n).astype(np.float32),
        "a": rng.uniform(-0.999, 0.999, n).astype(np.float32),
        "th": rng.uniform(0.0, 2.0 * np.pi, n).astype(np.float32),
    }


def ulp_row(fn, ref64, args, device):
    """`fn(*args)` jitted on `device` against `ref64(*float64 args)` rounded
    to f32: share of results that are not the correctly rounded value, mean
    signed error and max |error| in ulps of the result."""
    out = np.asarray(jax.jit(fn)(*[jax.device_put(a, device) for a in args]))
    ref = ref64(*[np.asarray(a, np.float64) for a in args])
    refr = ref.astype(np.float32)
    err = (out.astype(np.float64) - ref) / np.spacing(np.abs(refr)).astype(np.float64)
    return {"not_rn": float((out != refr).mean()),
            "mean_ulp": float(err.mean()),
            "max_abs_ulp": float(np.abs(err).max())}


def floor_points(n, seed=0):
    """Shading points on the box floor (y = -1), away from the walls."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.99, 0.99, n), np.full(n, -1.0),
                     rng.uniform(-0.99, 0.99, n)], -1).astype(np.float32)


def _near_side(pos, target):
    """Sampled points whose outward normal faces the shading point
    (float64 on the host, from the f32 values)."""
    c = np.asarray(EMSPHERE_CENTER, np.float64)
    t = np.asarray(target, np.float64)
    return np.sum((t - c) * (np.asarray(pos, np.float64) - t), -1) > 0.0


def light_visible(scene, pos, key, device):
    """Per NEE light sample from `pos` (all lights of `scene`), computed on
    `device` by the package's own `sample_lights` and `light_visibility`:
    (target [R, L, 3], visible [R, L], valid [R, L]) as numpy arrays. For
    points on the box floor the only occluder of a ceiling panel is the
    panel itself, at the same knife edge as a sphere's near side."""
    from cpupathtrace_tpu.integrator.wavefront import light_visibility
    from cpupathtrace_tpu.scene.lights import sample_lights

    @jax.jit
    def chain(scene, pos, key):
        lights = sample_lights(scene, pos, key)
        _, vis = light_visibility(scene, pos, lights.target, EPS, lights.valid)
        return lights.target, vis, lights.valid

    out = chain(*jax.device_put((scene, jnp.asarray(pos), key), device))
    return tuple(np.asarray(a) for a in out)


def near_side_visible(scene, pos, key, device):
    """Per light sample of a scene with one emissive sphere: (visible on
    `device`, on the near side)."""
    target, vis, _ = light_visible(scene, pos, key, device)
    return vis[:, 0], _near_side(pos, target[:, 0])


def light_sample_uniforms(n, key):
    """The (u1, u2) that `sample_lights` draws for its one emissive sample
    (CPU backend: threefry is bit-exact across backends)."""
    with jax.default_device(jax.devices("cpu")[0]):
        u = np.asarray(jax.random.uniform(key, (n, 1, 3)))
    return u[:, 0, 1], u[:, 0, 2]


def near_side_visible_ieee(pos, u1, u2):
    """`near_side_visible` in numpy f32 with IEEE + - * / sqrt and
    float64-rounded sin, cos and arccos; sums left to right, no FMA."""
    f = np.float32
    c = np.asarray(EMSPHERE_CENTER, f)
    r = f(EMSPHERE_RADIUS)

    def dot(a, b):
        p = a * b
        return (p[:, 0] + p[:, 1]) + p[:, 2]

    theta = f(2.0 * np.pi) * u1
    phi = np.arccos(np.clip(f(1.0) - f(2.0) * u2, -1.0, 1.0).astype(np.float64)).astype(f)
    sp = np.sin(phi.astype(np.float64)).astype(f)
    unit = np.stack([sp * np.cos(theta.astype(np.float64)).astype(f),
                     sp * np.sin(theta.astype(np.float64)).astype(f),
                     np.cos(phi.astype(np.float64)).astype(f)], -1)
    target = c + unit * r
    to_light = target - pos
    dist = np.sqrt(dot(to_light, to_light))
    ldir = to_light / dist[:, None]
    o = pos + ldir * f(EPS)
    co = o - c
    dd = dot(ldir, co)
    disc = dd * dd - dot(co, co) + r * r
    t = -(dd + np.sqrt(np.maximum(disc, f(0.0))))
    t = np.where(disc >= 0, t, f(-1.0))
    vis = (t < 0) | (t >= dist - f(EPS))
    return vis, _near_side(pos, target)


def share(vis, near):
    """Share of near-side samples counted visible."""
    return float(vis[near].mean())
