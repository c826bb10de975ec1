"""PTX_DEBUG checkify assertion layer (core/debug.py; ref: base.h:59-80)."""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def test_debug_checks_off_by_default(monkeypatch):
    monkeypatch.delenv("PTX_DEBUG", raising=False)
    from cpupathtrace_tpu.core import debug

    # No-op helpers trace cleanly outside checkify when disabled.
    @jax.jit
    def f(x):
        debug.check_finite(x, "x")
        return x * 2

    assert float(f(jnp.float32(2.0))) == 4.0


def test_checked_trace_passes_on_healthy_scene():
    """PTX_DEBUG=1 run of the checked wavefront on the box scene.
    Subprocess so the env flag is read fresh."""
    code = """
import os
os.environ["PTX_DEBUG"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from cpupathtrace_tpu.core.config import RenderOptions
from cpupathtrace_tpu.core.rays import Rays
from cpupathtrace_tpu.integrator.wavefront import checked_trace
from cpupathtrace_tpu.models.scenes import bench_box_scene

scene = bench_box_scene()
opts = RenderOptions(8, 8, 2, 2, epsilon=1e-3, max_depth=5)
n = 64
rng = np.random.default_rng(0)
o = np.zeros((n, 3), np.float32); o[:, 2] = -2.5
d = rng.normal(size=(n, 3)); d[:, 2] = np.abs(d[:, 2]) + 0.5
d /= np.linalg.norm(d, axis=1, keepdims=True)
rays = Rays(origin=jnp.asarray(o), direction=jnp.asarray(d.astype(np.float32)))
out, coll = checked_trace(scene, rays, opts, jax.random.PRNGKey(0))
assert np.asarray(coll).any()
print("CHECKED_TRACE_OK")

# And a failing case: denormalized directions must trip assertNormalized.
bad = Rays(origin=jnp.asarray(o), direction=jnp.asarray(d.astype(np.float32)) * 2.0)
try:
    checked_trace(scene, bad, opts, jax.random.PRNGKey(0))
    print("MISSED_FAILURE")
except Exception as e:
    assert "assertNormalized" in str(e), str(e)
    print("CAUGHT_BAD_DIRECTION")
"""
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=600, cwd=os.path.dirname(os.path.dirname(__file__)),
    )
    assert "CHECKED_TRACE_OK" in r.stdout, r.stdout + r.stderr
    assert "CAUGHT_BAD_DIRECTION" in r.stdout, r.stdout + r.stderr
