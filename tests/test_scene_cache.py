"""Scene persistence (scene/cache.py): save/load roundtrip fidelity and
the keyed build cache. The reference has no analog (it rebuilds its BVH
in the Scene ctor on every start, src/scene/scene.cpp:153-181); the
roundtrip contract here is BIT-identity of every packed table, so a
cached scene renders bit-identically to a fresh build."""
import dataclasses

import numpy as np
import pytest

from cpupathtrace_tpu.scene.cache import (
    build_cache_key,
    cached_build,
    load_scene,
    save_scene,
)
from cpupathtrace_tpu.models.scenes import bench_dragon_scene


@pytest.fixture(scope="module")
def scene():
    # Binned build so the big-partition and cluster tables are populated.
    return bench_dragon_scene(dragon_tris=5000, accel="binned")


def test_roundtrip_bit_identical(scene, tmp_path):
    p = tmp_path / "scene.bin"
    save_scene(scene, p)
    back = load_scene(p)
    for f in dataclasses.fields(scene):
        a, b = getattr(scene, f.name), getattr(back, f.name)
        if hasattr(a, "shape"):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, f.name
            assert a.shape == b.shape, f.name
            assert np.array_equal(a, b, equal_nan=True), f.name
        else:
            assert a == b, f.name


def test_roundtrip_renders_identically(scene, tmp_path):
    import jax
    import jax.numpy as jnp

    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.core.rays import Rays
    from cpupathtrace_tpu.integrator.wavefront import trace

    p = tmp_path / "scene.bin"
    save_scene(scene, p)
    back = load_scene(p)

    n = 256
    rng = np.random.default_rng(3)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = -2.9
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(origin=jnp.asarray(o), direction=jnp.asarray(d))
    opts = RenderOptions(16, 16, 4, 4, epsilon=1e-3, max_depth=6)
    key = jax.random.PRNGKey(11)
    s0, c0 = trace(scene, rays, opts, key)
    s1, c1 = trace(back, rays, opts, key)
    assert np.array_equal(np.asarray(s0), np.asarray(s1))
    assert np.array_equal(np.asarray(c0), np.asarray(c1))


def test_stale_format_rejected(scene, tmp_path, monkeypatch):
    from cpupathtrace_tpu.scene import cache as cache_mod

    p = tmp_path / "scene.bin"
    # Save under a future format version, then try to load with ours.
    monkeypatch.setattr(
        cache_mod, "_FORMAT_VERSION", cache_mod._FORMAT_VERSION + 1
    )
    save_scene(scene, p)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="stale"):
        load_scene(p)
    # Non-cache files are rejected by magic, not mis-parsed.
    q = tmp_path / "junk.bin"
    q.write_bytes(b"definitely not a scene")
    with pytest.raises(ValueError, match="not a scene cache"):
        load_scene(q)


def test_cached_build_hits_and_misses(scene, tmp_path):
    calls = []

    def build():
        calls.append(1)
        return scene

    key = build_cache_key("unit", 5000, "binned")
    s1, hit1 = cached_build(key, build, tmp_path)
    s2, hit2 = cached_build(key, build, tmp_path)
    assert (hit1, hit2) == (False, True)
    assert len(calls) == 1
    assert np.array_equal(np.asarray(s1.tri_v0), np.asarray(s2.tri_v0))
    # A corrupt file is a miss, not an error.
    (tmp_path / f"{key}.ptxs").write_bytes(b"garbage")
    s3, hit3 = cached_build(key, build, tmp_path)
    assert hit3 is False and len(calls) == 2
    assert np.array_equal(np.asarray(s3.tri_v0), np.asarray(scene.tri_v0))


def test_cache_key_sensitivity(monkeypatch):
    from cpupathtrace_tpu.scene import cache as cache_mod

    k0 = build_cache_key("mesh.obj", 100)
    assert k0 == build_cache_key("mesh.obj", 100)
    assert k0 != build_cache_key("mesh.obj", 101)
    assert k0 != build_cache_key("mesh.obj", 100, "binned")
    # Environment knobs no longer change packed tables, so they do not
    # key the cache; the format version does.
    monkeypatch.setenv("PTX_ADAPTIVE_FUSE", "1")
    assert k0 == build_cache_key("mesh.obj", 100)
    monkeypatch.setattr(
        cache_mod, "_FORMAT_VERSION", cache_mod._FORMAT_VERSION + 1
    )
    assert k0 != build_cache_key("mesh.obj", 100)
