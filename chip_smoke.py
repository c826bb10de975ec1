"""Smoke run of the path tracer's main path on one NVIDIA GPU.

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --four     # four cards: one frame sharded over a
                                    # (dp, sp) = (2, 2) mesh vs one card
    python chip_smoke.py --out DIR  # where the demo PNG goes

Phases (one process, everything in-process; only `nvidia-smi` runs as a
child):
  1. device   — the default device must be a GPU;
  2. golden   — the `gpu`-marked tests through `pytest.main` in this
                process (tests/test_gpu.py: golden parity, correctly
                rounded sqrt and division, the sphere-light knife edge);
  3. intersect — binned (sweep), BVH and cluster intersection of 262,144
                random rays on the 200k-triangle dragon agree with each
                other, with `dense_intersect` on a subset, and with the CPU
                backend;
  4. frames   — renderSceneBox (128x128 @ 256 spp) and renderSceneDragonBox
                (128x128 @ 16 spp) through `render`, max_depth 40;
  5. grad     — loss and material gradients (128x128 @ 16 spp, depth 12),
                a finite-difference check and five Adam steps;
  6. demo     — the reference demo scene through demo.py's code path.

Every phase prints one JSON line with the card's name and power limit,
compile and wall seconds, Mrays/s where rays are traced, and memory
figures. The last line is `{"ok": true, "device": {...}}`; a failed check
raises, so the script exits non-zero before that line.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _jax():
    import jax

    return jax


def peak_bytes():
    """`peak_bytes_in_use` of the default device (None where the backend
    keeps no allocator statistics, as the CPU backend does)."""
    stats = _jax().devices()[0].memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))


def memory_figures(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {
        k: int(getattr(ma, k))
        for k in ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes")
    }


def timed_jit(fn, *args, reps=3):
    """AOT-compile `fn` for `args`, then time `reps` runs that end in
    `block_until_ready`. Returns (outputs, compile_s, wall_s, compiled)."""
    jax = _jax()
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(compiled(*args))
    return out, compile_s, (time.perf_counter() - t0) / reps, compiled


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    jax = _jax()
    from cpupathtrace_tpu.native import get_lib

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
        "jax": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "compile_cache_dir": jax.config.jax_compilation_cache_dir,
        "native_lib_loaded": get_lib() is not None,
    }


class _Tally:
    """pytest plugin: records each test's outcome."""

    def __init__(self):
        self.passed, self.failed, self.skipped = [], [], []

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed.append(report.nodeid)
        elif report.skipped:
            self.skipped.append(report.nodeid)
        elif report.when == "call":
            self.passed.append(report.nodeid)


def phase_golden():
    """Run the `gpu`-marked tests in this process (golden parity of every
    render fixture in tests/golden/, tests/test_gpu.py)."""
    import pytest

    from tests import test_gpu

    fixtures = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(HERE, "tests", "golden", "golden_*.raw"))
    )
    parity_src = open(os.path.join(HERE, "tests", "test_parity.py")).read()
    unused = [f for f in fixtures if f not in parity_src]
    check(not unused, f"golden fixtures without a parity test: {unused}")

    os.environ["PTX_KEEP_PLATFORM"] = "1"  # conftest keeps the GPU
    tally = _Tally()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = pytest.main(
            ["-q", "-m", "gpu", "-p", "no:cacheprovider",
             os.path.join(HERE, "tests", "test_gpu.py")],
            plugins=[tally],
        )
    wall = time.perf_counter() - t0
    golden = [t for t in tally.passed if "test_golden_parity_on_gpu" in t]
    check(rc == 0 and not tally.failed and not tally.skipped
          and len(golden) == len(test_gpu.GOLDEN_CASES),
          f"gpu tests: rc={rc} passed={len(tally.passed)} "
          f"failed={tally.failed} skipped={tally.skipped}")
    return {"fixtures": fixtures, "golden_passed": len(golden),
            "tests_passed": [t.split("::")[-1] for t in tally.passed
                             if t not in golden],
            "wall_s_with_compile": wall, "peak_bytes_in_use": peak_bytes()}


def _agree(ta, pa, tb, pb):
    """The exactness rule: per ray, the same primitive or the same t."""
    return (pa == pb) | (ta == tb)


def phase_intersect(n_rays=262144, n_dense=4096, dragon_tris=200000,
                    box_rays=1 << 20):
    jax = _jax()
    import jax.numpy as jnp

    from cpupathtrace_tpu.models.scenes import bench_box_scene, bench_dragon_scene
    from cpupathtrace_tpu.ops.intersect import (
        bvh_intersect,
        cluster_intersect,
        dense_intersect,
        scene_intersect,
    )

    binned = bench_dragon_scene(dragon_tris=dragon_tris, accel="binned")
    clustered = bench_dragon_scene(dragon_tris=dragon_tris, accel="cluster")
    check(binned.accel == "binned" and clustered.accel == "cluster",
          (binned.accel, clustered.accel))

    rng = np.random.default_rng(0)
    o = rng.uniform(-0.95, 0.95, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)

    rec = {"rays": n_rays, "tris": binned.n_tri,
           "clusters_binned": int(binned.blk_lo.shape[0]),
           "cluster_size_binned": binned.cluster_size}
    results = {}
    for name, fn, scene in (
        ("sweep", scene_intersect, binned),
        ("bvh", bvh_intersect, binned),
        ("cluster", cluster_intersect, clustered),
    ):
        (t, p), compile_s, wall, compiled = timed_jit(fn, scene, o, d)
        results[name] = (np.asarray(t), np.asarray(p))
        rec[name] = {"compile_s": compile_s, "wall_s": wall,
                     "mrays_s": n_rays / wall / 1e6,
                     "memory": memory_figures(compiled),
                     "hits": int((results[name][1] >= 0).sum())}
    t_s, p_s = results["sweep"]
    for name in ("bvh", "cluster"):
        bad = int((~_agree(t_s, p_s, *results[name])).sum())
        rec[name]["disagree_with_sweep"] = bad
        check(bad == 0, f"{name} vs sweep: {bad}/{n_rays} rays disagree")

    sub = slice(0, n_dense)
    (t_d, p_d), _, _, _ = timed_jit(dense_intersect, binned, o[sub], d[sub],
                                    reps=1)
    t_d, p_d = np.asarray(t_d), np.asarray(p_d)
    for name, (t, p) in results.items():
        bad = int((~_agree(t[sub], p[sub], t_d, p_d)).sum())
        rec[name]["disagree_with_dense"] = bad
        check(bad == 0, f"{name} vs dense: {bad}/{n_dense} rays disagree")

    # The CPU backend as a reference only: same rays, same layout.
    cpu = jax.devices("cpu")[0]
    t_c, p_c = jax.jit(scene_intersect)(
        jax.device_put(binned, cpu), jax.device_put(o, cpu),
        jax.device_put(d, cpu),
    )
    t_c, p_c = np.asarray(t_c), np.asarray(p_c)
    same = _agree(t_s, p_s, t_c, p_c)
    both = (p_s == p_c) & (p_s >= 0)
    rel = np.abs(t_s[both] - t_c[both]) / np.maximum(t_c[both], 1e-30)
    rec["vs_cpu"] = {"mismatch": int((~same).sum()),
                     "agree_frac": float(same.mean()),
                     "max_rel_dt": float(rel.max(initial=0.0))}
    check(same.mean() >= 0.999, f"card vs CPU: {rec['vs_cpu']}")
    check(bool((rel <= 1e-5).all()), f"card vs CPU |dt|: {rec['vs_cpu']}")

    box = bench_box_scene()
    ob = np.zeros((box_rays, 3), np.float32)
    ob[:, 2] = -2.9
    db = np.stack([rng.uniform(-0.8, 0.8, box_rays),
                   rng.uniform(-0.8, 0.8, box_rays),
                   np.ones(box_rays)], -1).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    (_, p_b), compile_s, wall, _ = timed_jit(
        dense_intersect, box, jnp.asarray(ob), jnp.asarray(db))
    rec["dense_box"] = {"rays": box_rays, "prims": box.n_prims,
                        "hits": int((np.asarray(p_b) >= 0).sum()),
                        "compile_s": compile_s, "wall_s": wall,
                        "mrays_s": box_rays / wall / 1e6}
    rec["peak_bytes_in_use"] = peak_bytes()
    return rec


def _frame(name, scene, camera, size, spp, max_depth):
    """Two fixed-spp `render` calls: the first compiles, the second is
    timed alone. Coverage of the closed box must be exact."""
    from cpupathtrace_tpu import render
    from cpupathtrace_tpu.core.config import RenderOptions

    opts = RenderOptions(size, size, spp, spp, epsilon=1e-3,
                         max_depth=max_depth)
    t0 = time.perf_counter()
    render(scene, camera, opts, seed=0)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    # `render` returns host memory, so the device work is done.
    img = render(scene, camera, opts, seed=1)
    wall = time.perf_counter() - t0
    check(bool(np.isfinite(img).all()), f"{name}: non-finite pixels")
    check(bool((img[..., 3] == 1.0).all()),
          f"{name}: coverage {float(img[..., 3].mean())} != 1")
    return opts, {"size": size, "spp": spp, "max_depth": max_depth,
                  "compile_s": first - wall, "wall_s": wall,
                  "mrays_s": size * size * spp / wall / 1e6,
                  "mean_rgb": float(img[..., :3].mean())}


def phase_frames(box_size=128, box_spp=256, dragon_size=128, dragon_spp=16,
                 max_depth=40, dragon_tris=200000):
    jax = _jax()
    import jax.numpy as jnp

    from cpupathtrace_tpu.integrator.film import pixel_camera_coords, render_chunk
    from cpupathtrace_tpu.models.scenes import (
        bench_box_scene,
        bench_camera,
        bench_dragon_scene,
    )

    camera = bench_camera()
    _, box = _frame("renderSceneBox", bench_box_scene(), camera, box_size,
                    box_spp, max_depth)
    box["peak_bytes_in_use"] = peak_bytes()
    dragon_scene = bench_dragon_scene(dragon_tris=dragon_tris)
    opts, dragon = _frame("renderSceneDragonBox", dragon_scene, camera,
                          dragon_size, dragon_spp, max_depth)
    dragon["accel"] = dragon_scene.accel
    dragon["peak_bytes_in_use"] = peak_bytes()
    # `render` launches every sample of this frame at once (262,144 rays at
    # the bench width); the same launch, compiled for its memory figures.
    xg, yg = np.meshgrid(np.arange(dragon_size, dtype=np.float32),
                         np.arange(dragon_size, dtype=np.float32))
    x, y = pixel_camera_coords(opts, xg.ravel(), yg.ravel())
    compiled = render_chunk.lower(
        dragon_scene, camera, opts, jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(0), dragon_spp,
    ).compile()
    dragon["render_chunk_memory"] = memory_figures(compiled)
    return {"renderSceneBox": box, "renderSceneDragonBox": dragon}


def phase_grad(size=128, spp=16, max_depth=12, fd_size=32, fd_spp=8,
               adam_size=64, adam_spp=16, adam_steps=5):
    jax = _jax()
    import jax.numpy as jnp

    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.diff.render import (
        finite_difference_grad,
        get_material_params,
        image_loss_unbiased,
        inverse_render,
        loss_and_grad,
        render_image_diff,
    )
    from cpupathtrace_tpu.models.scenes import bench_box_scene, bench_camera

    scene = bench_box_scene()
    camera = bench_camera()
    params = get_material_params(scene)
    rec = {}

    # renderSceneBoxGrad: loss and material gradients at the bench width.
    opts = RenderOptions(size, size, spp, spp, epsilon=1e-3,
                         max_depth=max_depth)
    target = jnp.zeros((size * size, 4))
    key = jax.random.PRNGKey(5)
    t0 = time.perf_counter()
    jax.block_until_ready(loss_and_grad(params, scene, camera, opts, target,
                                        key, spp))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss, g = jax.block_until_ready(loss_and_grad(
        params, scene, camera, opts, target, jax.random.PRNGKey(6), spp))
    wall = time.perf_counter() - t0
    finite = all(bool(jnp.isfinite(v).all()) for v in g.values())
    # The box is all Lambertian: its specular tint has no effect.
    nonzero = all(float(jnp.abs(g[k]).sum()) > 0.0
                  for k in ("mat_diffuse", "mat_emission"))
    check(bool(jnp.isfinite(loss)) and finite and nonzero,
          f"gradients: loss {float(loss)}, finite {finite}, nonzero {nonzero}")
    rec["renderSceneBoxGrad"] = {
        "size": size, "spp": spp, "max_depth": max_depth,
        "compile_s": first - wall, "wall_s": wall,
        "mrays_s": size * size * spp / wall / 1e6, "loss": float(loss),
        "peak_bytes_in_use": peak_bytes(),
    }

    # Finite differences under common random numbers; max_depth 4 keeps
    # roulette at p == 1 (tests/test_diff.py's setting and tolerance).
    fd_opts = RenderOptions(fd_size, fd_size, fd_spp, fd_spp, epsilon=1e-3,
                            max_depth=4)
    fd_key = jax.random.PRNGKey(0)
    fd_target = jax.lax.stop_gradient(render_image_diff(
        scene, camera, fd_opts, jax.random.PRNGKey(99), fd_spp))
    _, g_fd = loss_and_grad(params, scene, camera, fd_opts, fd_target,
                            fd_key, fd_spp)
    fd_rec = {}
    for field, idx in (("mat_diffuse", (1, 0)), ("mat_emission", (2, 0))):
        an = float(g_fd[field][idx])
        fd = finite_difference_grad(params, scene, camera, fd_opts, fd_target,
                                    fd_key, fd_spp, field, idx, eps=2e-3)
        fd_rec[f"{field}{list(idx)}"] = {"analytic": an, "fd": fd}
        check(abs(an - fd) <= 1e-4 + 0.05 * abs(fd),
              f"FD check {field}{idx}: analytic {an} vs fd {fd}")
    rec["finite_difference"] = fd_rec

    # Inverse rendering: five Adam steps from a darkened albedo. Only the
    # diffuse table is free (tests/test_diff.py's setting): with emission
    # free too, Adam's first steps turn the walls into emitters. The loss
    # before and after is the unbiased two-render estimator (plain L2 also
    # counts the render's variance, which a brighter albedo raises) under
    # common random numbers, so MC noise cannot decide the comparison.
    a_opts = RenderOptions(adam_size, adam_size, adam_spp, adam_spp,
                           epsilon=1e-3, max_depth=max_depth)
    a_target = render_image_diff(scene, camera, a_opts,
                                 jax.random.PRNGKey(1), 4 * adam_spp)
    true_diffuse = params["mat_diffuse"]
    init = {"mat_diffuse": true_diffuse * 0.5}
    t0 = time.perf_counter()
    recovered, losses = inverse_render(scene, camera, a_opts, a_target, init,
                                       steps=adam_steps, spp=adam_spp, seed=2)
    wall = time.perf_counter() - t0
    e_key = jax.random.PRNGKey(3)
    before, after = (
        float(image_loss_unbiased(p, scene, camera, a_opts, a_target, e_key,
                                  adam_spp))
        for p in (init, recovered))
    err_before, err_after = (
        float(jnp.abs(p["mat_diffuse"] - true_diffuse).sum())
        for p in (init, recovered))
    check(after < before and err_after < err_before,
          f"Adam steps: loss {before} -> {after}, albedo error "
          f"{err_before} -> {err_after} (per step {losses.tolist()})")
    rec["inverse_render"] = {"steps": adam_steps, "wall_s_with_compile": wall,
                             "loss_before": before, "loss_after": after,
                             "albedo_err_before": err_before,
                             "albedo_err_after": err_after,
                             "step_losses": losses.tolist()}
    return rec


def phase_demo(out_dir, width=256, height=256, spp_min=16, spp_max=64,
               extra=()):
    """The reference demo scene (glass dragon, mirror sphere, thin lens,
    adaptive sampling) through demo.py's own `main`."""
    import demo

    os.makedirs(out_dir, exist_ok=True)
    png = os.path.join(out_dir, "demo.png")
    argv = [png, "--width", str(width), "--height", str(height),
            "--spp-min", str(spp_min), "--spp-max", str(spp_max), *extra]
    walls = []
    for _ in range(2):  # the first run compiles
        t0 = time.perf_counter()
        rc = demo.main(argv)
        walls.append(time.perf_counter() - t0)
        check(rc == 0, f"demo.main returned {rc}")
    check(os.path.getsize(png) > 0, "demo wrote no PNG")
    return {"png": png, "size": [width, height], "spp": [spp_min, spp_max],
            "compile_s": walls[0] - walls[1], "wall_s": walls[1],
            "mrays_s_upper_bound": width * height * spp_max / walls[1] / 1e6,
            "peak_bytes_in_use": peak_bytes()}


def _se_of_mean(scene, camera, opts, spp):
    """Standard error of the frame-mean radiance at `spp` samples per pixel,
    from the per-sample variance of this estimator (one sample per stats
    batch through render_chunk_batched)."""
    jax = _jax()
    import jax.numpy as jnp

    from cpupathtrace_tpu.integrator.film import (
        pixel_camera_coords,
        render_chunk_batched,
    )

    xg, yg = np.meshgrid(np.arange(opts.image_width, dtype=np.float32),
                         np.arange(opts.image_height, dtype=np.float32))
    x, y = pixel_camera_coords(opts, xg.ravel(), yg.ravel())
    s_b, _ = render_chunk_batched(scene, camera, opts, jnp.asarray(x),
                                  jnp.asarray(y), jax.random.PRNGKey(7), 1, spp)
    vals = np.asarray(s_b)[..., :3]  # [spp, P, 3]
    per_var = vals.var(axis=0, ddof=1)
    return lambda n: float(np.sqrt(per_var.sum() / n) / (3 * vals.shape[1]))


def phase_four(n_devices=4, size=128, spp=64, spp_min=16, spp_max=64,
               max_depth=12, train_size=64, gp_tris=20000, gp_size=32):
    """One frame sharded over a (dp, sp) mesh of `n_devices` cards against
    one card: fixed-spp and adaptive renders (coverage exact, radiance
    within 5*sqrt(2) standard errors), one sharded training step, and
    geometry-parallel sweep tables 1-way vs n-way (bitwise)."""
    jax = _jax()
    import jax.numpy as jnp

    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.diff.render import get_material_params
    from cpupathtrace_tpu.models.scenes import (
        bench_box_scene,
        bench_camera,
        bench_dragon_scene,
    )
    from cpupathtrace_tpu.parallel import (
        adaptive_sample_axis,
        make_gp_mesh,
        make_render_mesh,
        render_chunk_sharded,
        render_gp,
        render_sharded,
        render_sharded_adaptive,
    )
    from cpupathtrace_tpu.parallel.train import pixel_grid, train_step_sharded

    devices = jax.devices()[:n_devices]
    check(len(devices) == n_devices,
          f"need {n_devices} devices, have {len(jax.devices())}")
    scene, camera = bench_box_scene(), bench_camera()
    mesh, mesh1 = make_render_mesh(devices), make_render_mesh(devices[:1])
    rec = {"mesh": dict(mesh.shape)}

    def run(fn, *args, **kw):
        fn(*args, **kw)  # compile
        t0 = time.perf_counter()
        out = fn(*args, **kw)  # host arrays: synced
        return out, time.perf_counter() - t0

    opts = RenderOptions(size, size, spp, spp, epsilon=1e-3,
                         max_depth=max_depth)
    se = _se_of_mean(scene, camera, opts, spp)
    img_n, wall_n = run(render_sharded, scene, camera, opts, mesh, seed=0,
                        spp=spp)
    img_1, wall_1 = run(render_sharded, scene, camera, opts, mesh1, seed=0,
                        spp=spp)
    check(np.array_equal(img_n[..., 3], img_1[..., 3]),
          "sharded coverage differs from one card")
    diff = abs(float(img_n[..., :3].mean()) - float(img_1[..., :3].mean()))
    bound = 5.0 * np.sqrt(2.0) * se(spp)
    check(diff <= bound, f"sharded radiance off by {diff} (> {bound})")
    rays = size * size * spp
    rec["render_sharded"] = {
        "size": size, "spp": spp, "wall_s": wall_n, "wall_s_one_card": wall_1,
        "mrays_s": rays / wall_n / 1e6, "mrays_s_one_card": rays / wall_1 / 1e6,
        "mean_diff": diff, "bound": bound}

    a_opts = RenderOptions(size, size, spp_min, spp_max, epsilon=1e-3,
                           max_depth=max_depth)
    mesh_a = make_render_mesh(
        devices, sample_axis=adaptive_sample_axis(a_opts, n_devices))
    img_an, wall_an = run(render_sharded_adaptive, scene, camera, a_opts,
                          mesh_a, seed=0)
    img_a1, wall_a1 = run(render_sharded_adaptive, scene, camera, a_opts,
                          mesh1, seed=0)
    check(np.array_equal(img_an[..., 3] > 0, img_a1[..., 3] > 0),
          "adaptive sharded coverage differs from one card")
    diff_a = abs(float(img_an[..., :3].mean()) - float(img_a1[..., :3].mean()))
    bound_a = 5.0 * np.sqrt(2.0) * se(spp_min)
    check(diff_a <= bound_a,
          f"adaptive sharded radiance off by {diff_a} (> {bound_a})")
    rec["render_sharded_adaptive"] = {
        "mesh": dict(mesh_a.shape), "spp": [spp_min, spp_max],
        "wall_s": wall_an, "wall_s_one_card": wall_a1,
        "mean_diff": diff_a, "bound": bound_a}

    t_opts = RenderOptions(train_size, train_size, 4, 4, max_depth=8)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    t_spp = 4 * sp
    x, y = pixel_grid(t_opts, dp)
    key = jax.random.PRNGKey(0)
    sums, counts = render_chunk_sharded(scene, camera, t_opts, mesh, x, y,
                                        key, t_spp)
    target = jax.lax.stop_gradient(sums / jnp.maximum(counts, 1)[:, None])
    params = jax.tree.map(lambda a: a * 0.8, get_material_params(scene))
    t0 = time.perf_counter()
    new_params, loss = jax.block_until_ready(train_step_sharded(
        params, scene, camera, t_opts, mesh, target, x, y,
        jax.random.fold_in(key, 1), t_spp))
    moved = sum(float(jnp.abs(a - b).sum()) for a, b in zip(
        jax.tree.leaves(params), jax.tree.leaves(new_params)))
    check(bool(jnp.isfinite(loss)) and moved > 0.0,
          f"train step: loss {float(loss)}, parameters moved {moved}")
    rec["train_step_sharded"] = {"size": train_size, "spp": t_spp,
                                 "loss": float(loss), "moved": moved,
                                 "wall_s_with_compile": time.perf_counter() - t0}

    gp_scene = bench_dragon_scene(dragon_tris=gp_tris, accel="sweep")
    gp_opts = RenderOptions(gp_size, gp_size, 4, 4, epsilon=1e-3, max_depth=6)
    img_g1 = render_gp(gp_scene, camera, gp_opts, make_gp_mesh(devices[:1]),
                       seed=3)
    img_gn = render_gp(gp_scene, camera, gp_opts, make_gp_mesh(devices),
                       seed=3)
    check(np.array_equal(img_g1, img_gn),
          "geometry-parallel render differs between 1-way and n-way")
    check(bool((img_gn[..., 3] == 1.0).all()), "gp coverage not exact")
    rec["geometry_parallel"] = {"tris": gp_scene.n_tri, "size": gp_size,
                                "bitwise_equal": True}
    rec["peak_bytes_in_use"] = peak_bytes()
    return rec


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    ap.add_argument("--out", default=os.path.join(HERE, "out"),
                    help="directory for the demo PNG")
    args = ap.parse_args(argv)

    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    jax = _jax()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (default device: {dev}); nothing run",
              file=sys.stderr)
        return 2

    from cpupathtrace_tpu.utils.runtime import card_info, configure_compile_cache

    configure_compile_cache()
    card = card_info()
    print(card, flush=True)

    def emit(phase, fn, *a, **kw):
        t0 = time.perf_counter()
        rec = fn(*a, **kw)
        print(json.dumps({"phase": phase, "card": card,
                          "phase_wall_s": time.perf_counter() - t0, **rec}),
              flush=True)

    if args.four:
        emit("four", phase_four)
    else:
        emit("device", phase_device)
        emit("golden", phase_golden)
        emit("intersect", phase_intersect)
        emit("frames", phase_frames)
        emit("grad", phase_grad)
        emit("demo", phase_demo, args.out)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
