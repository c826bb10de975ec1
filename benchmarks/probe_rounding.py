"""Rounding of the renderer's f32 arithmetic on the default device, against
the CPU backend and float64, and what it does to the emissive-sphere image.

    python benchmarks/probe_rounding.py [--raw] [--sections S [S ...]]
                                        [--n-ulp N] [--n-nee N]

`--raw` first turns off the rounding step of `utils.math.sqrt` and `div`, so
they return the backend's own estimate: the arithmetic before they were
correctly rounded.

Prints JSON lines:
  * `ulp` — per operation and backend: share of results that are not the
    correctly rounded f32 value, mean signed error and max |error| in ulps
    (2**20 random operands): jnp's sqrt, division, sin, cos and arccos, and
    the package's `utils.math.sqrt` and `utils.math.div`;
  * `knife_edge` — share of near-side sphere-light samples that NEE counts
    visible (tests/rounding_util.py explains the knife edge), on the default
    device, on the CPU backend and in a numpy IEEE f32 emulation, with the
    per-sample agreement between them;
  * `panel` — share of valid light samples counted visible from points on
    the floor of the renderSceneBox box, whose only occluder is the ceiling
    panel itself: the knife edge of triangle lights;
  * `emsphere` — q25/q50/q75 of the emissive-sphere golden scene
    (32x32 @ 256 spp) on the default device and the CPU backend, against the
    golden (tests/golden/golden_emsphere_32.raw);
  * `timing` (default device only) — what the rounding costs: sweep
    intersection of 262,144 rays on the 200k-triangle dragon, dense
    intersection of 1,048,576 rays in the box, the renderSceneBox frame
    (128x128 @ 256 spp, max_depth 40) and the renderSceneDragonBox frame
    (128x128 @ 16 spp in one launch, with its XLA temp bytes).
The card's name and power limit come first. `--sections` picks sections
(default: all).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cpupathtrace_tpu.utils import math as pmath  # noqa: E402
from cpupathtrace_tpu.utils.runtime import card_info, configure_compile_cache  # noqa: E402
from tests import rounding_util as ru  # noqa: E402
from tests import test_parity  # noqa: E402
from tests.scenes_util import emissive_sphere_scene  # noqa: E402

OPS = {
    "jnp.sqrt": (lambda x, y, a, th: jnp.sqrt(x), lambda x, y, a, th: np.sqrt(x)),
    "jnp.div": (lambda x, y, a, th: x / y, lambda x, y, a, th: x / y),
    "math.sqrt": (lambda x, y, a, th: pmath.sqrt(x), lambda x, y, a, th: np.sqrt(x)),
    "math.div": (lambda x, y, a, th: pmath.div(x, y), lambda x, y, a, th: x / y),
    "jnp.sin": (lambda x, y, a, th: jnp.sin(th), lambda x, y, a, th: np.sin(th)),
    "jnp.cos": (lambda x, y, a, th: jnp.cos(th), lambda x, y, a, th: np.cos(th)),
    "jnp.arccos": (lambda x, y, a, th: jnp.arccos(a), lambda x, y, a, th: np.arccos(a)),
}


SECTIONS = ["ulp", "knife_edge", "panel", "emsphere", "timing"]


def timing(raw):
    """Median wall seconds of the rounding-heavy work on the default device."""
    import chip_smoke
    from cpupathtrace_tpu import render
    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.integrator.film import pixel_camera_coords, render_chunk
    from cpupathtrace_tpu.models.scenes import bench_box_scene, bench_camera, bench_dragon_scene
    from cpupathtrace_tpu.ops.intersect import dense_intersect, scene_intersect

    rng = np.random.default_rng(0)
    row = {"probe": "timing", "raw": raw}
    dragon = bench_dragon_scene(dragon_tris=200000, accel="binned")
    o = rng.uniform(-0.95, 0.95, (262144, 3)).astype(np.float32)
    d = rng.normal(size=(262144, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _, c_s, w, _ = chip_smoke.timed_jit(scene_intersect, dragon, jnp.asarray(o), jnp.asarray(d), reps=10)
    row["sweep_262144"] = {"compile_s": c_s, "wall_s": w}
    box = bench_box_scene()
    ob = np.zeros((1 << 20, 3), np.float32)
    ob[:, 2] = -2.9
    db = np.stack([rng.uniform(-0.8, 0.8, 1 << 20), rng.uniform(-0.8, 0.8, 1 << 20),
                   np.ones(1 << 20)], -1).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    _, c_s, w, _ = chip_smoke.timed_jit(dense_intersect, box, jnp.asarray(ob), jnp.asarray(db), reps=10)
    row["dense_box_1048576"] = {"compile_s": c_s, "wall_s": w}
    opts = RenderOptions(128, 128, 256, 256, epsilon=1e-3, max_depth=40)
    render(box, bench_camera(), opts, seed=0)
    walls = []
    for i in range(5):
        t0 = time.perf_counter()
        render(box, bench_camera(), opts, seed=1 + i)  # host result: synced
        walls.append(time.perf_counter() - t0)
    row["box_frame"] = {"walls_s": walls, "median_s": float(np.median(walls))}
    d_opts = RenderOptions(128, 128, 16, 16, epsilon=1e-3, max_depth=40)
    render(dragon, bench_camera(), d_opts, seed=0)
    walls = []
    for i in range(3):
        t0 = time.perf_counter()
        render(dragon, bench_camera(), d_opts, seed=1 + i)
        walls.append(time.perf_counter() - t0)
    xg, yg = np.meshgrid(np.arange(128, dtype=np.float32), np.arange(128, dtype=np.float32))
    x, y = pixel_camera_coords(d_opts, xg.ravel(), yg.ravel())
    mem = render_chunk.lower(dragon, bench_camera(), d_opts, jnp.asarray(x), jnp.asarray(y),
                             jax.random.PRNGKey(0), 16).compile().memory_analysis()
    row["dragon_frame"] = {"walls_s": walls, "median_s": float(np.median(walls)),
                           "render_chunk_temp_bytes": int(mem.temp_size_in_bytes)}
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-ulp", type=int, default=1 << 20)
    ap.add_argument("--n-nee", type=int, default=400000)
    ap.add_argument("--sections", nargs="+", default=SECTIONS, choices=SECTIONS)
    ap.add_argument("--raw", action="store_true",
                    help="use the backend's sqrt and division unrounded")
    args = ap.parse_args(argv)
    if args.raw:
        pmath._round_step = lambda s, below: s
    configure_compile_cache()
    dev, cpu = jax.devices()[0], jax.devices("cpu")[0]
    print(card_info() if dev.platform == "gpu" else f"no GPU: {dev}", flush=True)
    backends = {dev.platform: dev} if dev.platform == "cpu" else {dev.platform: dev, "cpu": cpu}

    if "ulp" in args.sections:
        inp = ru.ulp_inputs(args.n_ulp)
        operands = [inp[k] for k in ("x", "y", "a", "th")]
        for name, (fn, ref) in OPS.items():
            row = {"probe": "ulp", "op": name, "raw": args.raw}
            for b, d in backends.items():
                row[b] = ru.ulp_row(fn, ref, operands, d)
            print(json.dumps(row), flush=True)

    key = jax.random.PRNGKey(0)
    pos = ru.floor_points(args.n_nee)
    if "knife_edge" in args.sections:
        scene = emissive_sphere_scene()
        res = {b: ru.near_side_visible(scene, pos, key, d) for b, d in backends.items()}
        res["ieee"] = ru.near_side_visible_ieee(pos, *ru.light_sample_uniforms(args.n_nee, key))
        row = {"probe": "knife_edge", "raw": args.raw, "samples": args.n_nee,
               "near_samples": int(res["ieee"][1].sum())}
        for b, (vis, near) in res.items():
            row[b] = {"near_visible": ru.share(vis, near),
                      "far_visible": float(vis[~near].mean())}
        names = list(res)
        for i, p in enumerate(names):
            for q in names[i + 1:]:
                both = res[p][1] & res[q][1]
                row[f"agree_{p}_{q}"] = float((res[p][0] == res[q][0])[both].mean())
        print(json.dumps(row), flush=True)

    if "panel" in args.sections:
        from cpupathtrace_tpu.models.scenes import bench_box_scene

        scene = bench_box_scene()
        res = {b: ru.light_visible(scene, pos, key, d)[1:] for b, d in backends.items()}
        row = {"probe": "panel", "raw": args.raw, "samples": int(res["cpu"][1].size)}
        for b, (vis, valid) in res.items():
            row[b] = {"visible": ru.share(vis, valid)}
        if len(res) > 1:
            (vg, ok), (vc, _) = res[dev.platform], res["cpu"]
            row["agree"] = float((vg == vc)[ok].mean())
        print(json.dumps(row), flush=True)

    if "emsphere" in args.sections:
        golden = test_parity.read_golden("golden_emsphere_32.raw")
        qs = (0.25, 0.5, 0.75)
        row = {"probe": "emsphere", "raw": args.raw, "size": 32, "spp": 256,
               "golden_q": [float(np.quantile(golden[..., :3], q)) for q in qs]}
        for b, d in backends.items():
            t0 = time.perf_counter()
            with jax.default_device(d):
                img = test_parity.render_emissive_sphere()
            row[b] = {"q": [float(np.quantile(img[..., :3], q)) for q in qs],
                      "wall_s_with_compile": time.perf_counter() - t0}
            row[b]["rel_err"] = [a / g - 1.0 for a, g in zip(row[b]["q"], row["golden_q"])]
        print(json.dumps(row), flush=True)

    if "timing" in args.sections and dev.platform != "cpu":
        print(json.dumps(timing(args.raw)), flush=True)


if __name__ == "__main__":
    main()
