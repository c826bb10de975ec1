"""renderSceneDragonBox (200k-triangle stand-in, 128x128 @ 16 spp,
max_depth 40) through `render` at two launch sizes, timed in alternation.

    python benchmarks/dragon_launch.py [--frames N] [RAYS_PER_LAUNCH ...]

Default launch sizes: 16,384 and 262,144 rays (the whole frame in one
launch). Each size is compiled and run once alone, which gives its peak
device memory (sizes in ascending order, as the peak only grows), then
N frames of each are timed in turns A, B, A, B, ... so that drift of the
card's clock falls on both alike. Prints one JSON line per size with every
frame's wall seconds, the median, min and max.
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

from cpupathtrace_tpu import render  # noqa: E402
from cpupathtrace_tpu.core.config import RenderOptions  # noqa: E402
from cpupathtrace_tpu.models.scenes import bench_camera, bench_dragon_scene  # noqa: E402
from cpupathtrace_tpu.utils.runtime import card_info, configure_compile_cache  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int, default=[16384, 262144])
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args(argv)
    configure_compile_cache()
    card = card_info()
    print(card, flush=True)
    scene, cam = bench_dragon_scene(dragon_tris=200000), bench_camera()
    opts = RenderOptions(128, 128, 16, 16, epsilon=1e-3, max_depth=40)
    rec = {}
    for rpl in sorted(args.sizes):
        t0 = time.perf_counter()
        img = render(scene, cam, opts, seed=0, rays_per_launch=rpl)
        rec[rpl] = {"card": card, "rays_per_launch": rpl,
                    "first_s": time.perf_counter() - t0,
                    "peak_bytes_in_use": jax.devices()[0].memory_stats()["peak_bytes_in_use"],
                    "mean_rgb": float(img[..., :3].mean()), "walls_s": []}
    for i in range(args.frames):
        for rpl in sorted(args.sizes):
            t0 = time.perf_counter()
            render(scene, cam, opts, seed=1 + i, rays_per_launch=rpl)  # host result: synced
            rec[rpl]["walls_s"].append(time.perf_counter() - t0)
    for r in rec.values():
        w = np.asarray(r["walls_s"])
        r.update(median_s=float(np.median(w)), min_s=float(w.min()), max_s=float(w.max()),
                 mrays_s=128 * 128 * 16 / float(np.median(w)) / 1e6)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
