"""One `jax.profiler` trace of the renderSceneBox frame (128x128 @ 256 spp
in four launches of 64 spp, max_depth 40): ms per frame and the device's
idle share.

    python benchmarks/profile_box.py [--out DIR]

Times five untraced frames, then traces three inside one host annotation
("box_frames") and reads the trace back: per device line, the busy time
inside that window (kernel intervals merged), the idle share
1 - busy / window, and the eight kernels with the most time. The trace is
kept under DIR/trace_box (default out/).
"""
import argparse
import glob
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cpupathtrace_tpu.core.config import RenderOptions  # noqa: E402
from cpupathtrace_tpu.integrator.film import pixel_camera_coords, render_chunk  # noqa: E402
from cpupathtrace_tpu.models.scenes import bench_box_scene, bench_camera  # noqa: E402
from cpupathtrace_tpu.utils.runtime import card_info, configure_compile_cache  # noqa: E402

SIZE, SPP, CHUNK = 128, 256, 64


def busy_ns(events, lo, hi):
    """Union length of the events' intervals clipped to [lo, hi)."""
    iv = sorted((max(e.start_ns, lo), min(e.start_ns + e.duration_ns, hi))
                for e in events if e.start_ns < hi and e.start_ns + e.duration_ns > lo)
    busy, cur = 0, None
    for a, b in iv:
        if cur is None or a > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return busy + (0 if cur is None else cur[1] - cur[0])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "out"))
    args = ap.parse_args(argv)
    configure_compile_cache()
    print(card_info(), flush=True)
    scene, cam = bench_box_scene(), bench_camera()
    opts = RenderOptions(SIZE, SIZE, SPP, SPP, epsilon=1e-3, max_depth=40)
    xg, yg = np.meshgrid(np.arange(SIZE, dtype=np.float32), np.arange(SIZE, dtype=np.float32))
    x, y = (jnp.asarray(v) for v in pixel_camera_coords(opts, xg.ravel(), yg.ravel()))

    def frame(seed):
        tot, cnt = jnp.zeros((SIZE * SIZE, 4)), jnp.zeros(SIZE * SIZE, jnp.int32)
        for k in jax.random.split(jax.random.PRNGKey(seed), SPP // CHUNK):
            s, c = render_chunk(scene, cam, opts, x, y, k, CHUNK)
            tot, cnt = tot + s, cnt + c
        return tot, cnt

    jax.block_until_ready(frame(0))
    walls = []
    for i in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(frame(10 + i))
        walls.append(time.perf_counter() - t0)
    print(json.dumps({"frame_ms": [w * 1e3 for w in walls],
                      "median_ms": float(np.median(walls)) * 1e3}), flush=True)

    logdir = os.path.join(args.out, "trace_box")
    jax.profiler.start_trace(logdir)
    with jax.profiler.TraceAnnotation("box_frames"):
        jax.block_until_ready([frame(100 + i) for i in range(3)])
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    win = next((ev.start_ns, ev.start_ns + ev.duration_ns)
               for plane in pd.planes for line in plane.lines for ev in line.events
               if ev.name == "box_frames")
    for plane in pd.planes:
        if "GPU" not in plane.name:
            continue
        for line in plane.lines:
            events = list(line.events)
            per_name = {}
            for e in events:
                per_name[e.name] = per_name.get(e.name, 0) + e.duration_ns
            top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
            busy = busy_ns(events, *win)
            print(json.dumps({"plane": plane.name, "line": line.name, "events": len(events),
                              "window_ms": (win[1] - win[0]) / 1e6, "busy_ms": busy / 1e6,
                              "idle_share": 1 - busy / (win[1] - win[0]),
                              "top_ms": [(n[:60], d / 1e6) for n, d in top]}), flush=True)


if __name__ == "__main__":
    main()
