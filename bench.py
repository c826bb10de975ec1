"""Benchmarks: the reference's renderSceneBox and renderSceneDragonBox
workloads, and the loss+gradient pass on the box, on one NVIDIA GPU.

Replicates benchmark/main.cpp:34-57 (closed 2x2x2 box, 12 wall tris + 2
emissive ceiling tris, camera at (0,0,-3) aspect -1, 128x128 @ 256 spp) and
benchmark/main.cpp:59-105 (same box + the dragon mesh as glass IOR 1.5 —
the upstream asset is a missing LFS blob, so the 200k-triangle procedural
stand-in from models/scenes.py is used, identically in the C++ baseline
measurements). Throughput uses the reference's items-processed convention:
width * height * spp primary samples per second (benchmark/main.cpp:30).

vs_baseline denominators: the C++ reference compiled -O3 on a 4-core CPU
(BASELINE.md):
  * renderSceneBox 128x128 @ 256 spp:        0.883 Mrays/s
  * renderSceneDragonBox 128x128 @ 16 spp:   0.308 Mrays/s

Prints one JSON line per workload, the box last. Every line names the
device it ran on; without a GPU the script exits non-zero and prints no
result. The on-card correctness checks live in chip_smoke.py.
"""
import argparse
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

# The C++ reference on a 4-core CPU (BASELINE.md).
REFERENCE_CPU_BOX_MRAYS = 0.883
REFERENCE_CPU_DRAGON_MRAYS = 0.308

BOX_SIZE = 128
BOX_SPP = 256
BOX_SPP_CHUNK = 64
DRAGON_SIZE = 128
DRAGON_SPP = 16
# All 262,144 rays of the frame in one launch: it fits the card (peak
# 14.1 GB). Whether 16,384-ray launches are faster is undecided (PERF.md).
DRAGON_SPP_CHUNK = 16
DRAGON_TRIS = 200000


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _frame_fn(scene, camera, options, width, height, spp_chunk, n_chunks):
    from cpupathtrace_tpu.integrator.film import pixel_camera_coords, render_chunk

    xg, yg = np.meshgrid(
        np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32)
    )
    x_cam, y_cam = pixel_camera_coords(options, xg.ravel(), yg.ravel())
    x_cam = jnp.asarray(x_cam, jnp.float32)
    y_cam = jnp.asarray(y_cam, jnp.float32)

    def frame(seed):
        key = jax.random.PRNGKey(seed)
        total = jnp.zeros((width * height, 4))
        count = jnp.zeros(width * height, jnp.int32)
        for k in jax.random.split(key, n_chunks):
            s, c = render_chunk(
                scene, camera, options, x_cam, y_cam, k, spp_chunk
            )
            total = total + s
            count = count + c
        return total, count

    return frame


def _timed_batches(step, n_rays, name, batches, per_batch):
    """`batches` batches of `per_batch` steps enqueued back to back, each
    ending in one `block_until_ready`; returns seconds per step."""
    batch_s = []
    i = 1
    for b in range(batches):
        t0 = time.perf_counter()
        outs = []
        for _ in range(per_batch):
            outs.append(step(i))
            i += 1
        jax.block_until_ready(outs)
        dt = (time.perf_counter() - t0) / per_batch
        batch_s.append(dt)
        log(f"# {name} batch {b}: {dt*1000:.1f} ms/step "
            f"({n_rays/dt/1e6:.2f} Mrays/s)")
    return batch_s


def _result(name, batch_s, n_rays, baseline, compile_s, device, extra=None):
    med = float(np.median(batch_s))
    mrays = n_rays / med / 1e6
    res = {
        "metric": f"{name}_throughput",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": mrays / baseline,
        "spread_pct": 100 * (max(batch_s) - min(batch_s)) / med,
        "batch_ms_per_step": [t * 1000 for t in batch_s],
        "compile_s": compile_s,
        **device,
    }
    res.update(extra or {})
    return res


def run_workload(name, scene, camera, options, spp, spp_chunk, baseline,
                 device, batches=3, frames_per_batch=3):
    w, h = options.image_width, options.image_height
    frame = _frame_fn(scene, camera, options, w, h, spp_chunk,
                      spp // spp_chunk)
    t0 = time.perf_counter()
    jax.block_until_ready(frame(0))
    compile_s = time.perf_counter() - t0
    n_rays = w * h * spp
    batch_s = _timed_batches(frame, n_rays, name, batches, frames_per_batch)
    total, count = frame(batches * frames_per_batch + 1)
    img = np.asarray(total) / np.maximum(np.asarray(count), 1)[:, None]
    return _result(name, batch_s, n_rays, baseline, compile_s, device, {
        "mean_rgb": float(img[:, :3].mean()),
        "alpha": float(img[:, 3].mean()),
    })


def run_box_grad(device, batches=3, per_batch=5):
    """Loss + material gradients on the box workload (128x128 @ 16 spp per
    pass, max_depth 12). The CPU reference renders no gradients, so
    vs_baseline compares against its FORWARD box throughput."""
    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.diff.render import get_material_params, loss_and_grad
    from cpupathtrace_tpu.models.scenes import bench_box_scene, bench_camera

    scene = bench_box_scene()
    camera = bench_camera()
    spp = 16
    options = RenderOptions(BOX_SIZE, BOX_SIZE, spp, spp, epsilon=1e-3,
                            max_depth=12)
    params = get_material_params(scene)
    target = jnp.zeros((BOX_SIZE * BOX_SIZE, 4))
    key = jax.random.PRNGKey(5)

    def step(i):
        return loss_and_grad(params, scene, camera, options, target,
                             jax.random.fold_in(key, i), spp)

    t0 = time.perf_counter()
    jax.block_until_ready(step(0))
    compile_s = time.perf_counter() - t0
    n_rays = BOX_SIZE * BOX_SIZE * spp
    batch_s = _timed_batches(step, n_rays, "renderSceneBoxGrad", batches,
                             per_batch)
    return _result("renderSceneBoxGrad", batch_s, n_rays,
                   REFERENCE_CPU_BOX_MRAYS, compile_s, device, {
                       "note": "loss+grad pass; baseline is the CPU "
                               "reference's FORWARD box throughput",
                   })


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", default="dragon,box,boxgrad")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench.py: no GPU (default device: {dev}); nothing measured")
        return 2

    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.models.scenes import (
        bench_box_scene,
        bench_camera,
        bench_dragon_scene,
    )
    from cpupathtrace_tpu.utils.runtime import card_info, configure_compile_cache

    configure_compile_cache()
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices()), "card": card_info()}
    camera = bench_camera()
    workloads = args.workloads.split(",")

    if "dragon" in workloads:
        t0 = time.perf_counter()
        scene = bench_dragon_scene(dragon_tris=DRAGON_TRIS, accel="binned")
        log(f"# dragon scene built in {time.perf_counter()-t0:.1f}s "
            f"({scene.n_tri} tris, C={scene.blk_lo.shape[0]}, "
            f"L={scene.cluster_size})")
        options = RenderOptions(DRAGON_SIZE, DRAGON_SIZE, DRAGON_SPP,
                                DRAGON_SPP, epsilon=1e-3, max_depth=40)
        print(json.dumps(run_workload(
            "renderSceneDragonBox", scene, camera, options, DRAGON_SPP,
            DRAGON_SPP_CHUNK, REFERENCE_CPU_DRAGON_MRAYS, device,
        )), flush=True)

    if "boxgrad" in workloads:
        print(json.dumps(run_box_grad(device)), flush=True)

    if "box" in workloads:
        options = RenderOptions(BOX_SIZE, BOX_SIZE, BOX_SPP, BOX_SPP,
                                epsilon=1e-3, max_depth=40)
        print(json.dumps(run_workload(
            "renderSceneBox", bench_box_scene(), camera, options, BOX_SPP,
            BOX_SPP_CHUNK, REFERENCE_CPU_BOX_MRAYS, device,
            frames_per_batch=8,
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
