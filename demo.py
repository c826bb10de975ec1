"""PathTraceDemo — CLI demo app replicating the reference's demo/main.cpp.

Renders the Cornell-box demo scene (colored walls, emissive ceiling panel,
glass dragon mesh, blue mirror sphere, rotated stretched white box; thin-lens
camera with circular aperture) with a console progress bar, post-processes,
and writes a PNG (ref: demo/main.cpp:22-241).

Usage: python demo.py [output.png] [--width N] [--height N] [--spp-min N]
                      [--spp-max N] [--dragon path/to/xyzrgb_dragon.obj]
                      [--no-dragon] [--sharded]
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("output", nargs="?", default="render_box.png")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--spp-min", type=int, default=16)
    p.add_argument("--spp-max", type=int, default=64)
    p.add_argument("--max-depth", type=int, default=40)
    p.add_argument("--dragon", default=None, help="path to xyzrgb_dragon.obj")
    p.add_argument("--no-dragon", action="store_true")
    p.add_argument("--dragon-tris", type=int, default=20000,
                   help="triangle count of the procedural dragon stand-in")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sharded", action="store_true",
                   help="fixed-spp SPMD render over all local devices")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU backend instead of the GPU")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        print(f"no GPU found (default device: {jax.devices()[0]}); "
              "pass --cpu to render on the CPU", file=sys.stderr)
        return 2

    import numpy as np
    import cpupathtrace_tpu as ptx
    from cpupathtrace_tpu.utils.runtime import configure_compile_cache
    from cpupathtrace_tpu.models.scenes import (
        cornell_demo_camera,
        cornell_demo_options,
        cornell_demo_scene,
    )

    configure_compile_cache()
    print(f"devices: {jax.devices()}", file=sys.stderr)
    t0 = time.time()
    scene = cornell_demo_scene(
        dragon_obj=args.dragon,
        dragon_tris=args.dragon_tris,
        include_dragon=not args.no_dragon,
    )
    print(
        f"scene: {scene.n_tri} triangles, {scene.n_sph} spheres, "
        f"{scene.n_emissive} emitters, BVH={'on' if scene.use_bvh else 'off'} "
        f"({time.time()-t0:.1f}s)",
        file=sys.stderr,
    )
    camera = cornell_demo_camera(args.width, args.height)
    options = cornell_demo_options(
        args.width, args.height,
        min_sample_count=args.spp_min, max_sample_count=args.spp_max,
        max_depth=args.max_depth,
    )

    def progress(done, total):
        # Console progress bar (ref: demo/main.cpp:211-226).
        frac = done / total
        bar = "#" * int(frac * 50)
        print(f"\r[{bar:<50}] {done}/{total}", end="", file=sys.stderr, flush=True)

    t0 = time.time()
    if args.sharded:
        # Full adaptive min/max-spp contract over the device mesh — the
        # same stopping rule as the single-device path, chunks sharded
        # (dp over pixels, sp over samples), with tile progress.
        from cpupathtrace_tpu.parallel import (
            adaptive_sample_axis,
            make_render_mesh,
            render_sharded_adaptive,
        )

        mesh = make_render_mesh(
            sample_axis=adaptive_sample_axis(options, len(jax.devices()))
        )
        img = render_sharded_adaptive(
            scene, camera, options, mesh, seed=args.seed,
            progress_callback=progress,
        )
    else:
        img = ptx.render(scene, camera, options, seed=args.seed,
                         progress_callback=progress)
    print(file=sys.stderr)
    dt = time.time() - t0
    rays = args.width * args.height * args.spp_max
    print(f"rendered in {dt:.1f}s (<= {rays/dt/1e6:.2f} Mrays/s)", file=sys.stderr)

    out = ptx.post_process(img)
    try:
        ptx.write_rgb_image(args.output, np.asarray(out))
    except Exception as e:  # (ref: demo/main.cpp:230-238)
        print(f"failed to write image: {e}", file=sys.stderr)
        return 1
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
