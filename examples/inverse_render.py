"""Inverse rendering example: recover wall albedo and emitter radiance
from a target image by gradient descent — the differentiable capability
the C++ reference lacks entirely.

Renders a ground-truth Cornell box, perturbs the red accent wall's
albedo, then recovers it with Adam on an unbiased image loss
(independent-sample pairing keeps E[loss grad] unbiased despite MC
noise). Emitters stay pinned at truth: with both albedo and emission
free the problem is ambiguous (a dimmer light and brighter walls explain
the same image). Prints the loss curve and the recovered vs true albedo,
and writes before/after/target PNGs.

Usage: python examples/inverse_render.py [outdir] [--steps N] [--cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("outdir", nargs="?", default="/tmp/inverse_render")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    import cpupathtrace_tpu as ptx
    from cpupathtrace_tpu.diff.render import (
        apply_material_params,
        get_material_params,
        inverse_render,
        render_image_diff,
    )
    from cpupathtrace_tpu.scene.geometry import make_plane

    os.makedirs(args.outdir, exist_ok=True)

    # Ground-truth scene: white box, red accent wall, emissive panel.
    b = ptx.SceneBuilder()
    white = b.add_material(diffuse=(1, 1, 1, 1))
    red = b.add_material(diffuse=(0.9, 0.15, 0.15, 1))
    light = b.add_material(diffuse=(1, 1, 1, 1), emission=(1.0, 0.9, 0.7, 1))
    b.add_triangles(make_plane((1, -1, -1), (-1, -1, 1), True), white)
    b.add_triangles(make_plane((-1, 1, -1), (1, 1, 1), True), white)
    b.add_triangles(
        make_plane((-0.25, 0.99, -0.25), (0.25, 0.99, 0.25), True), light
    )
    b.add_triangles(make_plane((-1, -1, -1), (1, 1, -1), True), white)
    b.add_triangles(make_plane((-1, -1, -1), (-1, 1, 1), True), white)
    b.add_triangles(make_plane((1, -1, 1), (-1, 1, 1), True), red)
    b.add_triangles(make_plane((1, -1, 1), (1, 1, -1), True), white)
    scene = b.build()
    cam = ptx.make_camera((0, 0, 0), (0, 0, 0.9), (0, 1, 0), 1.0, 1.0, 1.0)
    opts = ptx.RenderOptions(
        args.size, args.size, args.spp, args.spp, epsilon=1e-3, max_depth=4
    )

    key = jax.random.PRNGKey(0)

    def render_with(params, spp):
        return render_image_diff(
            apply_material_params(scene, params), cam, opts, key, spp=spp
        )

    target = render_with({}, 256)
    true_red = np.asarray(scene.mat_diffuse)[red]

    # Perturbed start: grey accent wall. Only the diffuse table is
    # optimized; emission/specular stay at truth (see module docstring).
    true_params = get_material_params(scene)
    init = {
        "mat_diffuse": true_params["mat_diffuse"].at[red].set(
            jnp.asarray([0.5, 0.5, 0.5, 1.0])
        )
    }

    def save(params, name):
        img = np.asarray(render_with(params, 256)).reshape(
            args.size, args.size, 4
        )
        ptx.write_rgb_image(
            os.path.join(args.outdir, name), np.asarray(ptx.post_process(img))
        )

    save(init, "before.png")
    save({}, "target.png")

    t0 = time.time()
    recovered, losses = inverse_render(
        scene, cam, opts, target, init,
        steps=args.steps, learning_rate=0.05, spp=args.spp, seed=1,
        callback=lambda i, loss, _p: print(
            f"step {i:3d}  loss {loss:.5f}", file=sys.stderr, flush=True
        ) if i % 10 == 0 else None,
    )
    print(f"# {args.steps} Adam steps in {time.time()-t0:.1f}s",
          file=sys.stderr)
    save(recovered, "after.png")

    got_red = np.asarray(recovered["mat_diffuse"])[red]
    print(f"red wall albedo: true {true_red[:3]}, recovered {got_red[:3]}")
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.5f}")
    err = float(abs(got_red[:3] - true_red[:3]).max())
    print(f"max albedo error: {err:.3f}")
    return 0 if err < 0.2 else 1


if __name__ == "__main__":
    raise SystemExit(main())
