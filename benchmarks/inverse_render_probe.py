"""Five Adam steps of `inverse_render` on the box (64x64 @ 16 spp,
max_depth 12), from a half-bright albedo, with the emission table fixed or
free, on JAX's default device.

    python benchmarks/inverse_render_probe.py [--raw]   # default device
    JAX_PLATFORMS=cpu python benchmarks/inverse_render_probe.py

`--raw` turns off the rounding step of `utils.math.sqrt` and `div`
(as benchmarks/probe_rounding.py does).

The seeds are those of `chip_smoke.py`'s grad phase. Per setting it prints
the per-step losses, the plain and the unbiased L2 loss before and after
under one key, the albedo's distance to the truth, and the emission table
after the steps (the box has one emitter, material 1).
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cpupathtrace_tpu.core.config import RenderOptions  # noqa: E402
from cpupathtrace_tpu.diff.render import (  # noqa: E402
    get_material_params,
    image_loss,
    image_loss_unbiased,
    inverse_render,
    render_image_diff,
)
from cpupathtrace_tpu.models.scenes import bench_box_scene, bench_camera  # noqa: E402
from cpupathtrace_tpu.utils import math as pmath  # noqa: E402


def main(argv=None, size=64, spp=16, max_depth=12, steps=5):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--raw", action="store_true",
                    help="use the backend's sqrt and division unrounded")
    raw = ap.parse_args(argv).raw
    if raw:
        pmath._round_step = lambda s, below: s
    scene, camera = bench_box_scene(), bench_camera()
    params = get_material_params(scene)
    opts = RenderOptions(size, size, spp, spp, epsilon=1e-3, max_depth=max_depth)
    target = render_image_diff(scene, camera, opts, jax.random.PRNGKey(1), 4 * spp)
    true_d, true_e = params["mat_diffuse"], params["mat_emission"]
    dev = jax.devices()[0]
    print(json.dumps({"device": f"{dev.platform} {dev.device_kind}", "raw": raw,
                      "target_mean_rgb": float(target[:, :3].mean())}), flush=True)
    for free in ("diffuse", "diffuse+emission"):
        init = {"mat_diffuse": true_d * 0.5}
        if free == "diffuse+emission":
            init["mat_emission"] = true_e
        out, losses = inverse_render(scene, camera, opts, target, init,
                                     steps=steps, spp=spp, seed=2)
        key = jax.random.PRNGKey(3)
        rec = {"device": f"{dev.platform} {dev.device_kind}", "raw": raw, "free": free,
               "step_losses": losses.tolist()}
        for name, fn in (("l2", image_loss), ("unbiased", image_loss_unbiased)):
            rec[name] = [float(fn(p, scene, camera, opts, target, key, spp))
                         for p in (init, out)]
        rec["albedo_err"] = [float(jnp.abs(p["mat_diffuse"] - true_d).sum())
                             for p in (init, out)]
        if "mat_emission" in out:
            rec["emission_after"] = jnp.round(out["mat_emission"][:, :3], 5).tolist()
            rec["emission_true"] = jnp.round(true_e[:, :3], 5).tolist()
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
