"""Real multi-process coverage for the multi-host runtime
(parallel/distributed.py): two OS processes, each with 4 virtual CPU
devices, form one jax.distributed cluster (Gloo collectives over
localhost), render their host-row blocks, and all-gather the image —
the CPU stand-in for the reference-less multi-host capability
(SURVEY §5: the reference is strictly single-process)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_render_gather(tmp_path):
    """The gathered 2-process image equals a single-process render of the
    same row blocks with the same keys — init, host-row assignment, and
    the padded cross-process gather (odd height) all verified for real."""
    worker = os.path.join(os.path.dirname(__file__),
                          "distributed_render_worker.py")
    out = str(tmp_path / "img.npy")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    # The workers must import cpupathtrace_tpu without relying on an
    # editable install; PREPEND the repo root (never replace PYTHONPATH —
    # platform plugins may be distributed via it).
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            o, _ = p.communicate()
        logs.append(o.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    gathered = np.load(out)

    # Single-process oracle: the same per-host row renders, concatenated.
    import jax
    import jax.numpy as jnp

    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.integrator.film import (
        pixel_camera_coords,
        render_chunk,
    )
    from cpupathtrace_tpu.models.scenes import bench_box_scene, bench_camera

    w, h, spp = 16, 13, 4
    scene = bench_box_scene()
    camera = bench_camera()
    options = RenderOptions(w, h, spp, spp, epsilon=1e-3, max_depth=6)
    rows = -(-h // 2)
    blocks = []
    for pid, (lo, hi) in enumerate([(0, rows), (rows, h)]):
        xg, yg = np.meshgrid(
            np.arange(w, dtype=np.float32),
            np.arange(lo, hi, dtype=np.float32),
        )
        x_cam, y_cam = pixel_camera_coords(options, xg.ravel(), yg.ravel())
        key = jax.random.fold_in(jax.random.PRNGKey(7), pid)
        s, c = render_chunk(
            scene, camera, options, jnp.asarray(x_cam, jnp.float32),
            jnp.asarray(y_cam, jnp.float32), key, spp,
        )
        blocks.append(
            (np.asarray(s) / np.maximum(np.asarray(c), 1)[:, None]).reshape(
                hi - lo, w, 4
            )
        )
    oracle = np.concatenate(blocks, axis=0)

    assert gathered.shape == oracle.shape == (h, w, 4)
    np.testing.assert_array_equal(gathered, oracle)
    assert oracle[..., 3].mean() == 1.0  # closed box: full coverage
