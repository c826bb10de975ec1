"""Auxiliary subsystem tests: profiling counters, progress callbacks,
distributed helpers, CLI demo smoke (SURVEY §5 coverage)."""
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from cpupathtrace_tpu.utils.profiling import RayCounter, progress_printer


def test_ray_counter():
    c = RayCounter()
    c.start()
    c.stop(1_000_000)
    assert c.samples == 1_000_000
    assert c.seconds > 0
    assert c.mrays_per_s > 0
    assert "Mrays/s" in c.report()
    with pytest.raises(RuntimeError):
        c.stop(1)


def test_progress_printer():
    buf = io.StringIO()
    cb = progress_printer(stream=buf, width=10)
    cb(1, 4)
    cb(4, 4)
    out = buf.getvalue()
    assert "1/4" in out and "4/4" in out


def test_distributed_single_process_noop():
    from cpupathtrace_tpu.parallel.distributed import (
        gather_image,
        host_local_rows,
        initialize,
    )

    initialize()  # no-op single process
    lo, hi = host_local_rows(64)
    assert (lo, hi) == (0, 64)
    img = np.ones((4, 4, 4), np.float32)
    np.testing.assert_array_equal(gather_image(img, 4), img)


def test_demo_cli_smoke(tmp_path):
    """The demo app end-to-end at tiny size on the CPU backend
    (ref analog: demo/main.cpp)."""
    out = tmp_path / "demo.png"
    r = subprocess.run(
        [
            sys.executable, "demo.py", str(out),
            "--width", "8", "--height", "8",
            "--spp-min", "2", "--spp-max", "2",
            "--max-depth", "4", "--no-dragon", "--cpu",
        ],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True,
        text=True,
        timeout=500,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists()
    from cpupathtrace_tpu.utils.image_io import read_rgb_image

    img = read_rgb_image(out)
    assert img.shape == (8, 8, 4)


def test_checkpoint_cli_roundtrip(tmp_path):
    # render_resumable already covered in test_checkpoint; here just the
    # save/load format version guard.
    from cpupathtrace_tpu.integrator.checkpoint import (
        FilmState, load_checkpoint, save_checkpoint,
    )

    st = FilmState(
        pixel_sum=np.zeros((4, 4)), sample_count=np.zeros(4, np.int64),
        chunks_done=1, spp=4, spp_chunk=2, seed=3, width=2, height=2,
    )
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, st)
    back = load_checkpoint(p)
    assert back.chunks_done == 1 and back.seed == 3 and back.spp == 4
