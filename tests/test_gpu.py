"""Tests that need an NVIDIA GPU. They skip elsewhere; on the card they run
in-process from `chip_smoke.py`, or with
`PTX_KEEP_PLATFORM=1 python -m pytest -m gpu tests/test_gpu.py`.

Golden parity: every render fixture of `tests/golden/` through the helpers
and tolerances of `tests/test_parity.py` (too slow for the CPU suite, where
those tests are marked `slow`).

Rounding: the package's `sqrt` and `div` are correctly rounded on the card,
and the knife edge of sphere and triangle lights (tests/rounding_util.py)
and the emissive-sphere image agree with the CPU backend and IEEE f32.
"""
import jax
import numpy as np
import pytest

from tests import rounding_util as ru
from tests import test_parity

pytestmark = pytest.mark.gpu

GOLDEN_CASES = sorted(n for n in vars(test_parity) if n.startswith("test_"))


@pytest.fixture(autouse=True)
def gpu_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the default device is {dev.platform}")
    return dev


@pytest.mark.parametrize("case", GOLDEN_CASES)
def test_golden_parity_on_gpu(case):
    getattr(test_parity, case)()


def test_sqrt_div_correctly_rounded_on_gpu(gpu_device):
    from cpupathtrace_tpu.utils import math as pmath

    inp = ru.ulp_inputs()
    rows = {
        "sqrt": ru.ulp_row(lambda x: pmath.sqrt(x), np.sqrt, [inp["x"]], gpu_device),
        "div": ru.ulp_row(lambda x, y: pmath.div(x, y), np.divide,
                          [inp["x"], inp["y"]], gpu_device),
    }
    assert all(r["not_rn"] == 0.0 for r in rows.values()), rows


def test_sphere_light_knife_edge_on_gpu(gpu_device):
    """Near-side sphere-light samples counted visible: the card within two
    points of the CPU backend and of the IEEE f32 emulation."""
    from tests.scenes_util import emissive_sphere_scene

    n = 400000
    pos = ru.floor_points(n)
    key = jax.random.PRNGKey(0)
    scene = emissive_sphere_scene()
    gpu = ru.share(*ru.near_side_visible(scene, pos, key, gpu_device))
    cpu = ru.share(*ru.near_side_visible(scene, pos, key, jax.devices("cpu")[0]))
    ieee = ru.share(*ru.near_side_visible_ieee(pos, *ru.light_sample_uniforms(n, key)))
    assert abs(gpu - ieee) <= 0.02 and abs(gpu - cpu) <= 0.02, (gpu, cpu, ieee)


def test_triangle_light_knife_edge_on_gpu(gpu_device):
    """Light samples on renderSceneBox's ceiling panel seen from the floor,
    where the panel is the only occluder: the share counted visible on the
    card within two points of the CPU backend."""
    from cpupathtrace_tpu.models.scenes import bench_box_scene

    pos = ru.floor_points(200000)
    key = jax.random.PRNGKey(0)
    scene = bench_box_scene()
    gpu = ru.share(*ru.light_visible(scene, pos, key, gpu_device)[1:])
    cpu = ru.share(*ru.light_visible(scene, pos, key, jax.devices("cpu")[0])[1:])
    assert abs(gpu - cpu) <= 0.02, (gpu, cpu)


def test_emissive_sphere_gpu_matches_cpu(gpu_device):
    """The emissive-sphere golden scene under the same random numbers on the
    card and on the CPU backend: central quantiles within 5%. Not closer:
    knife-edge samples that round the other way re-draw the NEE noise, and
    two CPU graphs of the same arithmetic already differ by up to 2%. The
    card with the backend's unrounded sqrt and division was 7-8% low."""
    imgs = {}
    for name, dev in (("gpu", gpu_device), ("cpu", jax.devices("cpu")[0])):
        with jax.default_device(dev):
            imgs[name] = test_parity.render_emissive_sphere()
    test_parity.assert_quantile_parity(imgs["gpu"], imgs["cpu"], rtol=0.05)
