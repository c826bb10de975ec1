"""Every intersector layout vs dense intersection on the dragon stand-in in
the closed box (tests/layouts_util.py)."""
import pytest

from cpupathtrace_tpu.models.scenes import bench_dragon_scene
from tests.layouts_util import LAYOUTS, QUERIES, check_layout_query


@pytest.fixture(scope="module", params=LAYOUTS)
def scene(request):
    s = bench_dragon_scene(dragon_tris=2500, accel=request.param)
    assert s.accel == request.param
    return s


@pytest.mark.parametrize("query", QUERIES)
def test_layout_matches_dense(scene, query):
    check_layout_query(scene, query)
