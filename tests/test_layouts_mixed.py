"""Every intersector layout vs dense intersection on mixed triangles and
spheres (tests/layouts_util.py)."""
import pytest

from tests.layouts_util import LAYOUTS, QUERIES, check_layout_query, mixed_scene


@pytest.fixture(scope="module", params=LAYOUTS)
def scene(request):
    s = mixed_scene(request.param)
    assert s.accel == request.param
    return s


@pytest.mark.parametrize("query", QUERIES)
def test_layout_matches_dense(scene, query):
    check_layout_query(scene, query)
