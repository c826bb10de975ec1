"""One path on every backend: the package carries no TPU kernels, no
interpret-mode switches and no branch on the platform; the entry scripts'
compile cache follows JAX_COMPILATION_CACHE_DIR or a fixed in-checkout
directory."""
import pathlib
import re

import pytest

from cpupathtrace_tpu.utils import runtime

PACKAGE = pathlib.Path(__file__).resolve().parents[1] / "cpupathtrace_tpu"
SOURCES = sorted(PACKAGE.rglob("*.py"))


@pytest.mark.parametrize(
    "pattern",
    [
        r"pallas\.tpu|pallas import tpu|pltpu",
        r"\binterpret\s*=",
        r"\.platform\b|default_backend\(|device_kind",
    ],
)
def test_package_has_no_backend_specific_code(pattern):
    hits = [
        f"{p.relative_to(PACKAGE)}:{i}"
        for p in SOURCES
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if re.search(pattern, line)
    ]
    assert not hits, hits


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(runtime.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.configure_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(runtime.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    expect = str(PACKAGE.parent / ".jax_cache")
    assert runtime.configure_compile_cache() == expect
    assert calls == [("jax_compilation_cache_dir", expect)]


def test_bench_refuses_cpu(capsys):
    import bench

    assert bench.main(["--workloads", "box"]) != 0
    assert capsys.readouterr().out == ""
