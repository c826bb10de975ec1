"""Test configuration: force the 8-virtual-device CPU backend.

Tests model a multi-device mesh on a CPU host
(`--xla_force_host_platform_device_count=8`), per the reference test
strategy of deterministic single-process tests (ref: test/main.cpp) extended
with SPMD sharding checks the reference has no analog for.
"""
import os

os.environ.setdefault(
    "XLA_FLAGS",
    "--xla_force_host_platform_device_count=8",
)
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax

# Pin the CPU backend post-import, so a machine with an accelerator runs
# the suite on its CPU too. PTX_KEEP_PLATFORM=1 leaves JAX's default
# platform in place: `chip_smoke.py` sets it to run the `gpu`-marked tests
# in its own process on the card.
if os.environ.get("PTX_KEEP_PLATFORM") != "1":
    jax.config.update("jax_platforms", "cpu")

# NO persistent XLA compile cache for the suite: reading back a cached
# executable has segfaulted inside jaxlib's compilation_cache deserializer
# (reproducibly, on a freshly written entry), and the repeat-run saving is
# not worth a flaky SIGSEGV.

import pytest  # noqa: E402


def _n_memory_maps() -> int:
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:  # non-Linux
        return 0


@pytest.fixture(autouse=True)
def _bound_jit_memory_maps():
    """Keep the process under the kernel's vm.max_map_count (65530 here).

    Every JIT-compiled XLA:CPU executable adds memory mappings; a full
    suite run accumulates >60k maps, after which mmap fails inside the
    LLVM JIT and the process dies with SIGSEGV/SIGABRT mid-compile (the
    crash site wanders — observed in compilation-cache reads, in
    backend_compile, in unrelated tests; root-caused by watching
    /proc/self/maps grow past ~52k at the 2/3 mark of the suite).
    Dropping JAX's executable caches unmaps dead programs; only fire when
    actually close to the limit so cross-module compile reuse survives."""
    yield
    if _n_memory_maps() > 45_000:
        jax.clear_caches()


@pytest.fixture(scope="session")
def cpu_devices():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual CPU devices, got {devs}"
    return devs
