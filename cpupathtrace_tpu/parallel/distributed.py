"""Multi-host (multi-slice) runtime initialization.

The reference is strictly single-process (SURVEY §2: pthreads + two mutexes
are its entire "collective layer"). This framework scales across
hosts with `jax.distributed`: every host runs the same SPMD program, the
global `(dp, sp)` mesh spans all hosts' devices, and the host-local image
shards are gathered once per render.

Single-host (and the CI virtual-CPU mesh) skip initialization transparently.
"""
from __future__ import annotations

import jax
import numpy as np


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize the multi-host runtime with the given coordinator and
    process layout; no-op when already initialized or when running
    single-process."""
    if num_processes in (None, 1) and coordinator_address is None:
        try:
            if jax.process_count() > 1:
                return  # already initialized by the launcher
        except RuntimeError:
            pass
        if coordinator_address is None and num_processes is None:
            return  # single process, nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_render_mesh(sample_axis: int | None = None):
    """A (dp, sp) mesh over every device of every host."""
    from .mesh import make_render_mesh

    return make_render_mesh(jax.devices(), sample_axis=sample_axis)


def host_local_rows(height: int) -> tuple[int, int]:
    """The contiguous row range this host renders when the pixel axis is
    sharded across processes (the multi-host tile assignment)."""
    p = jax.process_count()
    i = jax.process_index()
    rows = -(-height // p)
    lo = min(i * rows, height)
    return lo, min(lo + rows, height)


def gather_image(local_rows: np.ndarray, height: int) -> np.ndarray:
    """Gather per-host row blocks into the full image on every host via a
    device all-gather.

    process_allgather requires identical shapes on every process, but
    host_local_rows gives the last host fewer rows when height % p != 0 —
    every host therefore pads its block to the common ceil(height/p) row
    count before the gather and the result is trimmed back to `height`."""
    import jax.numpy as jnp

    p = jax.process_count()
    if p == 1:
        return local_rows
    from jax.experimental import multihost_utils

    rows = -(-height // p)
    if local_rows.shape[0] < rows:
        pad = np.zeros((rows - local_rows.shape[0],) + local_rows.shape[1:],
                       local_rows.dtype)
        local_rows = np.concatenate([local_rows, pad], axis=0)
    return np.asarray(
        multihost_utils.process_allgather(jnp.asarray(local_rows))
    ).reshape(-1, *local_rows.shape[1:])[:height]
