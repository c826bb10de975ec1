"""Failure detection + elastic recovery for long multi-device renders.

The reference has no failure story at all (SURVEY §5: errors surface as
I/O exceptions; the renderer is noexcept). For multi-device renders the
framework's answer is built from two pieces that exist independently:

  * DETECTION — `ping_mesh`: a tiny psum over the render mesh executed on
    a watchdog thread with a deadline. A healthy mesh answers in
    milliseconds; a wedged interconnect/device either raises or blows the
    deadline. Run it before a render and between checkpoint chunks.
  * RECOVERY — `render_resumable_elastic`: drives the checkpointed
    sharded render (integrator/checkpoint.py) and, when a chunk fails or
    the mesh stops answering pings, falls back to the next mesh in a
    degradation list (e.g. all chips -> surviving chips -> single
    device), RESUMING from the last checkpoint. Checkpoints are
    host-side, mesh-shape-independent film sums, so nothing is lost but
    the interrupted chunk; within one mesh a resume is bit-identical,
    and across mesh shapes the remaining chunks draw from the new mesh's
    RNG streams (still the same unbiased estimator — see
    render_resumable's docstring).

In a real multi-host deployment the process on a dead host disappears
entirely; recovery is then "restart the job with the surviving hosts'
mesh and the same checkpoint path", which is exactly the
`render_resumable_elastic` loop with process restart in place of the
in-process retry.
"""
from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def ping_mesh(mesh: Mesh, timeout_s: float = 30.0) -> tuple[bool, float]:
    """Health-check a mesh with a tiny all-device psum under a deadline.

    Returns (ok, seconds). `ok` is False when the collective raised OR
    did not complete within `timeout_s` (a wedged device/interconnect
    typically hangs rather than raising — the watchdog thread makes that
    a detectable condition instead of a silent stall)."""
    result: dict = {}

    def _ping():
        try:
            axes = tuple(mesh.axis_names)

            def body(x):
                for ax in axes:
                    x = jax.lax.psum(x, ax)
                return x

            ones = jnp.ones((mesh.size,), jnp.float32)
            out = jax.jit(
                jax.shard_map(
                    body, mesh=mesh,
                    in_specs=P(axes[0]), out_specs=P(axes[0]),
                    check_vma=False,
                )
            )(ones)
            # Force a host transfer: completion, not just dispatch.
            result["sum"] = float(np.asarray(out)[0])
            result["ok"] = True
        except Exception as e:  # noqa: BLE001 — any failure = unhealthy
            result["error"] = repr(e)
            result["ok"] = False

    t0 = time.time()
    th = threading.Thread(target=_ping, daemon=True)
    th.start()
    th.join(timeout_s)
    dt = time.time() - t0
    if th.is_alive() or not result.get("ok"):
        return False, dt
    return True, dt


def render_resumable_elastic(
    scene,
    camera,
    options,
    spp: int,
    checkpoint_path: str,
    meshes: list[Mesh],
    seed: int = 0,
    spp_chunk: int = 64,
    checkpoint_every: int = 1,
    progress_callback=None,
    ping_timeout_s: float = 30.0,
    on_failover=None,
):
    """Checkpointed sharded render with mesh-degradation failover.

    Tries `meshes` in order: pings each, then drives
    `render_resumable(..., mesh=m)` from the shared checkpoint. A chunk
    failure (device loss, collective error) advances to the next mesh and
    RESUMES — completed chunks are never re-rendered. Raises the last
    error when every mesh is exhausted. `on_failover(mesh_index, error)`
    is called before each fallback (logging/alerting hook)."""
    from ..integrator.checkpoint import render_resumable

    last_err: Exception | None = None
    for mi, mesh in enumerate(meshes):
        ok, dt = ping_mesh(mesh, timeout_s=ping_timeout_s)
        if not ok:
            last_err = RuntimeError(
                f"mesh {mi} failed health ping ({dt:.1f}s)"
            )
            if on_failover is not None:
                on_failover(mi, last_err)
            continue
        try:
            return render_resumable(
                scene, camera, options, spp=spp, seed=seed,
                spp_chunk=spp_chunk, checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every,
                progress_callback=progress_callback, mesh=mesh,
            )
        except Exception as e:  # noqa: BLE001 — fail over, resume
            last_err = e
            if on_failover is not None:
                on_failover(mi, e)
    raise RuntimeError(
        f"all {len(meshes)} meshes exhausted; last error: {last_err!r}"
    ) from last_err
