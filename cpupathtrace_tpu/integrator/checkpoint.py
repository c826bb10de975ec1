"""Render checkpoint / resume.

The reference has no checkpointing — a render is one blocking `processJob`
call (SURVEY §5). For long device renders (and multi-host configs) the film
state here is explicitly savable: a render is a sequence of spp chunks
accumulating (pixel_sum, sample_count) under a deterministic per-chunk key
schedule, so a resumed render produces bit-identical results to an
uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..camera.camera import Camera
from ..core.config import RenderOptions
from ..integrator.film import pixel_camera_coords, render_chunk
from ..scene.scene import SceneData

_FORMAT_VERSION = 3


def render_fingerprint(scene, camera) -> str:
    """Digest of the scene + camera device arrays. Stored in checkpoint meta
    so a resume against different render inputs is rejected instead of being
    silently blended into the accumulation buffers."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for leaf in jax.tree_util.tree_leaves((scene, camera)):
        h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class FilmState:
    """Savable accumulation state of a fixed-spp render."""

    pixel_sum: np.ndarray  # [P, 4] float64 accumulation
    sample_count: np.ndarray  # [P] int64
    chunks_done: int
    spp: int
    spp_chunk: int
    seed: int
    width: int
    height: int
    fingerprint: str = ""

    def image(self) -> np.ndarray:
        """Current mean image [H, W, 4] (alpha = coverage)."""
        img = self.pixel_sum / np.maximum(self.sample_count, 1)[:, None]
        img[:, 3] = (self.sample_count > 0).astype(np.float64)
        return img.reshape(self.height, self.width, 4).astype(np.float32)


def save_checkpoint(path: str, state: FilmState) -> None:
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp if tmp.endswith(".npz") else tmp,
        pixel_sum=state.pixel_sum,
        sample_count=state.sample_count,
        meta=json.dumps(
            {
                "version": _FORMAT_VERSION,
                "chunks_done": state.chunks_done,
                "spp": state.spp,
                "spp_chunk": state.spp_chunk,
                "seed": state.seed,
                "width": state.width,
                "height": state.height,
                "fingerprint": state.fingerprint,
            }
        ),
    )
    # np.savez appends .npz when missing.
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)


def load_checkpoint(path: str) -> FilmState:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        return FilmState(
            pixel_sum=z["pixel_sum"],
            sample_count=z["sample_count"],
            chunks_done=meta["chunks_done"],
            spp=meta["spp"],
            spp_chunk=meta["spp_chunk"],
            seed=meta["seed"],
            width=meta["width"],
            height=meta["height"],
            fingerprint=meta.get("fingerprint", ""),
        )


def render_resumable(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    spp: int,
    seed: int = 0,
    spp_chunk: int = 64,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    progress_callback=None,
    mesh=None,
) -> FilmState:
    """Fixed-spp render with periodic checkpoints; resumes automatically from
    `checkpoint_path` when it exists. The chunk key schedule is
    `fold_in(PRNGKey(seed), chunk_index)`, so resumed and uninterrupted
    renders are bit-identical.

    With `mesh` (a (dp, sp) `jax.sharding.Mesh`), each chunk renders SPMD
    over the mesh via `parallel.render.render_chunk_sharded` — the multi-host
    render's resume story (SURVEY §5 checkpoint row). Resuming on the SAME
    mesh shape is bit-identical to an uninterrupted run; resuming on a
    different mesh shape (elastic restart after losing hosts) is still a
    correct unbiased render — the remaining chunks just draw from that mesh
    shape's RNG streams — and is allowed because each chunk's samples are
    self-contained."""
    w, h = options.image_width, options.image_height
    # Ceil-division chunking: the final chunk is smaller when spp is not a
    # multiple of spp_chunk, so exactly `spp` samples are rendered (the
    # fixed-spp contract; a truncating division would silently drop the
    # remainder). The smaller final chunk costs one extra jit specialization.
    spp_chunk = min(spp_chunk, spp)
    n_chunks = -(-spp // spp_chunk)
    # The fingerprint forces a full device->host transfer + hash of every
    # scene array (gigabytes for binned dragon-scale scenes) — only pay for
    # it when checkpointing is actually requested.
    fingerprint = (
        render_fingerprint(scene, camera) if checkpoint_path else ""
    )

    state = None
    if checkpoint_path and os.path.exists(checkpoint_path):
        state = load_checkpoint(checkpoint_path)
        if (
            state.width != w or state.height != h
            or state.spp != spp
            or state.spp_chunk != spp_chunk or state.seed != seed
        ):
            raise ValueError("checkpoint is for a different render config")
        if state.fingerprint and state.fingerprint != fingerprint:
            raise ValueError(
                "checkpoint was taken for a different scene/camera "
                f"(fingerprint {state.fingerprint} != {fingerprint})"
            )
    if state is None:
        state = FilmState(
            pixel_sum=np.zeros((w * h, 4), np.float64),
            sample_count=np.zeros(w * h, np.int64),
            chunks_done=0,
            spp=spp,
            spp_chunk=spp_chunk,
            seed=seed,
            width=w,
            height=h,
            fingerprint=fingerprint,
        )

    xg, yg = np.meshgrid(
        np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)
    )
    x_cam, y_cam = pixel_camera_coords(options, xg.ravel(), yg.ravel())
    n = x_cam.size
    pad = 0
    if mesh is not None:
        dp = mesh.shape["dp"]
        sp = mesh.shape["sp"]
        if spp_chunk % sp != 0:
            raise ValueError(
                f"spp_chunk {spp_chunk} not divisible by the mesh's "
                f"sample-parallel axis sp={sp}"
            )
        if spp % spp_chunk != 0 and (spp % spp_chunk) % sp != 0:
            raise ValueError(
                f"final chunk of {spp % spp_chunk} spp not divisible by sp={sp}"
            )
        pad = (-n) % dp
        if pad:
            x_cam = np.concatenate([x_cam, np.zeros(pad, np.float32)])
            y_cam = np.concatenate([y_cam, np.zeros(pad, np.float32)])
    x_cam = jnp.asarray(x_cam, jnp.float32)
    y_cam = jnp.asarray(y_cam, jnp.float32)

    base = jax.random.PRNGKey(seed)
    for c in range(state.chunks_done, n_chunks):
        key = jax.random.fold_in(base, c)
        chunk = min(spp_chunk, spp - c * spp_chunk)
        if mesh is not None:
            from ..parallel.render import render_chunk_sharded

            s, cnt = render_chunk_sharded(
                scene, camera, options, mesh, x_cam, y_cam, key, chunk
            )
            s = np.asarray(s)[:n]
            cnt = np.asarray(cnt)[:n]
        else:
            s, cnt = render_chunk(
                scene, camera, options, x_cam, y_cam, key, chunk
            )
        state.pixel_sum += np.asarray(s, np.float64)
        state.sample_count += np.asarray(cnt, np.int64)
        state.chunks_done = c + 1
        if checkpoint_path and (c + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, state)
        if progress_callback is not None:
            progress_callback(c + 1, n_chunks)

    if checkpoint_path:
        save_checkpoint(checkpoint_path, state)
    return state
