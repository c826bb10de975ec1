"""Scene table persistence: save/load built `SceneData` to a single
binary file, plus a keyed build cache.

The reference loads its scene from OBJ and rebuilds the BVH on every
process start (ref: src/scene/scene.cpp:153-181 runs in the `Scene`
ctor; at the 7.2M-triangle benchmark mesh that is ~72 s of load+build,
BASELINE.md). This module is the production-ingest answer: build once,
persist the packed SoA tables, and reload at disk speed.

Format: a tiny JSON header (static fields + array directory) followed
by raw 64-byte-aligned array blobs. NOT .npz on purpose: numpy's
zipfile path was measured at ~10 MB/s write / ~25 MB/s read on the
4 GiB dragon tables (7+ minutes per save); raw `readinto` runs at
disk speed (~seconds).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
from pathlib import Path
from typing import Callable

import jax.numpy as jnp
import numpy as np

from .scene import STATIC_FIELDS, SceneData

_MAGIC = b"PTXSCENE"
# Bump when the SceneData field set / packed-table layout changes in a
# way that invalidates cached files.
# v4: the kernel record tables (krn_*, trv_*, root bounds) and the lean
# flag are gone from SceneData.
_FORMAT_VERSION = 4
_ALIGN = 64


def _split_fields():
    arrays, meta = [], []
    for f in dataclasses.fields(SceneData):
        # Same split as scene.py's register_dataclass (STATIC_FIELDS is the
        # shared source of truth): static config fields are plain python
        # scalars/strings, everything else is an array leaf.
        if f.name in STATIC_FIELDS:
            meta.append(f.name)
        else:
            arrays.append(f.name)
    return tuple(arrays), tuple(meta)


_ARRAYS, _META = _split_fields()


def save_scene(scene: SceneData, path: str | os.PathLike) -> None:
    """Persist a built scene's tables to `path` (raw binary, atomic)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    hosts = {n: np.ascontiguousarray(getattr(scene, n)) for n in _ARRAYS}
    meta = {n: getattr(scene, n) for n in _META}
    meta["__format__"] = _FORMAT_VERSION
    entries = [
        {"name": n, "dtype": a.dtype.str, "shape": list(a.shape)}
        for n, a in hosts.items()
    ]
    header = {"meta": meta, "arrays": entries}
    # The header length feeds back into the first blob offset: budget the
    # offset fields generously, then pad the header (JSON tolerates
    # trailing whitespace) to the budgeted size so offsets stay valid.
    budget = len(json.dumps(header).encode()) + 32 * len(entries) + 64
    off = (len(_MAGIC) + 8 + budget + _ALIGN - 1) // _ALIGN * _ALIGN
    hlen = off - len(_MAGIC) - 8
    for e in entries:
        e["offset"] = off
        off += hosts[e["name"]].nbytes
        off = (off + _ALIGN - 1) // _ALIGN * _ALIGN
    blob = json.dumps(header).encode()
    if len(blob) > hlen:
        # Must stay a hard error even under `python -O`: overflowing the
        # budgeted header would overlap the first array blob's offset and
        # write a silently corrupt cache file.
        raise RuntimeError(
            f"scene cache header budget exceeded ({len(blob)} > {hlen})"
        )
    blob = blob + b" " * (hlen - len(blob))
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for e in entries:
            f.seek(e["offset"])
            f.write(memoryview(hosts[e["name"]]).cast("B"))
    os.replace(tmp, path)  # atomic vs concurrent readers


def load_scene(path: str | os.PathLike) -> SceneData:
    """Reload a scene saved by `save_scene`; arrays land on the default
    device. Raises ValueError on a format-version/magic mismatch.

    The disk read runs on a prefetch thread one array ahead of the
    device upload, so the two overlap instead of adding up."""
    import queue
    import threading

    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a scene cache file")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode())
        meta = dict(header["meta"])
        if meta.pop("__format__", None) != _FORMAT_VERSION:
            raise ValueError(
                f"{path}: stale scene-cache format "
                f"(want {_FORMAT_VERSION}); rebuild"
            )

        # Chunk granularity: one table can dominate the file, so overlap
        # must happen WITHIN arrays — the reader emits
        # <=256 MB leading-axis slices and the consumer uploads each while
        # the next is being read, reassembling multi-chunk arrays with a
        # device-side concatenate.
        chunk_bytes = 256 << 20
        q: queue.Queue = queue.Queue(maxsize=2)

        def reader():
            try:
                for e in header["arrays"]:
                    shape = tuple(e["shape"])
                    dt = np.dtype(e["dtype"])
                    row_bytes = int(
                        np.prod(shape[1:], dtype=np.int64)
                    ) * dt.itemsize if shape else dt.itemsize
                    n_rows = shape[0] if shape else 1
                    rows_per = max(
                        1, min(n_rows, chunk_bytes // max(row_bytes, 1))
                    )
                    n_parts = max(1, -(-n_rows // rows_per))
                    off = e["offset"]
                    for pi in range(n_parts):
                        r0 = pi * rows_per
                        r1 = min(n_rows, r0 + rows_per)
                        part = np.empty((r1 - r0,) + shape[1:], dtype=dt)
                        f.seek(off + r0 * row_bytes)
                        n = f.readinto(memoryview(part).cast("B"))
                        if n != part.nbytes:
                            raise ValueError(
                                f"{path}: truncated ({e['name']})"
                            )
                        q.put((e["name"], pi, n_parts, shape, part))
                q.put(None)
            except Exception as exc:  # surfaced on the consumer side
                q.put(exc)

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        kwargs = {}
        parts: list = []
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            name, pi, n_parts, shape, part = item
            d = jnp.asarray(part) if shape else jnp.asarray(
                part.reshape(())
            )
            if n_parts == 1:
                kwargs[name] = d if shape else d.reshape(shape)
            else:
                parts.append(d)
                if pi == n_parts - 1:
                    kwargs[name] = jnp.concatenate(parts, axis=0)
                    parts = []
        th.join()
    kwargs.update(meta)
    return SceneData(**kwargs)


def build_cache_key(*parts) -> str:
    """Hash arbitrary printable parts (mesh path + mtime, tri counts,
    accel options...) and the format version into a hex cache key."""
    h = hashlib.sha256()
    h.update(f"v{_FORMAT_VERSION}".encode())
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()[:24]


def cached_build(
    key: str,
    build_fn: Callable[[], SceneData],
    cache_dir: str | os.PathLike,
) -> tuple[SceneData, bool]:
    """Return (scene, was_cache_hit). On a miss, runs `build_fn`, saves
    the result under `cache_dir/<key>.ptxs`, and returns it. A corrupt
    or stale-format file is treated as a miss and overwritten.

    The miss-path build runs pinned to the CPU backend so `save_scene`
    reads host memory directly — building straight onto an accelerator
    would round-trip the tables device->host just to write the cache
    file. The built scene is then device_put once."""
    import jax

    path = Path(cache_dir) / f"{key}.ptxs"
    if path.exists():
        try:
            return load_scene(path), True
        except Exception:  # corrupt/stale -> rebuild
            pass
    with jax.default_device(jax.devices("cpu")[0]):
        scene = build_fn()
    save_scene(scene, path)
    return jax.device_put(scene, jax.devices()[0]), False
