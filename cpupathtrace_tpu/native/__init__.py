"""Native (C++) runtime components, loaded via ctypes.

Build-on-first-import: compiles src/ptx_native.cpp with g++ -O3 into a
shared library cached next to this file. Every entry point has a pure-Python
fallback (accel/build.py, scene/mesh.py), so the package works without a
compiler; the native path makes multi-million-triangle scene builds
practical (the role C++ plays in the reference's runtime).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "ptx_native.cpp")
_LIB_PATH = os.path.join(_HERE, "_ptx_native.so")

_lock = threading.Lock()
_lib = None
_load_failed = False


def _build() -> bool:
    # Compile to a unique temp file and atomically move it into place so
    # concurrent processes (pytest-xdist, parallel benchmarks) never dlopen a
    # partially written library or clobber each other mid-compile.
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    # -ffp-contract=off: no FMA contraction, so float results match the
    # numpy reference paths BITWISE (the pack/build outputs are compared
    # bit-exactly against the Python implementations in tests).
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", "-ffp-contract=off", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get_lib():
    """Return the loaded native library, building it on first use; None if
    unavailable (callers fall back to Python)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(_LIB_PATH) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)
        ):
            if not _build():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _load_failed = True
            return None

        lib.ptx_build_bvh.restype = ctypes.c_int
        lib.ptx_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ptx_mesh_pipeline.restype = ctypes.c_int64
        lib.ptx_mesh_pipeline.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int,
        ] + [ctypes.POINTER(ctypes.c_double)] * 6
        lib.ptx_count_obj.restype = None
        lib.ptx_count_obj.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ptx_parse_obj.restype = None
        lib.ptx_parse_obj.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_bvh_native(prim_lo: np.ndarray, prim_hi: np.ndarray,
                     want_subtree_info: bool = False):
    """Native flat-BVH build; returns (lo, hi, left, right, prim, depth) or
    None when the native library is unavailable. With
    `want_subtree_info`, additionally (node_begin, node_size, dfs_prims):
    per-node first-leaf DFS rank + subtree primitive count and the
    primitive ids in DFS leaf order — the cluster cut (accel/cluster.py)
    consumes these instead of sweeping the tree level by level."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(prim_lo.shape[0])
    prim_lo = np.ascontiguousarray(prim_lo, np.float32)
    prim_hi = np.ascontiguousarray(prim_hi, np.float32)
    cap = max(2 * n - 1, 1)
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    prim = np.empty(cap, np.int32)
    null = ctypes.POINTER(ctypes.c_int32)()
    if want_subtree_info:
        begin = np.empty(cap, np.int32)
        size = np.empty(cap, np.int32)
        dfs = np.empty(max(n, 1), np.int32)
        extra = (_iptr(begin), _iptr(size), _iptr(dfs))
    else:
        extra = (null, null, null)
    depth = ctypes.c_int32(0)
    count = lib.ptx_build_bvh(
        _fptr(prim_lo), _fptr(prim_hi), n,
        _fptr(lo), _fptr(hi), _iptr(left), _iptr(right), _iptr(prim),
        ctypes.byref(depth), *extra,
    )
    base = (
        lo[:count], hi[:count], left[:count], right[:count], prim[:count],
        int(depth.value),
    )
    if want_subtree_info:
        return base + (begin[:count], size[:count], dfs[:n])
    return base


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def mesh_pipeline_native(verts: np.ndarray, faces: np.ndarray,
                         smooth: bool):
    """Threaded native face validation + smooth-normal pass (bit-identical
    to scene/mesh.py mesh_from_arrays' numpy pipeline). Returns
    (a, b, c, na, nb, nc) kept-face arrays or None when the native library
    is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    verts = np.ascontiguousarray(verts, np.float64)
    faces = np.ascontiguousarray(faces, np.int64)
    n_f = faces.shape[0]
    outs = [np.empty((n_f, 3), np.float64) for _ in range(6)]
    n_k = lib.ptx_mesh_pipeline(
        _dptr(verts), ctypes.c_int64(verts.shape[0]),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n_f), ctypes.c_int(1 if smooth else 0),
        *[_dptr(o) for o in outs],
    )
    return tuple(np.ascontiguousarray(o[:n_k]) for o in outs)


def parse_obj_native(text: bytes):
    """Native OBJ v/f parse; returns (verts [V,3] f32, faces [F,3] i64) or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if isinstance(text, str):
        text = text.encode("utf-8", errors="replace")
    n = len(text)
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    lib.ptx_count_obj(text, n, ctypes.byref(nv), ctypes.byref(nf))
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int64)
    lib.ptx_parse_obj(
        text, n, _fptr(verts), nv.value,
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nf.value,
    )
    return verts, faces
