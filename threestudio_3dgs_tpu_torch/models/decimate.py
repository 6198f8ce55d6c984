"""Quadric edge-collapse mesh decimation on the host (the export's step past
``decimate_target`` faces).

``csrc/decimate.cpp`` is the JAX package's ``native/decimate.cpp``,
unchanged.  It is compiled at first use with ``g++ -O2 -shared -fPIC
-std=c++17`` into ``_build/<hash of source and flags>/`` and bound with
``ctypes``, as ``ops/native.py`` does for the CUDA sources.  A failed build
or a failed call raises: there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops.native import BUILD_ROOT, CSRC_DIR

SOURCE = CSRC_DIR / "decimate.cpp"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_ROOT / f"host-{digest.hexdigest()[:16]}" / "libdecimate.so"


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the decimator."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_name(f"libdecimate.{os.getpid()}.tmp.so")
                proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            lib.decimate_mesh.restype = ctypes.c_int
            lib.decimate_mesh.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                ctypes.POINTER(ctypes.c_int), ctypes.c_long,
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
            ]
            _lib = lib
        return _lib


def decimate_mesh(verts: np.ndarray, faces: np.ndarray,
                  target_faces: int) -> Tuple[np.ndarray, np.ndarray]:
    """Quadric edge-collapse simplification down to ~target_faces."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if len(faces) <= target_faces:
        return verts, faces
    out_v = np.empty_like(verts)
    out_f = np.empty_like(faces)
    nv = ctypes.c_long(0)
    nf = ctypes.c_long(0)
    ret = library().decimate_mesh(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(faces),
        int(target_faces),
        out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.byref(nv),
        out_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), ctypes.byref(nf),
    )
    if ret != 0 or nf.value <= 0:
        raise RuntimeError(f"decimate_mesh failed (return {ret}, {nf.value} faces left)")
    return out_v[: nv.value].copy(), out_f[: nf.value].copy()
