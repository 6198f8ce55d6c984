"""Heat-method geodesic distances on a triangle mesh, on the host (dynamic
SuGaR's ``dg_dist_mode: geodesic`` skinning weights).

``csrc/heat_geodesic.cpp`` is the JAX package's ``native/heat_geodesic.cpp``,
unchanged: a CSR cotangent Laplacian, the heat step and the Poisson solve
by Jacobi-preconditioned conjugate gradients.  It is compiled at first use
with ``g++ -O2 -shared -fPIC -std=c++17`` into ``_build/<hash of source and
flags>/`` and bound with ``ctypes``, as ``models/decimate.py`` builds the
decimator.  A failed build or a failed call raises: there is no scipy
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.native import BUILD_ROOT, CSRC_DIR

SOURCE = CSRC_DIR / "heat_geodesic.cpp"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_ROOT / f"host-{digest.hexdigest()[:16]}" / "libheat_geodesic.so"


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the solver."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_name(f"libheat_geodesic.{os.getpid()}.tmp.so")
                proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            lib.heat_geodesic.restype = ctypes.c_int
            lib.heat_geodesic.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                ctypes.POINTER(ctypes.c_int), ctypes.c_long,
                ctypes.POINTER(ctypes.c_int), ctypes.c_long,
                ctypes.POINTER(ctypes.c_float),
            ]
            _lib = lib
        return _lib


def heat_geodesic_distances(verts: np.ndarray, faces: np.ndarray,
                            sources: np.ndarray) -> np.ndarray:
    """(S, V) f32: the geodesic distance from each source vertex to every
    vertex."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    sources = np.ascontiguousarray(sources, np.int32)
    if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError("heat_geodesic_distances: a face indexes past the vertices")
    if sources.size and (sources.min() < 0 or sources.max() >= len(verts)):
        raise ValueError("heat_geodesic_distances: a source indexes past the vertices")
    out = np.empty((len(sources), len(verts)), np.float32)
    ret = library().heat_geodesic(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(faces),
        sources.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(sources),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if ret != 0:
        raise RuntimeError(f"heat_geodesic failed (return {ret}) on {len(verts)} vertices, "
                           f"{len(faces)} faces, {len(sources)} sources")
    return out
