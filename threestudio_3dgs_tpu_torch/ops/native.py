"""Build, load and count the port's hand-written CUDA kernels.

The kernels live as plain-C-interface CUDA sources in ``csrc/`` and are
compiled with ``nvcc`` for ``sm_90a`` into shared libraries that ``ctypes``
loads (no PyTorch headers, so a build takes seconds).  Nothing is built at
import: the first CUDA launch calls :func:`library`, which compiles every
source at once (one ``nvcc`` process per source, started together) into
``_build/<hash of sources and flags>/``.  Each C entry point returns
``cudaGetLastError()``; :func:`launch` raises if it is not zero and counts
the launch in :data:`LAUNCHES`, the per-kernel counter that shows a run
went through the kernel (and in :data:`SHAPE_LAUNCHES` per shape, where the
wrapper names the shape).  A failed build or launch raises
:class:`KernelError`, which the trainer never retries.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple, Union

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
# library name -> (source, extra flags)
LIBRARIES = {
    "blend": ("blend.cu", []),
    "segsum": ("segsum.cu", []),
    # exact float reachability test: no fused multiply-add contraction
    "expand": ("expand.cu", ["-fmad=false"]),
    "flash_attention": ("flash_attention.cu", []),
    # the plain version's float rounding, op by op: no fused multiply-add
    "project": ("project.cu", ["-fmad=false"]),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# K7's (csrc/project.cu) argument structs, passed by value
_PROJECT_ROWS = ("means3d", "scales", "quats", "opac", "alive", "offset")


class ProjectInputs(ctypes.Structure):
    # pointers, then each one's stride between views in elements
    _fields_ = [(name, _P) for name in _PROJECT_ROWS] + [(name + "_vs", _LL) for name in _PROJECT_ROWS]


class ProjectOutputs(ctypes.Structure):
    _fields_ = [(name, _P) for name in ("means2d", "depths", "conics", "radii", "tiles_min",
                                        "tiles_max", "visible", "rect", "counts", "sort_key",
                                        "cull")]


class ProjectGrads(ctypes.Structure):
    _fields_ = [(name, _P) for name in ("d_means2d", "d_conics", "d_depths", "means3d",
                                        "scales", "quats", "offset")]


class ProjectShape(ctypes.Structure):
    _fields_ = [("n", _LL)] + [(name, _I) for name in (
        "width", "height", "tile_size", "grid_x", "grid_y", "view_grid_y")] + [
        ("modifier", _F)]


SIGNATURES = {
    "blend_forward": ("blend", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "blend_backward": ("blend", [_P] * 9 + [_LL, _I, _I, _I, _I, _I, _P]),
    "segsum_monotone": ("segsum", [_P, _P, _P, _P, _LL, _I, _LL, _P]),
    "expand_bin": ("expand", [_P] * 8 + [_LL, _LL, _I, _I, _I, _I, _P]),
    "expand_slots": ("expand", [_P, _P, _LL, _LL, _P]),
    "flash_attention_forward": ("flash_attention", [_P] * 5 + [_I, _I, _I, _F, _I, _P]),
    "project_fwd": ("project", [ProjectInputs, _P, ProjectShape, _I, ProjectOutputs, _P]),
    "project_bwd": ("project", [ProjectInputs, _P, ProjectShape, _I, ProjectGrads, _P]),
}

# launches per kernel entry point; reset with reset_launches()
LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}
# launches per (entry point, shape tag), for the launches a wrapper tags
SHAPE_LAUNCHES: Dict[Tuple[str, str], int] = {}

_CUDA_ERRORS = {
    1: "cudaErrorInvalidValue",
    2: "cudaErrorMemoryAllocation",
    9: "cudaErrorInvalidConfiguration",
    98: "cudaErrorInvalidDeviceFunction",
    209: "cudaErrorNoKernelImageForDevice",
    700: "cudaErrorIllegalAddress",
    701: "cudaErrorLaunchOutOfResources",
    801: "cudaErrorNotSupported",
}



class KernelError(RuntimeError):
    """A hand kernel failed to build, load or launch: a fault of the code,
    never of the moment, so nothing retries it."""


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_build_log: List[str] = []


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SHAPE_LAUNCHES.clear()


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_dir() -> Path:
    digest = hashlib.sha256()
    for name, (src, extra) in sorted(LIBRARIES.items()):
        digest.update(name.encode())
        digest.update((CSRC_DIR / src).read_bytes())
        digest.update(" ".join(NVCC_FLAGS + extra).encode())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every library that is not built yet, all nvcc runs in
    parallel.  Returns library name -> .so path; raises on a failed build."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in LIBRARIES}
    procs = {}
    for name, (src, extra) in LIBRARIES.items():
        if paths[name].exists():
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC_DIR / src)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        _build_log.append(f"--- nvcc {LIBRARIES[name][0]} (rc {proc.returncode})\n{log}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise KernelError(
            f"nvcc failed for {failed}:\n" + "\n".join(_build_log[-len(procs):])
        )
    return paths


def build_log() -> str:
    """nvcc / ptxas output of the builds this process ran (registers,
    shared memory and spills per kernel)."""
    return "\n".join(_build_log)


def library(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            paths = build()
            for lib_name, path in paths.items():
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError as e:
                    raise KernelError(f"loading {path}: {e}") from e
                for fn, (owner, argtypes) in SIGNATURES.items():
                    if owner == lib_name:
                        func = getattr(lib, fn)
                        func.argtypes = argtypes
                        func.restype = ctypes.c_int
                _libs[lib_name] = lib
        return _libs[name]


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(fn: str, *args, shape: Union[str, Tuple[str, ...]] = "") -> None:
    """Call one C entry point, raise on a CUDA error, count the launch (and,
    when ``shape`` is given, the launch at that shape tag or at each of a
    tuple of tags)."""
    owner, _ = SIGNATURES[fn]
    err = getattr(library(owner), fn)(*args)
    if err != 0:
        raise KernelError(f"{fn}: CUDA error {err} ({_CUDA_ERRORS.get(err, 'see cuda_runtime_api.h')})")
    LAUNCHES[fn] += 1
    for tag in (shape,) if isinstance(shape, str) else shape:
        if tag:
            SHAPE_LAUNCHES[(fn, tag)] = SHAPE_LAUNCHES.get((fn, tag), 0) + 1


def check_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
