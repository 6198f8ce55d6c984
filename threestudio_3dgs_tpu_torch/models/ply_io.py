"""Canonical 3DGS PLY read/write (the port's own copy of the JAX package's
numpy-only ``models/ply_io.py``; the files it writes are byte-identical),
byte-compatible with the reference (reference geometry/gaussian_io.py:36-172),
on top of numpy (the format is a simple binary_little_endian table).

Attribute order: x y z nx ny nz f_dc_{0..2} f_rest_{0..3(K-1)-1} opacity
scale_{0..2} rot_{0..3}.  Feature columns are channel-major: the reference
stores features as (N, K, 3) and writes transpose(1, 2).flatten -> all R
coefficients, then G, then B (reference geometry/gaussian_io.py:53-67).
"""

from __future__ import annotations

import io
from typing import Dict, List, Tuple

import numpy as np


def _header(n: int, names: List[str]) -> bytes:
    lines = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {n}",
    ]
    lines += [f"property float {name}" for name in names]
    lines.append("end_header")
    return ("\n".join(lines) + "\n").encode("ascii")


def attribute_names(sh_degree: int) -> List[str]:
    """Mirror of the reference construct_list_of_attributes
    (geometry/gaussian_io.py:36-48)."""
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * ((sh_degree + 1) ** 2 - 1))]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_gaussian_ply(
    path: str,
    xyz: np.ndarray,  # (N, 3)
    features_dc: np.ndarray,  # (N, 1, 3)
    features_rest: np.ndarray,  # (N, K-1, 3)
    opacity: np.ndarray,  # (N, 1)
    scaling: np.ndarray,  # (N, 3)
    rotation: np.ndarray,  # (N, 4)
    extra: "Dict[str, np.ndarray] | None" = None,  # (N,) columns, in order
) -> None:
    """`extra` columns (e.g. the spacetime model's motion_i / omega_i /
    trbf_* / delta_*_t{i}) append as first-class float vertex properties
    after rot_*, matching the reference's temporal PLY layout
    (reference geometry/spacetime_gaussian.py:880-956)."""
    n = xyz.shape[0]
    k_rest = features_rest.shape[1]
    sh_degree = int(round((k_rest + 1) ** 0.5)) - 1
    names = attribute_names(sh_degree)

    f_dc = np.transpose(features_dc, (0, 2, 1)).reshape(n, -1)  # channel-major
    f_rest = np.transpose(features_rest, (0, 2, 1)).reshape(n, -1)
    cols = [
        xyz,
        np.zeros_like(xyz),  # normals, zero as in the reference
        f_dc,
        f_rest,
        opacity,
        scaling,
        rotation,
    ]
    if extra:
        names = names + list(extra.keys())
        cols += [np.asarray(c, np.float32).reshape(n, 1) for c in extra.values()]
    table = np.concatenate(cols, axis=1).astype("<f4")
    assert table.shape[1] == len(names), (table.shape, len(names))
    with open(path, "wb") as f:
        f.write(_header(n, names))
        f.write(table.tobytes())


def _parse_header(f) -> Tuple[int, List[Tuple[str, str]], str]:
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    n = None
    in_vertex = False
    props: List[Tuple[str, str]] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("truncated PLY header")
        parts = line.decode("ascii", "replace").strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            if parts[1] == "vertex":
                in_vertex = True
                n = int(parts[2])
            else:
                # a non-vertex element's properties must not leak into the
                # vertex dtype; and if it PRECEDES the vertex element its
                # binary payload would offset every vertex read
                if n is None:
                    raise ValueError(
                        f"unsupported PLY layout: element {parts[1]!r} "
                        "precedes the vertex element"
                    )
                in_vertex = False
        elif parts[0] == "property":
            if in_vertex:
                if parts[1] == "list":
                    raise ValueError(
                        "list properties on the vertex element are unsupported"
                    )
                props.append((parts[1], parts[2]))
            # properties of non-vertex elements are ignored for reading the
            # vertex table; binary payloads with extra elements still fail
            # below unless vertex comes first
        elif parts[0] == "end_header":
            break
    if fmt not in ("binary_little_endian", "ascii"):
        raise ValueError(f"unsupported PLY format {fmt}")
    return n, props, fmt


_PLY_DTYPES = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "short": "<i2",
    "ushort": "<u2",
    "int": "<i4",
    "int32": "<i4",
    "uint": "<u4",
}


def read_ply_table(path: str) -> Dict[str, np.ndarray]:
    """Read a single-element vertex PLY into a dict of float64 columns."""
    with open(path, "rb") as f:
        n, props, fmt = _parse_header(f)
        dtype = np.dtype([(name, _PLY_DTYPES[t]) for t, name in props])
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        else:
            rows = np.loadtxt(io.BytesIO(f.read()), max_rows=n, ndmin=2)
            data = np.rec.fromarrays(rows.T, dtype=dtype)
    return {name: np.asarray(data[name]) for _, name in props}


def load_gaussian_ply(path: str, sh_degree: int) -> Dict[str, np.ndarray]:
    """Load a 3DGS PLY into raw (pre-activation) parameter arrays, matching
    reference load_ply semantics (geometry/gaussian_io.py:85-172) -- including
    the sh_degree==0 quirk where f_rest becomes an empty (N, 0, 3) array."""
    cols = read_ply_table(path)
    n = cols["x"].shape[0]
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float32)
    opacity = cols["opacity"].astype(np.float32)[:, None]
    f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], axis=1).astype(np.float32)
    features_dc = f_dc[:, None, :]  # (N, 1, 3)

    if sh_degree > 0:
        k_rest = (sh_degree + 1) ** 2 - 1
        rest_names = sorted(
            (k for k in cols if k.startswith("f_rest_")),
            key=lambda s: int(s.split("_")[-1]),
        )
        assert len(rest_names) == 3 * k_rest, (len(rest_names), k_rest)
        rest = np.stack([cols[k] for k in rest_names], axis=1).astype(np.float32)
        # stored channel-major (3, K-1) -> (K-1, 3)
        features_rest = rest.reshape(n, 3, k_rest).transpose(0, 2, 1)
    else:
        features_rest = np.zeros((n, 0, 3), np.float32)

    scale_names = sorted(
        (k for k in cols if k.startswith("scale_")), key=lambda s: int(s.split("_")[-1])
    )
    scaling = np.stack([cols[k] for k in scale_names], axis=1).astype(np.float32)
    rot_names = sorted(
        (k for k in cols if k.startswith("rot_")), key=lambda s: int(s.split("_")[-1])
    )
    rotation = np.stack([cols[k] for k in rot_names], axis=1).astype(np.float32)
    return dict(
        xyz=xyz,
        features_dc=features_dc,
        features_rest=features_rest,
        opacity=opacity,
        scaling=scaling,
        rotation=rotation,
    )
