"""Exporters (port of the JAX package's ``models/exporter.py``): the
``--export`` entry point.

``gaussian-mesh-exporter`` writes the canonical PLY of the alive rows, then
extracts a mesh from the Gaussians (density grid + surface nets), decimates
it past ``decimate_target`` faces and writes it as OBJ."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

from ..utils.config import parse_structured
from ..utils.registry import register
from .decimate import decimate_mesh
from .mesh_extract import extract_mesh_from_gaussians, save_obj


@dataclasses.dataclass
class MeshExporterConfig:
    save_name: str = "model"
    save_video: bool = False
    fmt: str = "obj"
    resolution: int = 128
    density_thresh: float = 0.8
    decimate_target: int = 100000  # the reference decimates to 1e5 faces


@register("gaussian-mesh-exporter")
class MeshExporter:
    Config = MeshExporterConfig

    def __init__(self, cfg=None, geometry=None, **kwargs):
        if cfg is None:
            cfg = MeshExporterConfig(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(MeshExporterConfig, cfg)
        self.cfg = cfg
        self.geometry = geometry

    def __call__(self, gauss_state, out_dir: str) -> Dict[str, Any]:
        os.makedirs(out_dir, exist_ok=True)
        outputs: Dict[str, Any] = {}
        ply_path = os.path.join(out_dir, f"{self.cfg.save_name}.ply")
        self.geometry.save_ply(gauss_state, ply_path)
        outputs["ply"] = ply_path

        verts, faces = extract_mesh_from_gaussians(
            gauss_state, resolution=self.cfg.resolution, density_thresh=self.cfg.density_thresh,
        )
        if verts is not None and len(verts) > 0:
            if self.cfg.decimate_target and len(faces) > self.cfg.decimate_target:
                verts, faces = decimate_mesh(verts, faces, self.cfg.decimate_target)
            obj_path = os.path.join(out_dir, f"{self.cfg.save_name}.obj")
            save_obj(obj_path, verts, faces)
            outputs["obj"] = obj_path
            outputs["n_verts"] = int(len(verts))
            outputs["n_faces"] = int(len(faces))
        return outputs
