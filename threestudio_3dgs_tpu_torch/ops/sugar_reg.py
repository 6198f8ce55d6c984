"""SuGaR's density and SDF regularisers (port of the JAX package's
``ops/sugar_reg.py``).

  * points are sampled inside the Gaussians in proportion to their volume;
  * the density at a sample sums the opacity-weighted anisotropic Gaussian
    falloffs of the K tracked neighbours of its source Gaussian;
  * the SDF at a sample is its camera depth minus the rendered depth at its
    pixel; the density target is exp(-sdf^2 / (2 beta^2)), beta the mean
    smallest scale of the live Gaussians, and the loss the masked L1
    between density and target;
  * the better-normal loss aligns the density gradient at each sample
    (autograd, with the graph kept so the loss trains through it) with its
    source Gaussian's smallest axis, or the PCA normal of the centre cloud
    (``ops/mesh.py``).

The samples come from a ``torch.Generator``; the test-only ``draws`` dict
({"gumbel": (S, N) Gumbel noise whose argmax over logits + noise picks the
source, as the JAX package's categorical does, "normal": (S, 3) standard
normals}) replaces them."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from . import quaternion
from .image import normalize_vec
from .mesh import estimate_pointcloud_normals


@dataclasses.dataclass
class SuGaRRegConfig:
    reset_neighbors_every: int = 50
    n_samples_for_sdf_regularization: int = 50000
    start_regularization_from: int = 0
    start_sdf_better_normal_from: int = 500
    use_sdf_better_normal_loss: bool = True
    prune_hard_opacity_threshold: float = 0.5
    prune_low_opacity_gaussians_at: Optional[int] = None
    knn_to_track: int = 16


def sample_points_in_gaussians(generator: Optional[torch.Generator], means: torch.Tensor,
                               scales: torch.Tensor, quats: torch.Tensor, alive: torch.Tensor,
                               n_samples: int, draws: Optional[Dict[str, Any]] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Volume-proportional samples: (points (S, 3), source index (S,))."""
    log_vol = torch.sum(torch.log(torch.clamp_min(scales, 1e-12)), dim=-1)
    logits = torch.where(alive, log_vol, -torch.inf).detach()
    if draws:
        gumbel = torch.as_tensor(draws["gumbel"], dtype=torch.float32).to(means.device)
        idx = torch.argmax(gumbel + logits, dim=-1)
        eps = torch.as_tensor(draws["normal"], dtype=torch.float32).to(means.device)
    else:
        probs = torch.softmax(logits, dim=0)
        idx = torch.multinomial(probs.to(generator.device), n_samples, replacement=True,
                                generator=generator).to(means.device)
        eps = torch.randn((n_samples, 3), generator=generator,
                          device=generator.device).to(means.device)
    eps = eps * scales[idx]
    rot = quaternion.to_rotation_matrix(quats[idx])
    return means[idx] + torch.einsum("nij,nj->ni", rot, eps), idx


def density_at_points(points: torch.Tensor, source_idx: torch.Tensor, knn_idx: torch.Tensor,
                      means: torch.Tensor, scales: torch.Tensor, quats: torch.Tensor,
                      opacities: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """sum over the source's neighbours j of alpha_j exp(-d^T Sigma_j^-1 d / 2)."""
    nbrs = knn_idx[source_idx].long()  # (S, K)
    d = points[:, None, :] - means[nbrs]
    rot = quaternion.to_rotation_matrix(quats[nbrs])
    local = torch.einsum("skij,ski->skj", rot, d)  # R^T d
    inv_var = 1.0 / torch.clamp_min(scales[nbrs] ** 2, 1e-12)
    q = torch.sum(local * local * inv_var, dim=-1)
    w = opacities[nbrs] * alive[nbrs].to(points.dtype)
    return torch.sum(w * torch.exp(-0.5 * q), dim=-1)


def estimate_beta(scales: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """The mean smallest scale over the live Gaussians."""
    alive_f = alive.to(scales.dtype)
    return torch.sum(torch.amin(scales, dim=-1) * alive_f) / torch.clamp_min(torch.sum(alive_f),
                                                                             1.0)


def project_to_depth(points: torch.Tensor, camera, depth_map: torch.Tensor):
    """(sample depth (S,), rendered depth at its pixel (S,), valid (S,))."""
    height, width = depth_map.shape
    z = (points @ camera.w2c[:3, :3].T + camera.w2c[:3, 3])[:, 2]
    p_hom = points @ camera.full_proj[:3, :3].T + camera.full_proj[:3, 3]
    w_hom = points @ camera.full_proj[3, :3] + camera.full_proj[3, 3]
    ndc = p_hom[:, :2] / torch.clamp_min(w_hom[:, None], 1e-6)
    px = ((ndc[:, 0] + 1.0) * width - 1.0) * 0.5
    py = ((ndc[:, 1] + 1.0) * height - 1.0) * 0.5
    xi = torch.clamp(torch.round(px).to(torch.int32), 0, width - 1).long()
    yi = torch.clamp(torch.round(py).to(torch.int32), 0, height - 1).long()
    surf = depth_map[yi, xi]
    valid = ((z > 0.2) & (px >= 0) & (px <= width - 1) & (py >= 0) & (py <= height - 1)
             & (surf > 0.0))
    return z, surf, valid


def density_regulation_loss(generator, gaussians: Dict[str, torch.Tensor], knn_idx: torch.Tensor,
                            camera, depth_map: torch.Tensor, n_samples: int,
                            draws: Optional[Dict[str, Any]] = None):
    """(loss, beta): the L1 between the estimated density and the density
    of the ideal SDF at the samples the rendered depth can see."""
    g = gaussians
    pts, idx = sample_points_in_gaussians(generator, g["means"], g["scales"], g["quats"],
                                          g["alive"], n_samples, draws)
    dens = density_at_points(pts, idx, knn_idx, g["means"], g["scales"], g["quats"],
                             g["opacities"], g["alive"])
    beta = estimate_beta(g["scales"], g["alive"])
    z, surf, valid = project_to_depth(pts, camera, depth_map)
    target = torch.exp(-0.5 * ((z - surf) / torch.clamp_min(beta, 1e-6)) ** 2)
    err = torch.abs(torch.clamp(dens, 0.0, 1.0) - target) * valid
    return torch.sum(err) / torch.clamp_min(torch.sum(valid), 1.0), beta


def sdf_better_normal_loss(generator, gaussians: Dict[str, torch.Tensor], knn_idx: torch.Tensor,
                           n_samples: int, normals_from_points: bool = False,
                           neighborhood_size: int = 32,
                           draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """mean(1 - |cos|) between the density gradient at the samples and the
    source Gaussian's smallest-scale axis, or with ``normals_from_points``
    the PCA normal of the (detached) centre cloud at the source."""
    g = gaussians
    pts, idx = sample_points_in_gaussians(generator, g["means"], g["scales"], g["quats"],
                                          g["alive"], n_samples, draws)
    with torch.enable_grad():
        p = pts if pts.requires_grad else pts.detach().requires_grad_(True)
        dens = density_at_points(p, idx, knn_idx, g["means"], g["scales"], g["quats"],
                                 g["opacities"], g["alive"])
        grads = torch.autograd.grad(dens.sum(), p, create_graph=True)[0]
    grad_dir = normalize_vec(grads)
    if normals_from_points:
        normal_axis = estimate_pointcloud_normals(g["means"].detach(), neighborhood_size)[idx]
    else:
        rot = quaternion.to_rotation_matrix(g["quats"][idx])
        axis_id = torch.argmin(g["scales"][idx], dim=-1)
        normal_axis = rot.transpose(-1, -2)[torch.arange(idx.shape[0], device=idx.device),
                                            axis_id]
    cos = torch.abs(torch.sum(grad_dir * normal_axis, dim=-1))
    return torch.mean(1.0 - cos)
