"""Loss helpers (port of the JAX package's ``utils/loss.py``)."""

from __future__ import annotations

import torch


def tv_loss(img: torch.Tensor) -> torch.Tensor:
    """Total variation on (B, H, W, C) images."""
    h_diff = img[:, 1:, :, :] - img[:, :-1, :, :]
    w_diff = img[:, :, 1:, :] - img[:, :, :-1, :]
    return torch.mean(h_diff**2) + torch.mean(w_diff**2)


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def pearson_correlation(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Pearson correlation of the flattened inputs."""
    a = a.reshape(-1)
    b = b.reshape(-1)
    a = a - torch.mean(a)
    b = b - torch.mean(b)
    return torch.sum(a * b) / torch.clamp_min(torch.linalg.norm(a) * torch.linalg.norm(b), eps)


def psnr(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, eps))
