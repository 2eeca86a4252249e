"""Log-depth parameterization + GP conditioning mean (port of como_tpu/geometry/depth.py)."""

from __future__ import annotations

import torch


def log_depth_to_depth(log_depth: torch.Tensor):
    depth = torch.exp(log_depth)
    return depth, depth[..., None]


def depth_to_log_depth(depth: torch.Tensor):
    return torch.log(depth), (1.0 / depth)[..., None]


def predict_log_depth(logz_m: torch.Tensor, Knm_Kmminv: torch.Tensor):
    """logz_m (B, M, 1), Knm_Kmminv (B, N, M) -> (B, N, 1), (B, N, 1, M)."""
    return Knm_Kmminv @ logz_m, Knm_Kmminv[..., None, :]


def backproject_depth_img(depth_img: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) depth -> (B, 3, H, W) camera points."""
    h, w = depth_img.shape[-2:]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=depth_img.dtype, device=depth_img.device),
        torch.arange(w, dtype=depth_img.dtype, device=depth_img.device),
        indexing="ij")
    rx = (xs - K[0, 2]) / K[0, 0]
    ry = (ys - K[1, 2]) / K[1, 1]
    return depth_img * torch.stack([rx, ry, torch.ones_like(rx)], 0)[None]
