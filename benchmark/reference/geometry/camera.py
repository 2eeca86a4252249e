"""Pinhole camera with hand-derived Jacobians (port of como_tpu/geometry/camera.py).

K (3, 3); pixel coords are (x, y) = (col, row); points P (..., 3).
"""

from __future__ import annotations

import torch


def resize_intrinsics(K: torch.Tensor, scale_yx) -> torch.Tensor:
    sy, sx = float(scale_yx[0]), float(scale_yx[1])
    T = torch.tensor([[sx, 0.0, sx], [0.0, sy, sy], [0.0, 0.0, 1.0]],
                     dtype=K.dtype, device=K.device)
    return T @ K


def project(K: torch.Tensor, P: torch.Tensor):
    """P (..., 3) -> p (..., 2), dp_dP (..., 2, 3)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = P[..., 2]
    u = fx * P[..., 0] / z
    v = fy * P[..., 1] / z
    p = torch.stack([u + cx, v + cy], -1)
    zero = torch.zeros_like(u)
    row0 = torch.stack([fx.expand(u.shape), zero, -u], -1)
    row1 = torch.stack([zero, fy.expand(v.shape), -v], -1)
    dp_dP = torch.stack([row0, row1], -2) / z[..., None, None]
    return p, dp_dP


def backproject(K: torch.Tensor, p: torch.Tensor, z: torch.Tensor):
    """p (..., 2) at depth z (..., 1) -> P (..., 3), dP_dz (..., 3, 1)."""
    rx = (p[..., 0] - K[0, 2]) / K[0, 0]
    ry = (p[..., 1] - K[1, 2]) / K[1, 1]
    ray = torch.stack([rx, ry, torch.ones_like(rx)], -1)
    return z * ray, ray[..., None]


def transform_project(K: torch.Tensor, Tji: torch.Tensor, Pi: torch.Tensor):
    """Tji (B, 4, 4), Pi (B|1, N, 3) -> p (B, N, 2), depth (B, N, 1)."""
    Pmat = K[None] @ Tji[:, :3, :]
    A = Pmat[:, None, :3, :3]
    b = Pmat[:, None, :3, 3]
    ph = (A @ Pi[..., None])[..., 0] + b
    depth = ph[..., 2:3]
    return ph[..., :2] / depth, depth
