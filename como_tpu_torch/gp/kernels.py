"""Probability-product Matern kernel over 2D Gaussian pixel sites
(port of como_tpu/gp/kernels.py).

Coordinates are normalized to [-1, 1]; covariances are packed
(e00, e11, e01).  `cross_covariance` is the dispatching wrapper of
gp/kernels_cuda.py: every CUDA-resident call, large or small, runs the
hand-written kernel.
"""

from __future__ import annotations

import torch

from como_tpu_torch.gp.kernels_cuda import _EPS, cross_covariance, matern32  # noqa: F401


def pack_cov(E: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) -> (..., 3) packed (e00, e11, e01)."""
    return torch.stack([E[..., 0, 0], E[..., 1, 1], E[..., 0, 1]], -1)


def unpack_cov(e: torch.Tensor) -> torch.Tensor:
    """(..., 3) packed -> (..., 2, 2)."""
    e00, e11, e01 = e[..., 0], e[..., 1], e[..., 2]
    return torch.stack([torch.stack([e00, e01], -1), torch.stack([e01, e11], -1)], -2)


def diag_covariance(e: torch.Tensor, scale) -> torch.Tensor:
    """diag K(X, X): Q = 0, C = 2 sqrt(det E) / safe_sqrt(det 2E)."""
    det = e[..., 0] * e[..., 1] - e[..., 2] * e[..., 2]
    C = 2.0 * torch.sqrt(det) / torch.sqrt(4.0 * det + _EPS)
    return scale * C * matern32(torch.zeros_like(det))


def interpolate_cov_params(cov_img: torch.Tensor, coords_norm: torch.Tensor) -> torch.Tensor:
    """Sample a packed (3, H, W) covariance image at normalized rc coords
    (N, 2) with border padding -> (N, 3)."""
    from como_tpu_torch.ops.coords import unnormalize_coords
    from como_tpu_torch.ops.interp import bilinear_sample

    H, W = cov_img.shape[-2:]
    rc = unnormalize_coords(coords_norm, [H, W])
    xy = torch.stack([rc[..., 1], rc[..., 0]], -1)
    return bilinear_sample(cov_img, xy, padding="border").T
