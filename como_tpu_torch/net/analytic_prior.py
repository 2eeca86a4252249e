"""Analytic structure-tensor depth-covariance prior (port of
como_tpu/net/analytic_prior.py).

Wide isotropic kernels on flat texture, narrow across strong edges; output
is the packed (e00, e11, e01) covariance image the GP stack consumes, in
normalized [-1, 1] coordinates.  No parameters.
"""

from __future__ import annotations

import torch

from como_tpu_torch.ops import image as img_ops

COV_MIN = 1e-3
COV_MAX = 1e4
CORR_MAX = 0.99


def _gauss_blur_n(x: torch.Tensor, n: int = 3) -> torch.Tensor:
    for _ in range(n):
        x = img_ops.gaussian_blur(x)
    return x


def cov_params_from_rgb(rgb: torch.Tensor, sigma_smooth: float = 0.35,
                        sigma_edge: float = 0.02, gain: float = 4000.0) -> torch.Tensor:
    """(1, 3, H, W) rgb in [0, 1] -> (3, H, W) packed covariance image."""
    gray = img_ops.rgb_to_gray(rgb)
    gx, gy = img_ops.image_gradients(gray)
    jxx = _gauss_blur_n(gx * gx)[0, 0]
    jyy = _gauss_blur_n(gy * gy)[0, 0]
    jxy = _gauss_blur_n(gx * gy)[0, 0]

    tr = jxx + jyy
    diff = jxx - jyy
    rad = torch.sqrt(diff * diff + 4.0 * jxy * jxy + 1e-20)
    lam1 = 0.5 * (tr + rad)
    lam2 = 0.5 * (tr - rad)
    big = torch.abs(jxy) > 1e-12
    v1x = torch.where(big, jxy, torch.ones_like(jxy))
    v1y = torch.where(big, lam1 - jxx, torch.zeros_like(jxy))
    nrm = torch.sqrt(v1x * v1x + v1y * v1y + 1e-20)
    v1x, v1y = v1x / nrm, v1y / nrm
    v2x, v2y = -v1y, v1x

    def sig(lam):
        return sigma_edge + (sigma_smooth - sigma_edge) / (
            1.0 + gain * torch.clamp(lam, min=0.0))

    s1 = sig(lam1) ** 2
    s2 = sig(lam2) ** 2
    exx = s1 * v1x * v1x + s2 * v2x * v2x
    eyy = s1 * v1y * v1y + s2 * v2y * v2y
    exy = s1 * v1x * v1y + s2 * v2x * v2y

    e00 = torch.clamp(eyy, COV_MIN, COV_MAX)
    e11 = torch.clamp(exx, COV_MIN, COV_MAX)
    corr = torch.clamp(exy / torch.sqrt(eyy * exx + 1e-20), -CORR_MAX, CORR_MAX)
    e01 = corr * torch.sqrt(torch.clamp(e00 * e11 - 1e-8, min=0.0))
    return torch.stack([e00, e11, e01], 0)
