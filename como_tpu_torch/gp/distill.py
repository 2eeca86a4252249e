"""Depth distillation through the GP predictor (port of como_tpu/gp/distill.py).

Rows are weighted instead of filtered, so every shape is static.
"""

from __future__ import annotations

import torch

from como_tpu_torch.ops import linalg


def _weighted_normal_solve(A: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """argmin ||diag(w)(A x - b)|| via the normal equations; b (N,)."""
    Aw = A * w[..., None]
    bw = b * w
    ATA = Aw.transpose(-1, -2) @ Aw
    ATb = Aw.transpose(-1, -2) @ bw[..., None]
    ATA = ATA + 1e-10 * torch.eye(ATA.shape[-1], dtype=ATA.dtype, device=ATA.device)
    return linalg.chol_solve(linalg.cholesky(ATA), ATb)


def distill_depth(Knm_Kmminv, logz_obs, obs_mask, with_prior: bool,
                  L_mm=None, stdev_inv_obs=None):
    """Anchor log-depths (M,) from dense observations; also the masked
    residuals (N,) = pred - obs."""
    n, m = Knm_Kmminv.shape
    dtype, dev = Knm_Kmminv.dtype, Knm_Kmminv.device
    w_obs = obs_mask.to(dtype)
    if stdev_inv_obs is not None:
        w_obs = w_obs * stdev_inv_obs
    if not with_prior:
        logz_m = _weighted_normal_solve(Knm_Kmminv, logz_obs, w_obs)[..., 0]
    else:
        I_m = torch.eye(m, dtype=dtype, device=dev)
        L_inv = linalg.tri_solve_lower(L_mm, I_m)
        A = torch.cat([L_inv, Knm_Kmminv], 0)
        b = torch.cat([torch.zeros((m,), dtype=dtype, device=dev), logz_obs], 0)
        w = torch.cat([torch.ones((m,), dtype=dtype, device=dev), w_obs], 0)
        logz_m = _weighted_normal_solve(A, b, w)[..., 0]
    residuals = (Knm_Kmminv @ logz_m - logz_obs) * obs_mask
    return logz_m, residuals


def distill_conditional_depth(Knm_Kmminv, logz_obs, obs_mask, logz1, m1_mask,
                              stdev_inv_obs, sigma_median: float = 5e-2):
    """New-anchor log-depths conditioned on tracked ones (fixed at logz1)
    with a median-depth prior on the new ones; zeros at tracked slots."""
    n, m = Knm_Kmminv.shape
    dtype, dev = Knm_Kmminv.dtype, Knm_Kmminv.device
    w1 = m1_mask.to(dtype)
    w2 = 1.0 - w1
    s = linalg.masked_median(logz_obs, obs_mask)
    stdev_inv_prior = 1.0 / sigma_median
    eye = torch.eye(m, dtype=dtype, device=dev)

    A_obs = Knm_Kmminv * w2[None, :]
    b_obs = logz_obs - Knm_Kmminv @ (logz1 * w1)
    w_obs = obs_mask.to(dtype) * stdev_inv_obs
    A_pri = eye * w2[None, :]
    b_pri = s.expand(m).to(dtype)
    w_pri = stdev_inv_prior * w2
    A_fix = eye * w1[None, :]
    A = torch.cat([A_pri, A_obs, A_fix], 0)
    b = torch.cat([b_pri, b_obs, torch.zeros((m,), dtype=dtype, device=dev)], 0)
    w = torch.cat([w_pri, w_obs, w1], 0)
    logz2 = _weighted_normal_solve(A, b, w)[..., 0]
    return logz2 * w2
