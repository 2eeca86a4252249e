"""Two-frame SfM bootstrap: joint GN over (pose, anchor log-depths)
(port of como_tpu/odom/frontend/sfm.py).

Coarse-to-fine GN over the relative pose and the M anchor log-depths, with
a photometric term whose depth Jacobian flows through the GP predictor, a
GP sparse-depth prior and a mean-log-depth gauge prior.

The JAX `lax.while_loop` per level becomes a Python loop of exactly
`max_iter` iterations with an on-device `done` flag that freezes
(Tji, logzm) once the convergence test fires — the same result as the
while-loop, without reading a flag back each iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from como_tpu_torch.geometry import lie
from como_tpu_torch.gp import kernels
from como_tpu_torch.odom.backend.robust import huber as huber_weight
from como_tpu_torch.ops import image as img_ops
from como_tpu_torch.ops import linalg
from como_tpu_torch.ops.coords import coord_grid_rc, fill_image, normalize_coords
from como_tpu_torch.ops.interp import bilinear_sample
from como_tpu_torch.ops.reduce import fast_mad_sigma, histogram_median


class SfmLevel(NamedTuple):
    vals: torch.Tensor    # (N,) reference intensities
    rays: torch.Tensor    # (N, 3) unit-z rays
    W: torch.Tensor       # (N, M) predictor rows
    K: torch.Tensor       # (3, 3) level intrinsics


class SfmRef(NamedTuple):
    levels: Sequence[SfmLevel]
    Kmm_inv: torch.Tensor
    L_mm: torch.Tensor
    coords_m_xy: torch.Tensor


def setup_reference(rgb, cov_img, coords_m_rc, K, scale, start_level: int,
                    end_level: int) -> SfmRef:
    H, W_img = rgb.shape[-2:]
    dtype, dev = rgb.dtype, rgb.device
    gray = img_ops.rgb_to_gray(rgb)
    img_pyr = img_ops.image_pyramid(gray, start_level, end_level)
    K_pyr = img_ops.intrinsics_pyramid(K, start_level, end_level)

    coords_m_norm = normalize_coords(coords_m_rc, [H, W_img])
    e_m = kernels.interpolate_cov_params(cov_img, coords_m_norm)
    K_mm = kernels.cross_covariance(coords_m_norm, e_m, coords_m_norm, e_m, scale)
    M = K_mm.shape[0]
    # scale-adaptive jitter (wide kernels make K_mm near rank-1)
    jitter = 1e-6 + 1e-4 * torch.mean(torch.diagonal(K_mm))
    L_mm = linalg.cholesky(K_mm + jitter * torch.eye(M, dtype=dtype, device=dev))
    Kmm_inv = linalg.cholesky_inverse(L_mm)

    levels = []
    for img_l, K_l in zip(img_pyr, K_pyr):
        h, w = img_l.shape[-2:]
        rc = coord_grid_rc((h, w), dtype, dev)
        norm = normalize_coords(rc, [h, w])
        e_n = kernels.interpolate_cov_params(cov_img, norm)
        K_nm = kernels.cross_covariance(norm, e_n, coords_m_norm, e_m, scale)
        rays = torch.stack([(rc[:, 1] - K_l[0, 2]) / K_l[0, 0],
                            (rc[:, 0] - K_l[1, 2]) / K_l[1, 1],
                            torch.ones((h * w,), dtype=dtype, device=dev)], -1)
        levels.append(SfmLevel(vals=img_l.reshape(-1), rays=rays, W=K_nm @ Kmm_inv,
                               K=K_l))
    return SfmRef(levels=levels, Kmm_inv=Kmm_inv, L_mm=L_mm,
                  coords_m_xy=torch.stack([coords_m_rc[:, 1], coords_m_rc[:, 0]], -1))


def _iter(Tji, logzm, lvl: SfmLevel, img_j3, Kmm_inv, colmean):
    M = logzm.shape[0]
    h, w = img_j3.shape[-2:]
    K_l = lvl.K
    fx, fy, cx, cy = K_l[0, 0], K_l[1, 1], K_l[0, 2], K_l[1, 2]
    dtype, dev = logzm.dtype, logzm.device
    D = 6 + M

    logz_n = lvl.W @ logzm
    z_n = torch.exp(logz_n)
    Pi = z_n[:, None] * lvl.rays
    R, t = Tji[:3, :3], Tji[:3, 3]
    Pj = Pi @ R.T + t
    zj = Pj[:, 2]
    zs = torch.where(torch.abs(zj) > 1e-9, zj, torch.full_like(zj, 1e-9))
    px = fx * Pj[:, 0] / zs + cx
    py = fy * Pj[:, 1] / zs + cy
    samp = bilinear_sample(img_j3, torch.stack([px, py], -1), "zeros")
    I_t, gx, gy = samp[0], samp[1], samp[2]
    valid = (px >= 1) & (px < w - 1) & (py >= 1) & (py < h - 1) & (zj > 0)
    r = I_t - lvl.vals

    sigma = fast_mad_sigma(r, valid) + 1e-12
    wgt = huber_weight(r / sigma) * valid / (sigma * sigma)

    a2 = torch.stack([gx * fx, gy * fy], -1) / zs[:, None]
    dI_dPj = torch.stack([a2[:, 0], a2[:, 1],
                          -(a2[:, 0] * (px - cx) / fx + a2[:, 1] * (py - cy) / fy)], -1)
    aR = dI_dPj @ R
    J_T = torch.cat([torch.linalg.cross(Pi, aR), aR], -1)
    s = torch.sum(aR * (lvl.rays * z_n[:, None]), -1)
    Jw = J_T * wgt[:, None]
    H_TT = Jw.T @ J_T
    H_Td = (Jw * s[:, None]).T @ lvl.W
    H_dd = (lvl.W * (wgt * s * s)[:, None]).T @ lvl.W
    g_T = -(J_T.T @ (wgt * r))
    g_d = -(lvl.W.T @ (wgt * s * r)[:, None])[:, 0]
    photo_err = torch.sum(wgt * r * r)

    Kinv_lz = (Kmm_inv @ logzm[:, None])[:, 0]
    H_dd = H_dd + Kmm_inv
    g_d = g_d - Kinv_lz
    prior_err = torch.dot(logzm, Kinv_lz)

    w_mean = float(lvl.vals.shape[0])
    mean_r = torch.mean(logz_n)
    H_dd = H_dd + w_mean * torch.outer(colmean, colmean)
    g_d = g_d - w_mean * colmean * mean_r
    mean_err = w_mean * mean_r * mean_r

    H = torch.zeros((D, D), dtype=dtype, device=dev)
    H[:6, :6] = H_TT
    H[:6, 6:] = H_Td
    H[6:, :6] = H_Td.T
    H[6:, 6:] += H_dd
    g = torch.cat([g_T, g_d])
    dsc = torch.rsqrt(torch.abs(torch.diagonal(H)) + 1e-12)
    Hs = H * dsc[:, None] * dsc[None, :] + 1e-7 * torch.eye(D, dtype=dtype, device=dev)
    delta = linalg.chol_solve(linalg.cholesky(Hs), (g * dsc)[:, None])[:, 0] * dsc
    delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))

    # trust region on the pose step and per-anchor log-depth steps
    dT = delta[:6]
    dT = dT * torch.clamp(1.0 / torch.clamp(torch.linalg.norm(dT), min=1e-12), max=1.0)
    dz = torch.clamp(delta[6:], -0.5, 0.5)
    Tji_new = Tji @ lie.se3_exp(dT)
    total = photo_err + prior_err + mean_err
    return Tji_new, logzm + dz, torch.linalg.norm(delta[:6]), total


def _level_gn(Tji, logzm, lvl: SfmLevel, img_j3, Kmm_inv, term: dict):
    """max_iter masked GN iterations on one level (see module doc)."""
    dev = logzm.device
    colmean = torch.mean(lvl.W, 0)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    prev = torch.full((), float("inf"), dtype=logzm.dtype, device=dev)
    max_iter = term["max_iter"]
    for k in range(max_iter):
        Tji2, logzm2, dn, tot = _iter(Tji, logzm, lvl, img_j3, Kmm_inv, colmean)
        dec = prev - tot
        rel = torch.abs(dec) / torch.clamp(prev, min=1e-20)
        fire = ((k + 1 >= max_iter) | (dn < term["delta_norm"])
                | ((rel < term["rel_tol"]) & (dec > 0)))
        Tji = torch.where(done, Tji, Tji2)
        logzm = torch.where(done, logzm, logzm2)
        prev = torch.where(done, prev, tot)
        done = done | fire
    return Tji, logzm


def sfm_align(ref: SfmRef, img_pyr_j3, Tji_init, logzm_init, term: dict):
    """Coarse-to-fine joint pose+depth GN; returns (Tji, logzm,
    mean_log_depth, reprojection coverage count, median reprojected depth)."""
    Tji, logzm = Tji_init, logzm_init
    for lvl, img_j3 in zip(ref.levels, img_pyr_j3):
        Tji, logzm = _level_gn(Tji, logzm, lvl, img_j3, ref.Kmm_inv, term)
    fin = ref.levels[-1]
    logz_n = fin.W @ logzm
    mean_log_depth = torch.mean(logz_n)
    z_n = torch.exp(logz_n)
    Pi = z_n[:, None] * fin.rays
    R, t = Tji[:3, :3], Tji[:3, 3]
    Pj = Pi @ R.T + t
    zj = Pj[:, 2]
    zs = torch.where(torch.abs(zj) > 1e-9, zj, torch.full_like(zj, 1e-9))
    K_l = fin.K
    px = K_l[0, 0] * Pj[:, 0] / zs + K_l[0, 2]
    py = K_l[1, 1] * Pj[:, 1] / zs + K_l[1, 2]
    h, w = img_pyr_j3[-1].shape[-2:]
    valid = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1) & (zj > 0)
    rc = torch.where(valid[:, None], torch.stack([py, px], -1),
                     torch.full((px.shape[0], 2), -1.0, dtype=px.dtype, device=px.device))
    img = fill_image(rc, zj, (h, w), default_val=float("nan"))
    filled = ~torch.isnan(img)
    count = filled.sum()
    med = histogram_median(torch.where(filled, img, torch.zeros_like(img)), filled)
    return Tji, logzm, mean_log_depth, count, med
