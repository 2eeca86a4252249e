"""Anchor correspondence + new-landmark initialization on keyframe insertion
(port of como_tpu/odom/frontend/corr.py).

Reproject the previous KF's anchors and dense depth into the new KF,
re-distill anchor log-depths through the new frame's GP, keep anchors that
pass the two-sided log-depth check and the discontinuity filter, subsample
them by greedy conditional entropy, then fill the budget with new anchors
whose depths are solved conditioned on the tracked ones.  Static shapes:
invalid anchors are parked at distinct far-away coords; every index built
from sampler output is clamped before it is used for a gather.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from como_tpu_torch.geometry import lie
from como_tpu_torch.gp import distill, kernels, predictor, sampler
from como_tpu_torch.ops import image as img_ops
from como_tpu_torch.ops import linalg
from como_tpu_torch.ops.coords import coord_grid_rc, normalize_coords
from como_tpu_torch.ops.interp import bilinear_sample


class CorrResult(NamedTuple):
    coords_all: torch.Tensor   # (M, 2) anchor pixels (xy) in the new KF
    z_all: torch.Tensor        # (M,) anchor depths in the new KF
    tracked: torch.Tensor      # (M,) bool: slot is a tracked correspondence
    src_anchor: torch.Tensor   # (M,) int64: old-KF anchor index for tracked
    valid: torch.Tensor        # (M,) slot validity


class CorrStatic(NamedTuple):
    corr_thresh: float = 3e-2
    min_obs_depth: float = 0.0
    logz_grad_mag_thresh: float = 7e-2
    distill_with_prior: bool = True
    max_stdev_thresh: float = 1e-2
    border: int = 3
    dist_thresh: float = 1e-1
    fixed_var: float = 0.0
    sigma_median: float = 5e-2
    corr_mode: str = "logz"
    sample_mode: str = "greedy_conditional_entropy"


def _reproject(pm_xy, z, Tji, K):
    ray = torch.stack([(pm_xy[..., 0] - K[0, 2]) / K[0, 0],
                       (pm_xy[..., 1] - K[1, 2]) / K[1, 1],
                       torch.ones_like(z)], -1)
    P = z[..., None] * ray
    Pj = P @ Tji[:3, :3].T + Tji[:3, 3]
    zj = Pj[..., 2]
    zs = torch.where(torch.abs(zj) > 1e-9, zj, torch.full_like(zj, 1e-9))
    pj = torch.stack([K[0, 0] * Pj[..., 0] / zs + K[0, 2],
                      K[1, 1] * Pj[..., 1] / zs + K[1, 2]], -1)
    return pj, zj


def _corr_errors(z_a, z_b, pix_xy, K, mode: str):
    if mode == "logz":
        return torch.abs(torch.log(torch.clamp(z_a, min=1e-9))
                         - torch.log(torch.clamp(z_b, min=1e-9)))
    if mode == "z":
        return torch.abs(z_a - z_b)
    if mode == "3d":
        rx = (pix_xy[..., 0] - K[0, 2]) / K[0, 0]
        ry = (pix_xy[..., 1] - K[1, 2]) / K[1, 1]
        return torch.abs(z_a - z_b) * torch.sqrt(rx * rx + ry * ry + 1.0)
    raise ValueError(f"unknown corr_mode '{mode}'")


def track_and_init(pose1, pose2, pm1_xy, logzm1, depth_img1, cov_img2, K, scale,
                   M: int, cfg: CorrStatic, generator=None) -> CorrResult:
    """cfg: CorrStatic thresholds; depth_img1 (H, W).  `generator` is the
    counterpart of the JAX PRNG key: only random_uniform sampling (not
    ported) would read it."""
    if cfg.sample_mode != "greedy_conditional_entropy":
        raise NotImplementedError("sampling.mode random_uniform is not ported yet")
    H, W = depth_img1.shape
    dtype, dev = depth_img1.dtype, depth_img1.device
    Tji = lie.invert_se3(pose2) @ pose1
    Tij = lie.invert_se3(Tji)

    zm1 = torch.exp(logzm1)
    pj_m, zj_m = _reproject(pm1_xy, zm1, Tji, K)
    rc = coord_grid_rc((H, W), dtype=dtype, device=dev)
    xy_n = torch.stack([rc[:, 1], rc[:, 0]], -1)
    z_n1 = depth_img1.reshape(-1)
    pj_n, zj_n = _reproject(xy_n, z_n1, Tji, K)

    def interior(p, z):
        return ((p[..., 0] >= 1) & (p[..., 0] < W - 1)
                & (p[..., 1] >= 1) & (p[..., 1] < H - 1) & (z > cfg.min_obs_depth))

    mask_m = interior(pj_m, zj_m)
    mask_n = interior(pj_n, zj_n)

    # z-buffer visibility filter: scatter-min per target pixel (min is
    # order-independent, so the result is deterministic)
    px = torch.clamp(torch.round(pj_n[:, 0]).to(torch.int64), 0, W - 1)
    py = torch.clamp(torch.round(pj_n[:, 1]).to(torch.int64), 0, H - 1)
    flat = py * W + px
    inf = torch.full_like(zj_n, float("inf"))
    zbuf = torch.full((H * W,), float("inf"), dtype=dtype, device=dev)
    zbuf = zbuf.scatter_reduce(0, flat, torch.where(mask_n, zj_n, inf), reduce="amin")
    mask_n = mask_n & (zj_n <= 1.2 * zbuf[flat])

    ar = torch.arange(M, dtype=dtype, device=dev)
    sent = torch.stack([-10.0 - 3.0 * ar, torch.full_like(ar, -10.0)], -1)
    coords_m_norm = torch.where(
        mask_m[:, None],
        normalize_coords(torch.stack([pj_m[:, 1], pj_m[:, 0]], -1), [H, W]), sent)
    coords_n_norm = normalize_coords(torch.stack([pj_n[:, 1], pj_n[:, 0]], -1), [H, W])

    # -- GP distill of tracked anchor depths ------------------------------
    e_m = kernels.interpolate_cov_params(cov_img2, coords_m_norm)
    e_n = cov_img2.reshape(3, -1).T
    K_mm, K_nm, K_nn_diag = predictor.kernel_matrices(coords_m_norm, e_m,
                                                      coords_n_norm, e_n, scale)
    pred = predictor.build_predictor(K_mm, K_nm, jitter=1e-6)
    stdev_inv = predictor.predictive_stdev_inv(K_nm, pred.Knm_Kmminv, K_nn_diag)
    logz_obs = torch.log(torch.clamp(zj_n, min=1e-9))
    logz_m, resid = distill.distill_depth(
        pred.Knm_Kmminv, logz_obs, mask_n, with_prior=cfg.distill_with_prior,
        L_mm=pred.L_mm, stdev_inv_obs=stdev_inv)
    z_m = torch.exp(logz_m)

    # -- two-sided consistency + discontinuity filters --------------------
    err_j = _corr_errors(zj_m, z_m, pj_m, K, cfg.corr_mode)
    pi_m, zi_m = _reproject(pj_m, z_m, Tij, K)
    z_back = bilinear_sample(depth_img1[None], pi_m, padding="zeros")[0]
    err_i = _corr_errors(z_back, zi_m, pi_m, K, cfg.corr_mode)
    corr_err = torch.maximum(err_i, err_j)

    logd = torch.log(torch.clamp(depth_img1, min=1e-9))[None, None]
    lgx, lgy = img_ops.image_gradients(logd)
    gmag = torch.sqrt(lgx[0, 0] ** 2 + lgy[0, 0] ** 2)
    gref = bilinear_sample(gmag[None], pm1_xy, padding="zeros")[0]
    cand = mask_m & (corr_err < cfg.corr_thresh) & (gref < cfg.logz_grad_mag_thresh)

    # -- subsample tracked candidates --------------------------------------
    zM2 = torch.zeros((M, 2), dtype=dtype, device=dev)
    zM3 = torch.zeros((M, 3), dtype=dtype, device=dev)
    zMb = torch.zeros((M,), dtype=torch.bool, device=dev)
    zM = torch.zeros((M,), dtype=dtype, device=dev)
    res_keep = sampler.greedy_entropy_sample(
        coords_m_norm, e_m, cand, zM2, zM3, zMb, zM, signal_var=scale,
        fixed_var=cfg.fixed_var, max_stdev_thresh=cfg.max_stdev_thresh,
        dist_thresh=cfg.dist_thresh, num_slots=M, terminate_early=True)
    keep_idx = torch.where(res_keep.is_new, res_keep.domain_inds,
                           torch.zeros_like(res_keep.domain_inds)).clamp(0, M - 1)
    n_keep = res_keep.is_new.sum()

    tracked_slot = torch.arange(M, device=dev) < n_keep
    src_anchor = torch.where(tracked_slot, keep_idx, torch.full_like(keep_idx, -1))
    coords_tr_norm = torch.where(tracked_slot[:, None], coords_m_norm[keep_idx], sent)
    e_tr = e_m[keep_idx]
    z_tr = z_m[keep_idx]

    # -- fill remaining slots with new anchors over the full image --------
    dom_norm, e_dom, dom_valid, dom_rc = sampler.full_image_domain(cov_img2,
                                                                   border=cfg.border)
    res_new = sampler.greedy_entropy_sample(
        dom_norm, e_dom, dom_valid, coords_tr_norm, e_tr, tracked_slot, zM,
        signal_var=scale, fixed_var=cfg.fixed_var,
        max_stdev_thresh=cfg.max_stdev_thresh, dist_thresh=cfg.dist_thresh,
        num_slots=M, terminate_early=False)
    new_domain_inds = res_new.domain_inds.clamp(0, H * W - 1)
    new_slot = res_new.is_new
    coords_all_norm = torch.where(tracked_slot[:, None], coords_tr_norm,
                                  res_new.coords_norm)
    e_all = torch.where(tracked_slot[:, None], e_tr, res_new.covs)

    # -- conditional distill for the new anchors --------------------------
    K_mm2, K_nm2, _ = predictor.kernel_matrices(coords_all_norm, e_all,
                                                coords_n_norm, e_n, scale)
    pred2 = predictor.build_predictor(K_mm2, K_nm2, jitter=1e-6)
    resid_var = torch.sum(torch.square(resid) * mask_n) / torch.clamp(
        mask_n.sum() - 1, min=1)
    sigma_r = torch.sqrt(resid_var) + 1e-9
    logz1 = torch.where(tracked_slot, torch.log(torch.clamp(z_tr, min=1e-9)),
                        torch.zeros_like(z_tr))
    logz2 = distill.distill_conditional_depth(
        pred2.Knm_Kmminv, logz_obs, mask_n & (zj_n > 0.0), logz1, tracked_slot,
        torch.full_like(logz_obs, 1.0) / sigma_r, sigma_median=cfg.sigma_median)

    z_all = torch.where(tracked_slot, z_tr, torch.exp(logz2))
    # non-finite / non-positive depths fall back to the observed median, or
    # to the old KF's anchor median if the observation cloud degenerated
    z_med = torch.exp(linalg.masked_median(logz_obs, mask_n))
    z_med = torch.where(torch.isfinite(z_med) & (z_med > 1e-4), z_med,
                        torch.exp(linalg.median(logzm1)))
    z_ok = torch.isfinite(z_all) & (z_all > 1e-4) & (z_all < 1e4)
    z_all = torch.where(z_ok, z_all, z_med)
    rc_all = torch.where(tracked_slot[:, None],
                         torch.stack([pj_m[keep_idx][:, 1], pj_m[keep_idx][:, 0]], -1),
                         dom_rc[new_domain_inds])
    coords_all_xy = torch.stack([rc_all[:, 1], rc_all[:, 0]], -1)
    return CorrResult(coords_all=coords_all_xy, z_all=z_all, tracked=tracked_slot,
                      src_anchor=src_anchor, valid=tracked_slot | new_slot)
