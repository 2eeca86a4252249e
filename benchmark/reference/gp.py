"""The GP pieces of keyframe insertion in plain PyTorch: the probability-
product Matern cross-covariance, the keyframe's dense-depth predictor and
the greedy conditional-entropy sampler, scored step by step.

The cross-covariance is the formula of the port's plain twin
(como_tpu_torch/gp/kernels_cuda.py::cross_covariance_plain), frozen here;
`dtype` computes it in another precision (the control).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.ops import linalg
from benchmark.reference.ops.coords import coord_grid_rc, normalize_coords, unnormalize_coords
from benchmark.reference.ops.interp import bilinear_sample

SQRT3 = math.sqrt(3.0)
EPS = 1e-8


def matern32(Q: torch.Tensor) -> torch.Tensor:
    t = SQRT3 * torch.sqrt(Q + EPS)
    return (1.0 + t) * torch.exp(-t)


def cross_covariance(x_n, e_n, x_m, e_m, scale, dtype=torch.float32) -> torch.Tensor:
    """K (N, M) between sites (x_n (N, 2), packed covs e_n (N, 3)) and
    anchors (x_m, e_m), in `dtype`, returned as f32."""
    x_n, e_n, x_m, e_m = (t.to(dtype) for t in (x_n, e_n, x_m, e_m))
    d0 = x_n[:, None, 0] - x_m[None, :, 0]
    d1 = x_n[:, None, 1] - x_m[None, :, 1]
    s00 = e_n[:, None, 0] + e_m[None, :, 0]
    s11 = e_n[:, None, 1] + e_m[None, :, 1]
    s01 = e_n[:, None, 2] + e_m[None, :, 2]
    inv_det = 1.0 / (s00 * s11 - s01 * s01)
    Q = 0.5 * inv_det * (s11 * d0 * d0 - 2.0 * s01 * d0 * d1 + s00 * d1 * d1)
    det1 = e_n[:, 0] * e_n[:, 1] - e_n[:, 2] * e_n[:, 2]
    det2 = e_m[:, 0] * e_m[:, 1] - e_m[:, 2] * e_m[:, 2]
    C = (2.0 * torch.pow(det1[:, None] * det2[None, :], 0.25)
         * torch.sqrt(torch.clamp(inv_det, min=0.0) + EPS))
    return (scale * C * matern32(Q)).to(torch.float32)


def interpolate_cov_params(cov_img: torch.Tensor, coords_norm: torch.Tensor) -> torch.Tensor:
    """The packed (3, H, W) covariance image at normalized rc coords (N, 2),
    border padding -> (N, 3)."""
    H, W = cov_img.shape[-2:]
    rc = unnormalize_coords(coords_norm, [H, W])
    xy = torch.stack([rc[..., 1], rc[..., 0]], -1)
    return bilinear_sample(cov_img, xy, padding="border").T


def dense_depth(cov_img, coords_xy, logzm, scale, dtype=torch.float32) -> torch.Tensor:
    """(H*W,) depth of a keyframe from its anchors (pixel xy (M, 2), log
    depths (M,)) through the GP predictor on its covariance image:
    exp(K_nm K_mm^-1 logz), K_mm with 1e-6 jitter.  `dtype` is the
    precision of the products (float32 or "tf32": TF32 matmuls)."""
    H, W = cov_img.shape[-2:]
    dev = cov_img.device
    rc_m = torch.stack([coords_xy[:, 1], coords_xy[:, 0]], -1)
    m_norm = normalize_coords(rc_m, [H, W])
    e_m = interpolate_cov_params(cov_img, m_norm)
    M = coords_xy.shape[0]
    K_mm = cross_covariance(m_norm, e_m, m_norm, e_m, scale)
    L_mm = linalg.cholesky(K_mm + 1e-6 * torch.eye(M, dtype=torch.float32, device=dev))
    Kmm_inv = linalg.cholesky_inverse(L_mm)
    n_norm = normalize_coords(coord_grid_rc((H, W), torch.float32, dev), [H, W])
    e_n = cov_img.reshape(3, -1).T
    K_nm = cross_covariance(n_norm, e_n, m_norm, e_m, scale)
    return torch.exp((K_nm @ Kmm_inv) @ logzm)


def sampler_gaps(inputs, kw, chosen, dtype=torch.float32):
    """Teacher-forced scoring of a greedy conditional-entropy sampler call.

    Replays the call slot by slot with the program's own choices
    (`chosen`: the (S,) domain indices it returned, -1 for existing anchors
    and unused slots) and, at each slot it filled from the domain, reads
    the reference's score (posterior stdev with the distance NMS, or the
    kernel width det(E) at slot 0 with no anchors) of the program's site
    against the best score.  Returns the largest shortfall over the
    slots, (best - chosen) / best, and the number of slots scored.  A slot
    left empty while the reference still has a site to pick reads 1."""
    worst, scored, _ = _replay(inputs, kw, chosen.tolist(), dtype)
    return worst, scored


def greedy_choices(inputs, kw, dtype=torch.float32) -> torch.Tensor:
    """The (S,) domain indices the greedy sampler picks when its scores
    are computed in `dtype` (-1 for existing anchors and unused slots)."""
    return torch.tensor(_replay(inputs, kw, None, dtype)[2], dtype=torch.int64)


def _replay(inputs, kw, chosen, dtype):
    domain_norm, e_domain, domain_valid, curr_norm, curr_e, curr_valid, curr_var = inputs
    signal_var, fixed_var = float(kw["signal_var"]), float(kw["fixed_var"])
    dist_sq = float(kw["dist_thresh"]) ** 2
    S = int(kw["num_slots"])
    dev = domain_norm.device
    x_dom = domain_norm.to(dtype)
    e_dom = e_domain.to(dtype)
    det_dom = e_dom[:, 0] * e_dom[:, 1] - e_dom[:, 2] ** 2
    dvalid = domain_valid.to(dtype)
    any_existing = bool(curr_valid.any())
    var = torch.full((domain_norm.shape[0],), signal_var, dtype=dtype, device=dev)
    min_d = torch.full_like(var, math.inf)
    sel_x, sel_e, rows = [], [], []
    Linv = torch.zeros((0, 0), dtype=dtype, device=dev)
    worst, scored = 0.0, 0
    picks = [-1] * S
    for i in range(S):
        existing = bool(curr_valid[i])
        if existing:
            x_i, e_i = curr_norm[i].to(dtype), curr_e[i].to(dtype)
            k_ii = signal_var + fixed_var + float(curr_var[i])
        else:
            stdev = torch.sqrt(torch.clamp(var, min=0.0)) + 1e-10
            cost = stdev * (min_d > dist_sq).to(dtype) * dvalid
            if i == 0 and not any_existing:
                cost = det_dom * dvalid
            best = float(cost.max())
            stop = best <= 0.0 or (kw["terminate_early"] and float(
                stdev[int(torch.argmax(cost))]) < float(kw["max_stdev_thresh"]))
            c = int(torch.argmax(cost)) if chosen is None else chosen[i]
            if chosen is None and stop:
                c = -1
            if c < 0:
                if not stop:
                    worst = max(worst, 1.0)
                    scored += 1
                break       # the loop stopped: no later slot is filled from the domain
            picks[i] = c
            scored += 1
            worst = max(worst, (best - float(cost[c])) / best if best > 0 else 1.0)
            x_i, e_i = x_dom[c], e_dom[c]
            k_ii = signal_var + fixed_var
        # rank-1 update of the anchors' inverse Cholesky factor and of the
        # domain's posterior variance
        if sel_x:
            k_ni = cross_covariance(x_i[None], e_i[None], torch.stack(sel_x),
                                    torch.stack(sel_e), signal_var, dtype)[0].to(dtype)
            l_ni = Linv @ k_ni
        else:
            l_ni = torch.zeros((0,), dtype=dtype, device=dev)
        l_ii = math.sqrt(max(k_ii - float(torch.sum(l_ni * l_ni)), 1e-12))
        k_id = cross_covariance(x_i[None], e_i[None], x_dom, e_dom, signal_var, dtype)[0]
        k_id = k_id.to(dtype)
        obs = ((k_id - (l_ni[None, :] @ torch.stack(rows))[0]) if rows else k_id) / l_ii
        rows.append(obs)
        var = var - obs * obs
        min_d = torch.minimum(min_d, torch.sum((x_dom - x_i[None]) ** 2, -1))
        n = Linv.shape[0]
        new = torch.zeros((n + 1, n + 1), dtype=dtype, device=dev)
        new[:n, :n] = Linv
        new[n, :n] = -(l_ni[None, :] @ Linv)[0] / l_ii
        new[n, n] = 1.0 / l_ii
        Linv = new
        sel_x.append(x_i)
        sel_e.append(e_i)
    return worst, scored, picks
