"""Greedy conditional-entropy inducing-point selection (port of
como_tpu/gp/sampler.py).

Up to S anchor sites are picked by repeatedly taking the site with the
largest GP posterior stdev (with a min-distance NMS), followed by a rank-1
incremental Cholesky update and a downdate of the whole domain's posterior
variance.  Static shapes throughout: pre-existing anchors are a packed
prefix of the S slots consumed by the same update; early termination and
NMS are masks.

The JAX `lax.fori_loop` over the S slots is a Python loop of exactly S
iterations here; the chosen site, the stop flag and every per-iteration
scalar stay on the device (argmax, matvecs, torch.where), so the loop never
reads a value back to the host.  The per-iteration domain pass is
gp/sampler_cuda.py::downdate_step: the hand-written kernel on CUDA for
every domain size (the TPU kernel's size gate existed for tile alignment
and is gone), the plain twin on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from como_tpu_torch.gp import kernels
from como_tpu_torch.gp.sampler_cuda import downdate_step


class SamplerResult(NamedTuple):
    coords_norm: torch.Tensor   # (S, 2) selected site coords (normalized)
    covs: torch.Tensor          # (S, 3) packed covariances at selected sites
    domain_inds: torch.Tensor   # (S,) int64; -1 for existing anchors / unused
    valid: torch.Tensor         # (S,) bool slot validity
    is_new: torch.Tensor        # (S,) bool freshly sampled


def greedy_entropy_sample(domain_norm, e_domain, domain_valid, curr_norm,
                          curr_e, curr_valid, curr_var, signal_var: float,
                          fixed_var: float = 0.0,
                          max_stdev_thresh: float = -1e8,
                          dist_thresh: float = 0.0, num_slots: int = 64,
                          terminate_early: bool = False) -> SamplerResult:
    return greedy_entropy_loop(
        domain_norm, e_domain, domain_valid, curr_norm, curr_e, curr_valid,
        curr_var, signal_var, fixed_var, max_stdev_thresh, dist_thresh,
        num_slots, terminate_early)[0]


def greedy_entropy_loop(domain_norm, e_domain, domain_valid, curr_norm, curr_e,
                        curr_valid, curr_var, signal_var: float,
                        fixed_var: float = 0.0, max_stdev_thresh: float = -1e8,
                        dist_thresh: float = 0.0, num_slots: int = 64,
                        terminate_early: bool = False, downdate=downdate_step):
    """greedy_entropy_sample that also returns the loop's final
    (obs_info, var, min_dist_sq); `downdate` is the per-iteration domain
    pass (chip_smoke.py passes sampler_cuda.downdate_step_plain to hold the
    kernel against it)."""
    D = domain_norm.shape[0]
    S = num_slots
    dtype, dev = domain_norm.dtype, domain_norm.device
    signal_var = float(signal_var)
    xnT = domain_norm.T.contiguous()          # (2, D), once per call
    enT = e_domain.T.contiguous()             # (3, D)
    det_domain = e_domain[..., 0] * e_domain[..., 1] - e_domain[..., 2] ** 2
    dist_thresh_sq = dist_thresh * dist_thresh
    any_existing = torch.any(curr_valid)
    dvalid = domain_valid.to(dtype)

    # L^-1 maintained incrementally: appending [l_ni, l_ii] to L appends
    # [-(l_ni^T Linv)/l_ii, 1/l_ii] to Linv
    Linv = torch.eye(S, dtype=dtype, device=dev)
    obs_info = torch.zeros((S, D), dtype=dtype, device=dev)
    var = torch.full((D,), signal_var, dtype=dtype, device=dev)
    min_dist_sq = torch.full((D,), float("inf"), dtype=dtype, device=dev)
    sel_x = torch.zeros((S, 2), dtype=dtype, device=dev)
    sel_e = torch.zeros((S, 3), dtype=dtype, device=dev)
    sel_ind = torch.full((S,), -1, dtype=torch.int64, device=dev)
    sel_valid = torch.zeros((S,), dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    minus1 = torch.full((), -1, dtype=torch.int64, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    scale_t = torch.full((1,), signal_var, dtype=dtype, device=dev)

    for i in range(S):
        existing_i = curr_valid[i]
        # -- candidate scoring (posterior stdev + NMS) -------------------
        stdev = torch.sqrt(torch.clamp(var, min=0.0)) + 1e-10
        nms_ok = (min_dist_sq > dist_thresh_sq).to(dtype)
        cost = stdev * nms_ok * dvalid
        if i == 0:
            # no anchors yet: stdev is flat -> widest kernel (max det)
            cost = torch.where(any_existing, cost, det_domain * dvalid)
        best = torch.argmax(cost)
        max_stdev = stdev[best]
        if terminate_early:
            done = done | (~existing_i & (max_stdev < max_stdev_thresh))
        done = done | (~existing_i & (cost[best] <= 0.0))
        select_i = existing_i | ~done

        # -- chosen site ---------------------------------------------------
        x_i = torch.where(existing_i, curr_norm[i], domain_norm[best])
        e_i = torch.where(existing_i, curr_e[i], e_domain[best])
        k_ii = signal_var + fixed_var + torch.where(existing_i, curr_var[i],
                                                    torch.zeros_like(curr_var[i]))
        ind_i = torch.where(existing_i, minus1, torch.where(select_i, best, minus1))

        # -- rank-1 incremental Cholesky + variance downdate ---------------
        k_ni = kernels.cross_covariance(x_i[None], e_i[None], sel_x, sel_e,
                                        signal_var)[0]
        k_ni = k_ni * sel_valid.to(dtype)
        l_ni = (Linv @ k_ni[:, None])[:, 0]
        l_ii = torch.sqrt(torch.clamp(k_ii - torch.sum(l_ni * l_ni), min=1e-12))
        sel = select_i.to(dtype)
        sc = torch.cat([x_i, e_i, (1.0 / l_ii)[None], sel[None], scale_t])
        downdate(xnT, enT, obs_info, var, min_dist_sq, sc, l_ni.contiguous(), i)

        linv_row = -(l_ni[None, :] @ Linv)[0] / l_ii
        Linv[i, :] = linv_row * sel
        Linv[i, i] = torch.where(select_i, 1.0 / l_ii, one)
        sel_x[i] = x_i * sel
        sel_e[i] = e_i * sel
        sel_ind[i] = ind_i
        sel_valid[i] = select_i

    is_new = sel_valid & (sel_ind >= 0)
    return SamplerResult(coords_norm=sel_x, covs=sel_e, domain_inds=sel_ind,
                         valid=sel_valid, is_new=is_new), obs_info, var, min_dist_sq


def full_image_domain(cov_img: torch.Tensor, border: int = 0):
    """Domain arrays of a packed (3, H, W) covariance image: normalized
    coords, packed covs, border-validity mask, rc coords."""
    from como_tpu_torch.ops.coords import coord_grid_rc, normalize_coords

    H, W = cov_img.shape[-2:]
    rc = coord_grid_rc((H, W), dtype=cov_img.dtype, device=cov_img.device)
    norm = normalize_coords(rc, [H, W])
    e = cov_img.reshape(3, H * W).T
    r, c = rc[:, 0], rc[:, 1]
    valid = (r >= border) & (r < H - border) & (c >= border) & (c < W - border)
    return norm, e, valid, rc
