"""Optional factors completing reference parity (port of
como_tpu/odom/backend/extra_factors.py): pose-pose range factor and dense
log-depth prior.

Both are dead code in the reference (factors/range_factor.py and
factors/depth_prior.py:145-210, never imported by any runtime path); they
are library factors for a user porting a reference-derived experiment.
Conventions match gn_step: right-multiplied body-frame se(3) tangent
[omega, v] (pose retraction T <- T @ exp(delta)), factored GP chain
(logzn = W @ logzm, dlogzn/dTwc = q).  Plain functions on tensors; they run
on the device of their inputs.
"""

from __future__ import annotations

import torch

from como_tpu_torch.geometry import lie


def pose_range_factor(range_meas, pose1, pose2, sigma):
    """Range measurement between camera centers (reference
    range_factor.pose_point_range / pose_range_factor).

    pose1, pose2: (B, 4, 4) world poses.  Returns (r_wh (B,), J1 (B, 6),
    J2 (B, 6), err): the whitened residual and its Jacobians wrt the right
    tangents of pose1 / pose2; the caller scatters J^T J / J^T r into its
    system.
    """
    info_sqrt = 1.0 / sigma
    T1_inv = lie.invert_se3(pose1)
    t2 = pose2[:, :3, 3]
    # t12: pose2's center in pose1's body frame
    t12 = torch.einsum("bij,bj->bi", T1_inv[:, :3, :3], t2) + T1_inv[:, :3, 3]
    rng = torch.linalg.norm(t12, dim=-1)
    r = -(range_meas - rng)

    dr_dt12 = t12 / torch.clamp(rng, min=1e-12)[:, None]       # (B, 3)
    # right-tangent of pose1: d t12 = [t12]_x omega1 - v1
    eye = torch.eye(3, dtype=pose1.dtype, device=pose1.device)
    dt12_dT1 = torch.cat([lie.skew(t12), -eye.expand(t12.shape[0], 3, 3)], dim=-1)
    # right-tangent of pose2: d t2_w = R2 (v2 - [t2_b]_x omega2) with
    # t2_b = 0 at the center => d t12 = R1^-1 R2 v2
    R12 = T1_inv[:, :3, :3] @ pose2[:, :3, :3]
    J1 = info_sqrt * torch.einsum("bi,bij->bj", dr_dt12, dt12_dT1)   # (B, 6)
    J2_v = info_sqrt * torch.einsum("bi,bij->bj", dr_dt12, R12)
    J2 = torch.cat([torch.zeros_like(J2_v), J2_v], dim=-1)
    r_wh = info_sqrt * r
    return r_wh, J1, J2, torch.sum(r_wh ** 2)


def dense_depth_prior(logzn, logz_mean, W_nm, q_n, inv_zm, dz_dPw, sigma):
    """Dense log-depth prior (reference depth_prior.dense_depth_prior):
    pins the GP-predicted dense log-depths of one keyframe to a target.

    logzn (N,) predicted dense log-depths; logz_mean target (scalar or
    (N,)); W_nm (N, M) GP prediction weights; q_n (N, 6) dlogzn/dTwc;
    inv_zm (M,) 1/z at anchors; dz_dPw (3,) the per-frame constant dz/dP
    row.  Returns anchor-space contributions in gn_step's factored layout:
    dict(H_zm (M, M), H_pose (6, 6), H_pose_zm (6, M), g_zm (M,),
    g_pose (6,), err, dz_dPw); the H_lm expansion is the caller's job.
    """
    info = 1.0 / (sigma ** 2)
    r = logzn - logz_mean                                   # (N,)
    # dr/dlogzm = W_nm; dlogzm/d(anchor z) = diag(1/zm)
    A = W_nm * inv_zm[None, :]                              # (N, M) dr/dzm
    H_zm = info * (A.T @ A)
    H_pose = info * (q_n.T @ q_n)
    H_pose_zm = info * (q_n.T @ A)
    g_zm = -info * (A.T @ r)
    g_pose = -info * (q_n.T @ r)
    err = info * torch.sum(r ** 2)
    return dict(H_zm=H_zm, H_pose=H_pose, H_pose_zm=H_pose_zm,
                g_zm=g_zm, g_pose=g_pose, err=err, dz_dPw=dz_dPw)
