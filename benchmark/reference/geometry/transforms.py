"""Rigid transforms of point sets with Jacobians (port of como_tpu/geometry/transforms.py)."""

from __future__ import annotations

import torch

from benchmark.reference.geometry.lie import invert_se3, skew


def get_T_w_curr(T_w_ref: torch.Tensor, T_curr_ref: torch.Tensor) -> torch.Tensor:
    return T_w_ref @ invert_se3(T_curr_ref)


def get_rel_pose(pose1: torch.Tensor, pose2: torch.Tensor) -> torch.Tensor:
    return invert_se3(pose1) @ pose2


def transform_points(Tji: torch.Tensor, Pi: torch.Tensor):
    """(B, 4, 4) on (B|1, N, 3) -> Pj (B, N, 3), dPj_dT (B, N, 3, 6), R (B, 1, 3, 3)."""
    R = Tji[:, None, :3, :3]
    t = Tji[:, None, :3, 3]
    Pj = (R @ Pi[..., None])[..., 0] + t
    shape = torch.broadcast_shapes(Pj.shape[:-1])
    dPj_dT = torch.cat([-(R @ skew(Pi)), R.expand(shape + (3, 3))], -1)
    return Pj, dPj_dT, R
