"""Trajectory I/O + ATE evaluation (port of como_tpu/utils/io.py).

TUM-format trajectory writer and reader, and the scale-aligned ATE RMSE
(Horn/Umeyama alignment).  numpy only.
"""

from __future__ import annotations

import numpy as np

from como_tpu_torch.geometry.lie import pose_to_tq, tq_to_pose


def save_traj(filename: str, timestamps, poses: np.ndarray) -> None:
    """TUM format: 'ts tx ty tz qx qy qz qw' per line."""
    with open(filename, "w") as f:
        for ts, T in zip(timestamps, poses):
            tq = pose_to_tq(np.asarray(T))
            f.write("%.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f\n" % (ts, *tq))


def load_traj(filename: str):
    """(timestamps (n,), poses (n, 4, 4)) of a TUM trajectory file (a file
    of one line too)."""
    data = np.loadtxt(filename, ndmin=2)
    return data[:, 0], tq_to_pose(data[:, 1:8])


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """(s, R, t) with dst ~ s R src + t for (N, 3) point sets."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(S) @ D) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             with_scale: bool = True) -> float:
    """ATE RMSE after similarity alignment (monocular: scale-aligned)."""
    p_est = est_poses[:, :3, 3]
    p_gt = gt_poses[:, :3, 3]
    s, R, t = umeyama_align(p_est, p_gt, with_scale)
    aligned = (s * (R @ p_est.T)).T + t
    err = aligned - p_gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
