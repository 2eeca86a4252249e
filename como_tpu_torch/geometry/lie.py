"""SE(3)/SO(3) Lie group operations on tensors (port of como_tpu/geometry/lie.py).

Tangent convention xi = [omega (3), v (3)], rotation first.  All ops are
batched over leading dims and safe at theta -> 0 via Taylor branches
(torch.where, no host branching).
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12


def skew(p: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    z = torch.zeros_like(p[..., 0])
    rows = [
        torch.stack([z, -p[..., 2], p[..., 1]], -1),
        torch.stack([p[..., 2], z, -p[..., 0]], -1),
        torch.stack([-p[..., 1], p[..., 0], z], -1),
    ]
    return torch.stack(rows, -2)


def _sinc_coeffs(theta2: torch.Tensor):
    """(sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor-safe at t=0."""
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS))
    return A, B, C


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) Rodrigues formula."""
    A, B, _ = _sinc_coeffs(torch.sum(omega * omega, -1))
    W = skew(omega)
    return _eye3(omega) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) [omega, v] -> (..., 4, 4)."""
    omega, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(omega * omega, -1)
    A, B, C = _sinc_coeffs(theta2)
    W = skew(omega)
    WW = W @ W
    I = _eye3(xi)
    R = I + A[..., None, None] * W + B[..., None, None] * WW
    V = I + B[..., None, None] * W + C[..., None, None] * WW
    t = (V @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., :, None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype,
                          device=xi.device).expand(xi.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], -2)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3); atan2 angle, Taylor factor below ~0.03 rad."""
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    sin_t = 0.5 * torch.sqrt(torch.sum(w * w, -1) + _EPS)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = 0.5 * (trace - 1.0)
    theta = torch.atan2(sin_t, cos_t)
    theta2 = theta * theta
    small = theta2 < 1e-3
    mag = torch.where(
        small,
        0.5 * (1.0 + theta2 / 6.0 + 7.0 * theta2 * theta2 / 360.0),
        theta / (2.0 * torch.where(small, torch.ones_like(sin_t), sin_t)))
    return mag[..., None] * w


def se3_log(T: torch.Tensor) -> torch.Tensor:
    omega = so3_log(T[..., :3, :3])
    theta2 = torch.sum(omega * omega, -1)
    t = T[..., :3, 3]
    W = skew(omega)
    WW = W @ W
    A, B, _ = _sinc_coeffs(theta2)
    small = theta2 < 1e-3
    coef = torch.where(small,
                       1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
                       (1.0 - A / (2.0 * B + _EPS)) / (theta2 + _EPS))
    Vinv = _eye3(T) - 0.5 * W + coef[..., None, None] * WW
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([omega, v], -1)


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = -(Rt @ T[..., :3, 3:4])[..., 0]
    top = torch.cat([Rt, t[..., :, None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype,
                          device=T.device).expand(T.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6, 6): [[R, 0], [t^ R, R]]."""
    R = T[..., :3, :3]
    tR = skew(T[..., :3, 3]) @ R
    Z = torch.zeros_like(R)
    return torch.cat([torch.cat([R, Z], -1), torch.cat([tR, R], -1)], -2)


def invert_se3_jac(T: torch.Tensor):
    """(T^-1, dT^-1/dT = -Adj(T))."""
    return invert_se3(T), -adjoint(T)


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    return T @ se3_exp(xi)


def normalize_rotation(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block via SVD (det kept at +1)."""
    R = T[..., :3, :3]
    U, _, Vh = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vh)
    S = torch.ones(T.shape[:-2] + (3,), dtype=T.dtype, device=T.device)
    S[..., 2] = det
    out = T.clone()
    out[..., :3, :3] = (U * S[..., None, :]) @ Vh
    return out


# ---------------------------------------------------------------------------
# numpy pose <-> (t, quaternion xyzw) for trajectory I/O


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(N, 3, 3) -> (N, 4) unit quaternions (x, y, z, w), w >= 0."""
    R = np.asarray(R, np.float64)
    tr = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    cand = np.stack([
        np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                  R[:, 1, 0] - R[:, 0, 1], 1.0 + tr], -1),
        np.stack([1.0 + 2 * R[:, 0, 0] - tr, R[:, 0, 1] + R[:, 1, 0],
                  R[:, 0, 2] + R[:, 2, 0], R[:, 2, 1] - R[:, 1, 2]], -1),
        np.stack([R[:, 0, 1] + R[:, 1, 0], 1.0 + 2 * R[:, 1, 1] - tr,
                  R[:, 1, 2] + R[:, 2, 1], R[:, 0, 2] - R[:, 2, 0]], -1),
        np.stack([R[:, 0, 2] + R[:, 2, 0], R[:, 1, 2] + R[:, 2, 1],
                  1.0 + 2 * R[:, 2, 2] - tr, R[:, 1, 0] - R[:, 0, 1]], -1),
    ], 1)                                                  # (N, 4 cases, 4)
    # pick the numerically largest pivot (Shepperd's method)
    piv = np.argmax(np.stack([tr, R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]], -1), -1)
    q = cand[np.arange(len(R)), piv]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.where(q[:, 3:4] < 0, -q, q)


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def pose_to_tq(pose: np.ndarray) -> np.ndarray:
    pose = np.asarray(pose)
    single = pose.ndim == 2
    P = pose[None] if single else pose
    tq = np.concatenate([P[:, :3, 3], _rot_to_quat(P[:, :3, :3])], 1)
    return tq[0] if single else tq


def tq_to_pose(tq: np.ndarray) -> np.ndarray:
    tq = np.asarray(tq)
    single = tq.ndim == 1
    tq2 = tq[None] if single else tq
    T = np.tile(np.eye(4), (tq2.shape[0], 1, 1))
    T[:, :3, :3] = _quat_to_rot(tq2[:, 3:])
    T[:, :3, 3] = tq2[:, :3]
    return T[0] if single else T
