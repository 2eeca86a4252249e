"""Viewer geometry builders (numpy; the port's own copy of
como_tpu/viz/geometry.py, which it does not import).

Role of the reference's como/utils/o3d.py converters: camera frustum and
trajectory line sets, surface normals from depth, point-cloud assembly,
and the smoothed camera-follow pose.  Pure numpy (consumed by either the
Open3D viewer or the headless snapshot renderer)."""

from __future__ import annotations

import numpy as np


def frustum_lineset(pose: np.ndarray, K: np.ndarray, img_size,
                    scale: float = 0.1):
    """(points (5,3), lines (8,2)) wireframe of a camera frustum."""
    h, w = img_size
    corners_px = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                          float)
    rays = np.stack([(corners_px[:, 0] - K[0, 2]) / K[0, 0],
                     (corners_px[:, 1] - K[1, 2]) / K[1, 1],
                     np.ones(4)], -1) * scale
    pts_c = np.concatenate([np.zeros((1, 3)), rays], 0)
    pts_w = pts_c @ pose[:3, :3].T + pose[:3, 3]
    lines = np.array([[0, 1], [0, 2], [0, 3], [0, 4],
                      [1, 2], [2, 3], [3, 4], [4, 1]])
    return pts_w, lines


def trajectory_lineset(poses: np.ndarray):
    """(points (N,3), lines (N-1,2)) polyline through camera centers."""
    pts = poses[:, :3, 3]
    n = len(pts)
    lines = np.stack([np.arange(n - 1), np.arange(1, n)], -1)
    return pts, lines


def normals_from_depth(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """(H, W, 3) unit surface normals from a depth image via tangent cross
    products (independent derivation of the reference's Scharr-cross
    normal estimate)."""
    H, W = depth.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (xs - K[0, 2]) / K[0, 0] * depth
    Y = (ys - K[1, 2]) / K[1, 1] * depth
    P = np.stack([X, Y, depth], -1)
    dx = np.zeros_like(P)
    dy = np.zeros_like(P)
    dx[:, 1:-1] = (P[:, 2:] - P[:, :-2]) * 0.5
    dy[1:-1, :] = (P[2:, :] - P[:-2, :]) * 0.5
    n = np.cross(dx, dy)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def keyframe_pointcloud(rgbs: np.ndarray, depths: np.ndarray,
                        poses: np.ndarray, K: np.ndarray, stride: int = 2,
                        cos_thresh: float = 0.0):
    """World point cloud (P (N,3), colors (N,3)) from KF RGB-D + poses,
    optionally dropping grazing-angle points (viewer-ray . normal)."""
    pts, cols = [], []
    H, W = depths.shape[-2:]
    ys, xs = np.mgrid[0:H:stride, 0:W:stride].astype(np.float64)
    for k in range(rgbs.shape[0]):
        z = depths[k, 0, ::stride, ::stride]
        rx = (xs - K[0, 2]) / K[0, 0]
        ry = (ys - K[1, 2]) / K[1, 1]
        P = np.stack([rx * z, ry * z, z], -1)
        keep = z > 1e-6
        if cos_thresh > 0:
            n = normals_from_depth(depths[k, 0], K)[::stride, ::stride]
            view = P / np.maximum(np.linalg.norm(P, axis=-1, keepdims=True),
                                  1e-12)
            keep &= np.abs((n * view).sum(-1)) > cos_thresh
        Pw = P[keep] @ poses[k, :3, :3].T + poses[k, :3, 3]
        pts.append(Pw)
        cols.append(rgbs[k, :, ::stride, ::stride].transpose(1, 2, 0)[keep])
    return np.concatenate(pts), np.concatenate(cols)


def follow_camera_pose(T_curr: np.ndarray, back: float = 0.8,
                       up: float = 0.25) -> np.ndarray:
    """Third-person viewer pose behind/above the current camera
    (reference o3d camera-follow)."""
    T = T_curr.copy()
    offset = T[:3, :3] @ np.array([0.0, -up, -back])
    T[:3, 3] = T[:3, 3] + offset
    return T
