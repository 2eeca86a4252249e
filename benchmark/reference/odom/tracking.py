"""Per-frame tracking against a keyframe reference, and the keyframe /
one-way decision: a frozen copy of the port's plain PyTorch
(como_tpu_torch/odom/tracking.py: build_reference, frame_stats,
track_frame; Tracking.decide as the function `decide`, with the tracker's
host state passed in and handed back)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.geometry import lie, transforms
from benchmark.reference.geometry.camera import backproject, project
from benchmark.reference.odom.frontend import tracking_kernels as tk
from benchmark.reference.ops import image as img_ops
from benchmark.reference.ops.coords import coord_grid_rc, fill_image
from benchmark.reference.ops.reduce import histogram_median


def build_reference(kf_rgb, kf_poses, depth, K, start_level: int, end_level: int,
                    depth_mode: str, color: str = "gray"):
    """Per-level TrackLevel data from B keyframes (points of all B moved into
    the last KF's frame; B=1 on the default config)."""
    B = kf_rgb.shape[0]
    img = img_ops.rgb_to_gray(kf_rgb) if color == "gray" else kf_rgb
    C = img.shape[1]
    img_pyr = img_ops.image_pyramid(img, start_level, end_level)
    depth_pyr = img_ops.depth_pyramid(depth, start_level, end_level, depth_mode)
    K_pyr = img_ops.intrinsics_pyramid(K, start_level, end_level)
    rel = lie.invert_se3(kf_poses[-1])[None] @ kf_poses

    levels = []
    for img_l, depth_l, K_l in zip(img_pyr, depth_pyr, K_pyr):
        h, w = img_l.shape[-2:]
        gx, gy = img_ops.image_gradients(img_l)
        rc = coord_grid_rc((h, w), dtype=img_l.dtype, device=img_l.device)
        xy = torch.stack([rc[:, 1], rc[:, 0]], -1)
        z = depth_l.reshape(B, -1)[..., None]
        P, _ = backproject(K_l, xy[None], z)                 # (B, N, 3)
        P_last, _, _ = transforms.transform_points(rel, P)
        p_all, _ = project(K_l, P_last)
        border = 50.0
        mask = ((p_all[..., 0] >= -border) & (p_all[..., 0] <= w - 1 + border)
                & (p_all[..., 1] >= -border) & (p_all[..., 1] <= h - 1 + border)
                & (P_last[..., 2] > 1e-4))
        vals = img_l.reshape(B, C, -1).transpose(0, 1)       # (C, B, N)
        grads = torch.stack([gx.reshape(B, C, -1), gy.reshape(B, C, -1)],
                            -1).transpose(0, 1)              # (C, B, N, 2)
        P_rep = P_last[None].expand((C, B) + P_last.shape[1:])
        mask_rep = mask[None].expand((C, B) + mask.shape[1:])
        J = tk.precalc_ic_jacobians(grads.reshape(C * B, -1, 2),
                                    P_rep.reshape(C * B, -1, 3), K_l)
        levels.append(tk.TrackLevel(
            vals=vals.reshape(-1), P=P_rep.reshape(-1, 3), J_ic=J.reshape(-1, 8),
            mask=mask_rep.reshape(-1), K=K_l))
    return levels


def frame_stats(P_full, mask_full, T_curr_kf, T_w_kf, K, img_hw):
    """Current world pose + the four decision scalars (coverage count,
    median reprojected depth, |t|, rotation angle w.r.t. the KF)."""
    P_curr, _, _ = transforms.transform_points(T_curr_kf[None], P_full[None])
    p, _ = project(K, P_curr)
    z = P_curr[0, :, 2]
    h, w = img_hw
    x, y = p[0, :, 0], p[0, :, 1]
    valid = (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1) & (z > 0.0) & mask_full
    coords_rc = torch.stack([y, x], -1)
    safe_rc = torch.where(valid[:, None], coords_rc, torch.full_like(coords_rc, -1.0))
    depth_img = fill_image(safe_rc, z, (h, w), default_val=float("nan"))
    filled = ~torch.isnan(depth_img)
    count = filled.sum().to(torch.float32)
    med = histogram_median(torch.where(filled, depth_img, torch.zeros_like(depth_img)),
                           filled)
    T_w_curr = transforms.get_T_w_curr(T_w_kf[None], T_curr_kf[None])[0]
    kf_dist = torch.linalg.norm(T_curr_kf[:3, 3])
    cos_th = 0.5 * (torch.trace(T_curr_kf[:3, :3]) - 1.0)
    rot = torch.arccos(torch.clamp(cos_th, -1.0, 1.0))
    return T_w_curr, torch.stack([count, med, kf_dist, rot])


def track_frame(levels, rgb, T_init, aff_init, T_w_kf, term, start_level: int,
                end_level: int, img_hw, color: str = "gray"):
    """Whole per-frame tracking: gray -> pyramid -> coarse-to-fine IC solve
    -> world pose + decision stats."""
    img = img_ops.rgb_to_gray(rgb) if color == "gray" else rgb
    C = img.shape[1]
    img_pyr = img_ops.image_pyramid(img, start_level, end_level)
    Tji, aff, _ = tk.track_pyramid(levels, img_pyr, T_init, aff_init, term)
    finest = levels[-1]
    npix = finest.vals.shape[0] // C
    T_w_curr, stats = frame_stats(finest.P[:npix], finest.mask[:npix], Tji,
                                  T_w_kf, finest.K, img_hw)
    return Tji, aff, T_w_curr, stats


def decide(stats, ts, kf_received_ts, num_kf_pixels, promoted, state: dict, kcfg):
    """The decision of one tracked frame from its stats (count, median
    depth, |t|, rotation angle): "keyframe", "one-way" or None, and the
    tracker's host state after it (med_ema, prev_motion, last_kf_sent_ts,
    num_one_way_since_kf, decision_lag).  `kcfg` is the keyframing config
    (a dict).  A lost frame (non-finite stats) returns None."""
    st = dict(state)
    if not np.all(np.isfinite(stats)):
        return None, st
    if promoted:
        st["prev_motion"] = None
        return None, st
    num_reproj = int(stats[0])
    median_depth = float(stats[1])
    kf_dist = float(stats[2])
    rot_angle = float(stats[3])
    if kcfg["stat_ema"] > 0.0:
        if st["med_ema"] is not None:
            median_depth = (kcfg["stat_ema"] * st["med_ema"]
                            + (1.0 - kcfg["stat_ema"]) * median_depth)
        st["med_ema"] = median_depth
    if kcfg["kf_rot_weight"] > 0.0:
        rot_motion = kcfg["kf_rot_weight"] * median_depth * rot_angle
        if kcfg["kf_rot_mode"] == "max":
            kf_dist = max(kf_dist, rot_motion)
        else:
            kf_dist = kf_dist + rot_motion
    anticipate = kcfg["kf_anticipate"]
    if anticipate < 0:
        anticipate = st["decision_lag"] if st["decision_lag"] <= 2 else 0
    if anticipate > 0:
        if st["prev_motion"] is not None:
            rate = max(0.0, kf_dist - st["prev_motion"])
            st["prev_motion"] = kf_dist
            kf_dist = kf_dist + anticipate * rate
        else:
            st["prev_motion"] = kf_dist

    kind = None
    if st["last_kf_sent_ts"] <= kf_received_ts:
        if (kf_dist > kcfg["kf_depth_motion_ratio"] * median_depth
                or kcfg["kf_num_pixels_frac"] > num_reproj / num_kf_pixels):
            kind = "keyframe"
            st["last_kf_sent_ts"] = ts
    if kind is None:
        extra = 1 if st["last_kf_sent_ts"] > kf_received_ts else 0
        thresh_scale = ((1.0 + st["num_one_way_since_kf"] + extra)
                        / (1.0 + kcfg["one_way_freq"]))
        dist_thresh = kcfg["kf_depth_motion_ratio"] * median_depth
        pixel_thresh = (1.0 - kcfg["kf_num_pixels_frac"]) * num_kf_pixels
        num_empty = num_kf_pixels - num_reproj
        if (kf_dist > thresh_scale * dist_thresh
                or num_empty > thresh_scale * pixel_thresh):
            kind = "one-way"
            st["num_one_way_since_kf"] += 1
    return kind, st
