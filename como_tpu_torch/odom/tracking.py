"""Tracking frontend state machine (port of como_tpu/odom/tracking.py).

Per-frame 6-DoF + affine tracking against the latest keyframe reference,
with keyframe / one-way decisions made on the host from one small stats
tensor per frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from como_tpu_torch.config import TrackingConfig
from como_tpu_torch.geometry import affine, lie, transforms
from como_tpu_torch.geometry.camera import backproject, project
from como_tpu_torch.odom.frontend import tracking_kernels as tk
from como_tpu_torch.ops import image as img_ops
from como_tpu_torch.ops.coords import coord_grid_rc, fill_image
from como_tpu_torch.ops.reduce import histogram_median


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


def predict_const_velocity(T_prev, T_curr):
    return T_curr @ (lie.invert_se3(T_prev) @ T_curr)


def rebase_to_new_kf(T_w_kf_old, T_curr_kf, aff_w_kf_old, aff_curr_kf,
                     new_pose, new_aff):
    """Re-express the current pose/affine against a new KF; non-finite
    inputs are replaced by identity on the device (no host check)."""
    T_w_f = transforms.get_T_w_curr(T_w_kf_old[None], T_curr_kf[None])[0]
    T_rel = transforms.get_rel_pose(T_w_f, new_pose)
    aff_w_f = affine.get_aff_w_curr(aff_w_kf_old[None, :, None], aff_curr_kf[None, :, None])
    aff_rel = affine.get_rel_aff(aff_w_f, new_aff[None, :, None])[0, :, 0]
    ok = torch.isfinite(T_rel).all() & torch.isfinite(aff_rel).all()
    T_rel = torch.where(ok, T_rel, torch.eye(4, dtype=T_rel.dtype, device=T_rel.device))
    aff_rel = torch.where(ok, aff_rel, torch.zeros_like(aff_rel))
    return T_rel, aff_rel


def _to_host_async(t: torch.Tensor):
    """Start a non-blocking device->host copy into pinned memory; returns
    (host tensor, event to wait on) or (t, None) for CPU tensors."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def host_value(pending: dict, key: str) -> np.ndarray:
    """The numpy value of pending[key], waiting for its prefetch if any."""
    pre = pending.get("_host", {}).get(key)
    if pre is None:
        return pending[key].detach().cpu().numpy()
    host, ev = pre
    if ev is not None:
        ev.synchronize()
    return host.numpy()


@dataclass
class Tracking:
    """Per-frame tracking state machine (host orchestration)."""
    cfg: TrackingConfig
    intrinsics: torch.Tensor
    img_size: tuple
    decision_lag: int = 0
    device: str = "cuda"

    mapping_init: bool = False
    use_motion_model: bool = False
    levels: Optional[List] = None
    T_curr_kf: Optional[torch.Tensor] = None
    aff_curr_kf: Optional[torch.Tensor] = None
    _T_prev: Optional[torch.Tensor] = None
    T_w_kf: Optional[torch.Tensor] = None
    aff_w_kf: Optional[torch.Tensor] = None
    kf_received_ts: float = -1.0
    last_kf_sent_ts: float = -1.0
    num_one_way_since_kf: int = 0
    _last_good: Optional[tuple] = None
    _med_ema: Optional[float] = None
    _prev_motion: Optional[float] = None

    def setup(self):
        self.device = torch.device(self.device)
        self.intrinsics = torch.as_tensor(self.intrinsics,
                                          dtype=torch.float32).to(self.device)
        self.use_motion_model = getattr(self.cfg, "use_motion_model", False)
        self.dtype = {"float32": torch.float32}[self.cfg.dtype]
        tc = self.cfg.term_criteria
        self.term = tk.TermStatic(max_iter=tc.max_iter, delta_norm=tc.delta_norm,
                                  rel_tol=tc.rel_tol, grad_norm=tc.grad_norm,
                                  abs_tol=tc.abs_tol,
                                  estimate_affine=self.cfg.estimate_affine)
        self._reset_rel_vars()

    def _reset_rel_vars(self):
        self.T_curr_kf = torch.eye(4, dtype=self.dtype, device=self.device)
        self.aff_curr_kf = torch.zeros((2,), dtype=self.dtype, device=self.device)

    # -- keyframe reference -------------------------------------------------
    def update_kf_reference(self, kf_data):
        """kf_data = (timestamps, rgb (B,3,H,W), pose (B,4,4), aff (B,2),
        depth (B,1,H,W)), latest last; tensors owned by the caller's copy."""
        timestamps, rgb, pose, aff, depth = kf_data
        new_ts = float(timestamps[-1])
        rebased = new_ts > self.kf_received_ts and self.mapping_init
        if rebased:
            self.T_curr_kf, self.aff_curr_kf = rebase_to_new_kf(
                self.T_w_kf, self.T_curr_kf, self.aff_w_kf, self.aff_curr_kf,
                pose[-1], aff[-1])
            self.num_one_way_since_kf = 0
            self._T_prev = None
            self._med_ema = None
            self._prev_motion = None
        elif not self.mapping_init:
            self.mapping_init = True
            self.last_kf_sent_ts = new_ts

        self.levels = build_reference(
            rgb, pose, depth, self.intrinsics, self.cfg.pyr.start_level,
            self.cfg.pyr.end_level, self.cfg.pyr.depth_interp_mode, self.cfg.color)
        self.kf_received_ts = new_ts
        self.T_w_kf = pose[-1]
        self.aff_w_kf = aff[-1]
        if rebased or self._last_good is None:
            self._last_good = (self.T_curr_kf, self.aff_curr_kf)

    # -- per-frame, dispatch + decide ----------------------------------------
    @staticmethod
    def prefetch_decision(pending: dict) -> dict:
        """Start non-blocking copies (into pinned host memory) of the
        tensors `decide` reads, so the read later finds them on the host."""
        pending["_host"] = {k: _to_host_async(pending[k])
                            for k in ("stats", "T_w_curr")}
        return pending

    def pending_entry(self, timestamp, rgb, Tji, aff, T_w_curr, stats) -> dict:
        C = 3 if self.cfg.color == "rgb" else 1
        return self.prefetch_decision(dict(
            ts=timestamp, rgb=rgb, Tji=Tji, aff=aff, T_w_curr=T_w_curr,
            stats=stats, kf_received_ts=self.kf_received_ts,
            num_kf_pixels=self.levels[-1].vals.shape[0] // C))

    def init_pose(self):
        """(T_init, T_before) for the next dispatched frame."""
        T_init = self.T_curr_kf
        if self.use_motion_model and self._T_prev is not None:
            T_init = predict_const_velocity(self._T_prev, self.T_curr_kf)
        return T_init, self.T_curr_kf

    def dispatch_frame(self, timestamp: float, rgb: torch.Tensor):
        T_init, T_before = self.init_pose()
        Tji, aff, T_w_curr, stats = track_frame(
            self.levels, rgb, T_init, self.aff_curr_kf, self.T_w_kf, self.term,
            self.cfg.pyr.start_level, self.cfg.pyr.end_level,
            tuple(self.img_size), self.cfg.color)
        self._T_prev = T_before
        self.T_curr_kf, self.aff_curr_kf = Tji, aff
        return self.pending_entry(timestamp, rgb, Tji, aff, T_w_curr, stats)

    def decide(self, pending):
        """Keyframe / one-way decision from a dispatched frame's stats."""
        stats = host_value(pending, "stats")
        if not np.all(np.isfinite(stats)):
            pending["lost"] = True
            if (self._last_good is not None
                    and bool(torch.isfinite(self._last_good[0]).all())):
                self.T_curr_kf, self.aff_curr_kf = self._last_good
            else:
                self._reset_rel_vars()
            self._T_prev = None
            return None
        self._last_good = (pending["Tji"], pending["aff"])
        if pending.get("promoted_kf"):
            self._prev_motion = None
            return None
        num_reproj = int(stats[0])
        median_depth = float(stats[1])
        kf_dist = float(stats[2])
        rot_angle = float(stats[3])
        num_kf_pixels = pending["num_kf_pixels"]
        timestamp = pending["ts"]

        kcfg = self.cfg.keyframing
        if kcfg.stat_ema > 0.0:
            if self._med_ema is not None:
                median_depth = (kcfg.stat_ema * self._med_ema
                                + (1.0 - kcfg.stat_ema) * median_depth)
            self._med_ema = median_depth
        if kcfg.kf_rot_weight > 0.0:
            rot_motion = kcfg.kf_rot_weight * median_depth * rot_angle
            if kcfg.kf_rot_mode == "max":
                kf_dist = max(kf_dist, rot_motion)
            else:
                kf_dist = kf_dist + rot_motion
        anticipate = kcfg.kf_anticipate
        if anticipate < 0:
            anticipate = self.decision_lag if self.decision_lag <= 2 else 0
        if anticipate > 0:
            if self._prev_motion is not None:
                rate = max(0.0, kf_dist - self._prev_motion)
                self._prev_motion = kf_dist
                kf_dist = kf_dist + anticipate * rate
            else:
                self._prev_motion = kf_dist

        frame_kind = None
        ref_ts = pending["kf_received_ts"]
        if self.last_kf_sent_ts <= ref_ts:
            if (kf_dist > kcfg.kf_depth_motion_ratio * median_depth
                    or kcfg.kf_num_pixels_frac > num_reproj / num_kf_pixels):
                frame_kind = "keyframe"
                self.last_kf_sent_ts = timestamp
        if frame_kind is None:
            extra = 1 if self.last_kf_sent_ts > ref_ts else 0
            thresh_scale = (1.0 + self.num_one_way_since_kf + extra) / (1.0 + kcfg.one_way_freq)
            dist_thresh = kcfg.kf_depth_motion_ratio * median_depth
            pixel_thresh = (1.0 - kcfg.kf_num_pixels_frac) * num_kf_pixels
            num_empty = num_kf_pixels - num_reproj
            if (kf_dist > thresh_scale * dist_thresh
                    or num_empty > thresh_scale * pixel_thresh):
                frame_kind = "one-way"
                self.num_one_way_since_kf += 1

        if frame_kind is None:
            return None
        return (frame_kind, pending["rgb"], pending["Tji"], pending["aff"],
                pending["kf_received_ts"], timestamp)
