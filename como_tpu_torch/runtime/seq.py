"""Sequential engine: tracking + mapping in one loop (port of
como_tpu/runtime/seq.py, frame_batch=1 and resolve_stride=1).

Each step (1) resolves the decisions of frames dispatched
`dispatch_depth` frames ago, feeding mapping, (2) refreshes the tracking
reference when needed, and (3) dispatches the current frame's tracking
plus one mapping GN iteration (while mapping has not converged).  The
dispatch enqueues CUDA work and starts a non-blocking copy of the frame's
decision stats; the host reads them only when that frame's decision is
resolved, one frame later at the default depth.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from como_tpu_torch.config import ComoConfig
from como_tpu_torch.odom.backend.gn_step import _gn_step_impl
from como_tpu_torch.odom.mapping import Mapping
from como_tpu_torch.odom.tracking import Tracking, host_value, track_frame
from como_tpu_torch.utils.io import save_traj
from como_tpu_torch.utils.log import EventLog


def fused_frame(levels, rgb, T_init, aff_init, T_w_kf, state, pairs_ref, pairs_tgt,
                pairs_valid, K_intr, term, start_level: int, end_level: int, img_hw,
                dims, sigmas, damping, color: str = "gray"):
    """Tracking of one frame + one mapping GN iteration (the work of the
    JAX package's _fused_frame_program; on the GPU both are enqueued on one
    stream back to back)."""
    Tji, aff, T_w_curr, stats = track_frame(levels, rgb, T_init, aff_init, T_w_kf,
                                            term, start_level, end_level, img_hw,
                                            color)
    new_state, gn_stats = _gn_step_impl(state, pairs_ref, pairs_tgt, pairs_valid,
                                        K_intr, dims, sigmas, damping)
    return Tji, aff, T_w_curr, stats, new_state, gn_stats


class ComoSeq:
    def __init__(self, cfg: ComoConfig, intrinsics, img_size, device="cuda"):
        if cfg.frame_batch != 1:
            raise NotImplementedError("frame_batch=2 is not ported yet")
        if cfg.resolve_stride != 1:
            raise NotImplementedError("resolve_stride > 1 is not ported yet")
        self.cfg = cfg
        self.device = torch.device(device)
        self.tracking = Tracking(cfg=cfg.tracking, intrinsics=intrinsics,
                                 img_size=tuple(img_size),
                                 decision_lag=cfg.dispatch_depth, device=device)
        self.mapping = Mapping(cfg.mapping, intrinsics, tuple(img_size), device=device)
        self.timestamps: List[float] = []
        self.est_poses: List = []
        self.ref_period = 0.25  # seconds of dataset time between refreshes
        self._last_ref_ts = -1e9
        self._pending: List = []
        self.decision_lag = cfg.dispatch_depth
        self._kf_promote = cfg.tracking.keyframing.kf_promote_latest
        self.log = EventLog()

    @property
    def log(self) -> EventLog:
        return self._log

    @log.setter
    def log(self, value: EventLog):
        self._log = value
        self.mapping.log = value

    def setup(self):
        self.log.emit("setup", name=self.cfg.name, img_size=list(self.cfg.img_size))
        self.tracking.setup()
        self.mapping.setup()

    def _to_device(self, rgb) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rgb) if not isinstance(rgb, torch.Tensor)
                               else rgb, dtype=torch.float32).to(self.device)

    def _resolve_one(self):
        """Decide + record the oldest dispatched frame."""
        m = self.mapping
        p = self._pending.pop(0)
        track_map = self.tracking.decide(p)
        self.timestamps.append(p["ts"])
        if p.get("lost"):
            self.est_poses.append(self.est_poses[-1] if self.est_poses
                                  else np.eye(4, dtype=np.float32))
        else:
            self.est_poses.append(p["T_w_curr"])
        kf_inserted = False
        if (track_map is not None and track_map[0] == "keyframe"
                and self._kf_promote and self._pending):
            track_map = self._promote_latest(track_map)
        if track_map is not None:
            kf_inserted = m.handle_tracking_data(track_map)
            self.log.emit("insert", frame_kind=track_map[0], ts=p["ts"],
                          num_kf=m.num_kf, num_ow=m.num_ow)
        return kf_inserted

    def _promote_latest(self, track_map):
        """Insert the NEWEST dispatched frame when a keyframe decision fires
        (cfg.tracking.keyframing.kf_promote_latest); keep the trigger frame
        if the newest one diverged."""
        q = self._pending[-1]
        if not np.all(np.isfinite(host_value(q, "stats"))):
            return track_map
        q["promoted_kf"] = True
        self.tracking.last_kf_sent_ts = q["ts"]
        return ("keyframe", q["rgb"], q["Tji"], q["aff"], q["kf_received_ts"], q["ts"])

    def _should_resolve(self) -> bool:
        return len(self._pending) >= self.decision_lag

    def step(self, timestamp: float, rgb):
        """Process one frame; returns the latest world pose estimate (a
        device tensor) or None before initialization."""
        m = self.mapping
        rgb = self._to_device(rgb)
        if not m.is_init:
            self._pending = []
            m.attempt_two_frame_init(timestamp, rgb)
            if m.is_init:
                pose = m.state.kf_pose[m.num_kf - 1].clone()
                self.timestamps.append(timestamp)
                self.est_poses.append(pose)
                self._refresh_reference(timestamp)
                return pose
            return None

        kf_inserted = False
        while self._should_resolve():
            kf_inserted |= self._resolve_one()
        if kf_inserted or (timestamp - self._last_ref_ts > self.ref_period):
            self._refresh_reference(timestamp)
        if m.should_iterate():
            self._pending.append(self._dispatch_fused(timestamp, rgb))
        else:
            self._pending.append(self.tracking.dispatch_frame(timestamp, rgb))
        return self._pending[-1]["T_w_curr"]

    def _dispatch_fused(self, timestamp, rgb):
        """Track this frame + one mapping GN step."""
        t, m = self.tracking, self.mapping
        T_init, T_before = t.init_pose()
        Tji, aff, T_w_curr, stats, new_state, gn_stats = fused_frame(
            t.levels, rgb, T_init, t.aff_curr_kf, t.T_w_kf, m.state, *m._pairs, m.K,
            t.term, t.cfg.pyr.start_level, t.cfg.pyr.end_level, tuple(t.img_size),
            m.dims, m.sigmas, m.damping, t.cfg.color)
        t._T_prev = T_before
        t.T_curr_kf, t.aff_curr_kf = Tji, aff
        m.state = new_state
        m.note_iteration(gn_stats)
        return t.pending_entry(timestamp, rgb, Tji, aff, T_w_curr, stats)

    def finish(self):
        """Resolve the remaining dispatched frames (stream end)."""
        if self.mapping.is_init:
            while self._pending:
                self._resolve_one()

    def _refresh_reference(self, timestamp):
        ref = self.mapping.get_kf_ref_data(self.cfg.mapping.track_ref_num_keyframes)
        self.tracking.update_kf_reference(ref)
        self._last_ref_ts = timestamp

    def run(self, dataset, max_frames: Optional[int] = None, verbose=False):
        n = len(dataset) if max_frames is None else min(len(dataset), max_frames)
        t0 = time.perf_counter()
        for i in range(n):
            ts, rgb = dataset[i]
            self.step(float(ts), rgb)
            if verbose and i % 30 == 0:
                dt = time.perf_counter() - t0
                print(f"frame {i}/{n}  ({(i + 1) / dt:.1f} FPS)")
        self.finish()
        return np.array(self.timestamps), self.poses_numpy()

    def poses_numpy(self) -> np.ndarray:
        if not self.est_poses:
            return np.zeros((0, 4, 4))
        return np.stack([p.detach().cpu().numpy() if isinstance(p, torch.Tensor)
                         else np.asarray(p) for p in self.est_poses])

    def save_trajectory(self, path: str):
        save_traj(path, self.timestamps, self.poses_numpy())
