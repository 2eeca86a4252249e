"""Sequential engine: tracking + mapping in one loop (port of
como_tpu/runtime/seq.py).

Each step (1) resolves the decisions of frames dispatched
`dispatch_depth` frames ago, feeding mapping, (2) refreshes the tracking
reference when needed, and (3) dispatches the current frame's tracking
plus one mapping GN iteration (while mapping has not converged).  The
dispatch enqueues CUDA work and starts a non-blocking copy of the frame's
decision stats; the host reads them only when that frame's decision is
resolved, one frame later at the default depth.

Three options change when decisions land, and nothing else on one GPU
(eager PyTorch launches the same kernels either way):
- `resolve_stride > 1` resolves decisions in bursts of `stride` frames, at
  the fixed depths [dispatch_depth, dispatch_depth + stride - 1];
- `frame_batch: 2` stashes every other frame and dispatches frames in
  pairs (`fused_pair`), the second seeded from the first's pose, with two
  GN iterations per pair; decisions resolve in pair units;
- stage specs with different indices (`tracking.device`, `mapping.device`,
  see runtime/placement.py) put `Tracking` and `Mapping` on their own
  devices: frames, `track_map` messages and references cross through
  `tree_device_put`, and tracking and the GN iteration are dispatched
  separately.  On one device the separate dispatches enqueue the same
  kernels in the same order as the fused one.
`mapping.mesh_devices >= 2` splits every GN step's pairs over a mesh
(parallel/sharded.py): both stages then run on the engine's default
device, the step is dispatched unfused, and `frame_batch: 2` falls back to
single frames, as in the JAX package.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from como_tpu_torch.config import ComoConfig
from como_tpu_torch.odom.backend.gn_step import _gn_step_impl
from como_tpu_torch.odom.mapping import Mapping
from como_tpu_torch.odom.tracking import (Tracking, host_value,
                                          predict_const_velocity, track_frame)
from como_tpu_torch.runtime.placement import (device_scope, resolve_device,
                                              resolve_stage_devices, spec_index,
                                              tree_device_put)
from como_tpu_torch.utils.io import save_traj
from como_tpu_torch.utils.log import EventLog
from como_tpu_torch.utils.profiling import RECORDER


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


def fused_pair(levels, rgb_a, rgb_b, T_init, aff_init, T_prev, T_w_kf, do_gn: bool,
               state, pairs_ref, pairs_tgt, pairs_valid, K_intr, term,
               start_level: int, end_level: int, img_hw, dims, sigmas, damping,
               color: str = "gray", motion: bool = False):
    """Two consecutive frames tracked + (do_gn) two mapping GN iterations
    (cfg.frame_batch = 2; the work of the JAX package's
    _fused_pair_program).  Frame b is seeded from frame a's pose on the
    device (const-velocity extrapolated from T_prev when the motion model
    is on) against the same keyframe reference.  Returns (out_a, out_b,
    state, gn_stats) with out_* = (Tji, aff, T_w_curr, stats) and gn_stats
    a pair of GNStats, or () when do_gn is false."""
    def _track(rgb, Ti, ai):
        return track_frame(levels, rgb, Ti, ai, T_w_kf, term, start_level, end_level,
                           img_hw, color)

    out_a = _track(rgb_a, T_init, aff_init)
    Tji_a, aff_a = out_a[0], out_a[1]
    seed_b = predict_const_velocity(T_prev, Tji_a) if motion else Tji_a
    out_b = _track(rgb_b, seed_b, aff_a)
    gn_stats = ()
    if do_gn:
        state, s1 = _gn_step_impl(state, pairs_ref, pairs_tgt, pairs_valid, K_intr,
                                  dims, sigmas, damping)
        state, s2 = _gn_step_impl(state, pairs_ref, pairs_tgt, pairs_valid, K_intr,
                                  dims, sigmas, damping)
        gn_stats = (s1, s2)
    return out_a, out_b, state, gn_stats


def frame_tensor(rgb, device) -> torch.Tensor:
    """A frame (tensor or array, (1, 3, H, W)) as an f32 tensor on `device`."""
    if not isinstance(rgb, torch.Tensor):
        rgb = torch.as_tensor(np.asarray(rgb))
    return rgb.to(device=device, dtype=torch.float32)


class ComoSeq:
    def __init__(self, cfg: ComoConfig, intrinsics, img_size, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        # stage -> device placement: the specs' indices on the engine's
        # device type.  Different indices split the per-frame dispatch,
        # even where both resolve to one device (a one-GPU host).
        self.track_dev, self.map_dev = resolve_stage_devices(
            cfg.tracking.device, cfg.mapping.device, device)
        self.split_devices = (spec_index(cfg.tracking.device)
                              != spec_index(cfg.mapping.device))
        if cfg.mapping.mesh_devices >= 2:
            # multi-device BA: both stages on the engine's default device
            # (the mesh's first), the GN step split over the mesh
            self.track_dev = self.map_dev = resolve_device(None, device)
            self.split_devices = False
        with device_scope(self.track_dev):
            self.tracking = Tracking(cfg=cfg.tracking, intrinsics=intrinsics,
                                     img_size=tuple(img_size),
                                     decision_lag=cfg.dispatch_depth,
                                     device=self.track_dev)
        with device_scope(self.map_dev):
            self.mapping = Mapping(cfg.mapping, intrinsics, tuple(img_size),
                                   device=self.map_dev)
        self.timestamps: List[float] = []
        self.est_poses: List = []
        self.viz_listener = None   # called with get_kf_viz_data() at each refresh
        self.ref_period = 0.25  # seconds of dataset time between refreshes
        self._last_ref_ts = -1e9
        self._pending: List = []
        self.decision_lag = cfg.dispatch_depth
        self.resolve_stride = cfg.resolve_stride
        self._draining = False
        self.frame_batch = cfg.frame_batch
        self._stash = None
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
        with device_scope(self.track_dev):
            self.tracking.setup()
        with device_scope(self.map_dev):
            self.mapping.setup()

    def _resolve_one(self):
        """Decide + record the oldest dispatched frame."""
        with RECORDER.span("runtime.resolve"):
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
                with device_scope(self.map_dev):
                    track_map = tree_device_put(track_map, self.map_dev)
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
        n = len(self._pending)
        if self.resolve_stride > 1:
            # burst mode: once `stride` frames are pending past the decision
            # lag, drain all of them.  Frames thus resolve at the fixed
            # depths [lag, lag + stride - 1]: deterministic, no readiness
            # checks.
            if n >= self.decision_lag + self.resolve_stride - 1:
                self._draining = True
            if self._draining and n >= self.decision_lag:
                return True
            self._draining = False
            return False
        return n >= self.decision_lag

    def step(self, timestamp: float, rgb):
        """Process one frame; returns the latest world pose estimate (a
        device tensor) or None before initialization."""
        with RECORDER.span("runtime.step", frame=timestamp):
            m = self.mapping
            if not m.is_init:
                self._pending = []
                self._stash = None
                with device_scope(self.map_dev):
                    m.attempt_two_frame_init(timestamp, frame_tensor(rgb, self.map_dev))
                if m.is_init:
                    pose = m.state.kf_pose[m.num_kf - 1].clone()
                    self.timestamps.append(timestamp)
                    self.est_poses.append(pose)
                    self._refresh_reference(timestamp)
                    return pose
                return None

            rgb = frame_tensor(rgb, self.track_dev)
            if self.frame_batch == 2 and not self.split_devices and not m.uses_mesh:
                return self._step_batched(timestamp, rgb)

            kf_inserted = False
            while self._should_resolve():
                kf_inserted |= self._resolve_one()
            if kf_inserted or (timestamp - self._last_ref_ts > self.ref_period):
                self._refresh_reference(timestamp)

            if self.split_devices or m.uses_mesh:
                # two dispatches: tracking on its device, then the GN iteration
                # on mapping's (the reference's cuda:0 / cuda:1 mode) or split
                # over the mesh (mapping.mesh_devices)
                with device_scope(self.track_dev):
                    self._pending.append(self.tracking.dispatch_frame(timestamp, rgb))
                with device_scope(self.map_dev):
                    m.maybe_iterate()
            elif m.should_iterate():
                self._pending.append(self._dispatch_fused(timestamp, rgb))
            else:
                self._pending.append(self.tracking.dispatch_frame(timestamp, rgb))
            return self._pending[-1]["T_w_curr"]

    def _step_batched(self, timestamp, rgb):
        """frame_batch = 2: stash the first frame of each pair; on its
        partner, resolve the due pairs, refresh the reference and dispatch
        both frames together.  Decisions resolve in pair units at the fixed
        depths {lag, lag + 1}: deterministic."""
        if self._stash is None:
            self._stash = (timestamp, rgb)
            # the pair containing this frame has not been dispatched yet:
            # report the newest available estimate (est_poses / timestamps
            # are appended at resolution, so the trajectory is unaffected)
            return self._pending[-1]["T_w_curr"] if self._pending else None
        kf_inserted = False
        while len(self._pending) >= 2 * max(1, self.decision_lag // 2):
            kf_inserted |= self._resolve_one()
            kf_inserted |= self._resolve_one()
        if kf_inserted or (timestamp - self._last_ref_ts > self.ref_period):
            self._refresh_reference(timestamp)
        ts_a, rgb_a = self._stash
        self._stash = None
        pa, pb = self._dispatch_pair(ts_a, rgb_a, timestamp, rgb)
        self._pending.append(pa)
        self._pending.append(pb)
        return pb["T_w_curr"]

    def _dispatch_pair(self, ts_a, rgb_a, ts_b, rgb_b):
        """Track two consecutive frames + (unless mapping converged) two
        mapping GN steps."""
        with RECORDER.span("runtime.dispatch_pair"):
            t, m = self.tracking, self.mapping
            do_gn = m.should_iterate()
            motion = bool(t.use_motion_model and t._T_prev is not None)
            T_init, T_before = t.init_pose()
            out_a, out_b, new_state, gn_stats = fused_pair(
                t.levels, rgb_a, rgb_b, T_init, t.aff_curr_kf, T_before, t.T_w_kf, do_gn,
                m.state, *m._pairs, m.K, t.term, t.cfg.pyr.start_level,
                t.cfg.pyr.end_level, tuple(t.img_size), m.dims, m.sigmas, m.damping,
                t.cfg.color, motion)
            Tji_a, aff_a, Tw_a, stats_a = out_a
            Tji_b, aff_b, Tw_b, stats_b = out_b
            t._T_prev = Tji_a  # the frame before the tracker's new current (= b)
            t.T_curr_kf, t.aff_curr_kf = Tji_b, aff_b
            m.state = new_state
            for s in gn_stats:
                m.note_iteration(s)
            return (t.pending_entry(ts_a, rgb_a, Tji_a, aff_a, Tw_a, stats_a),
                    t.pending_entry(ts_b, rgb_b, Tji_b, aff_b, Tw_b, stats_b))

    def _dispatch_fused(self, timestamp, rgb):
        """Track this frame + one mapping GN step."""
        with RECORDER.span("runtime.dispatch_fused"):
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
            if self._stash is not None:
                # odd frame count under frame_batch = 2: the last frame has
                # no partner.  Pair it with ITSELF and drop the duplicate's
                # pending entry (its decision would re-insert the same
                # frame), as the JAX package does; the pair still moves the
                # tracker and runs its two GN steps.
                ts_a, rgb_a = self._stash
                self._stash = None
                pa, _ = self._dispatch_pair(ts_a, rgb_a, ts_a, rgb_a)
                self._pending.append(pa)
            while self._pending:
                self._resolve_one()

    def _refresh_reference(self, timestamp):
        with RECORDER.span("runtime.refresh_reference"):
            m = self.mapping
            with device_scope(self.map_dev):
                ref = m.get_kf_ref_data(self.cfg.mapping.track_ref_num_keyframes)
            with device_scope(self.track_dev):
                self.tracking.update_kf_reference(tree_device_put(ref, self.track_dev))
            self._last_ref_ts = timestamp
            if self.viz_listener is not None:
                self.viz_listener(m.get_kf_viz_data())

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
        return poses_numpy(self.est_poses)

    def save_trajectory(self, path: str):
        save_traj(path, self.timestamps, self.poses_numpy())


def poses_numpy(est_poses) -> np.ndarray:
    """(n, 4, 4) array of a list of poses (tensors or arrays)."""
    if not est_poses:
        return np.zeros((0, 4, 4))
    return np.stack([p.detach().cpu().numpy() if isinstance(p, torch.Tensor)
                     else np.asarray(p) for p in est_poses])
