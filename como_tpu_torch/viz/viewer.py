"""Optional viewers fed by the engine's viz data (port of
como_tpu/viz/viewer.py).

Role-equivalent of the reference GUI (como/gui/GuiWindow.py: an Open3D
window with a control panel and scene elements: keyframe frustums,
one-way frustums, sparse landmark spheres, dense point cloud, trajectory,
camera follow), but as an *observer*: the core loop is headless; viewers
attach via `engine.viz_listener`, which the engine calls with
`Mapping.get_kf_viz_data()` (tensors on the mapping device, cloned out of
the window).  Two backends:
  * Open3DViewer: interactive window with pause / step / follow /
    save-trajectory controls (keyboard, VisualizerWithKeyCallback),
  * SnapshotViewer: headless fallback, writes PNG frames (the map rendered
    on the device by viz/renderer.py, with a trajectory / landmark overlay
    drawn on the host).

Scene assembly is backend-agnostic numpy (`build_scene`), testable without
open3d.  Device tensors are copied to the host once per refresh
(`viz_to_host`).
"""

from __future__ import annotations

import os
import sys
import time
import traceback

import numpy as np
import torch

from como_tpu_torch.viz.geometry import (follow_camera_pose, frustum_lineset,
                                         keyframe_pointcloud, trajectory_lineset)
from como_tpu_torch.viz.png import write_png


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def viz_to_host(viz: dict) -> dict:
    """The viz data with every tensor copied to a numpy array."""
    return {k: _host(v) for k, v in viz.items()}


def build_scene(viz, K, img_size, frustum_scale: float = 0.08,
                pcd_stride: int = 2):
    """Everything the reference GUI draws, as plain numpy (host data, see
    viz_to_host): dense point cloud, per-KF frustums, one-way frustums,
    trajectory polyline, valid landmark positions, follow-camera pose."""
    K = np.asarray(K)
    poses = np.asarray(viz["poses"])
    rgbs = np.asarray(viz["rgbs"])
    depths = np.asarray(viz["depths"])
    pts, cols = keyframe_pointcloud(rgbs, depths, poses, K, stride=pcd_stride)
    kf_frustums = [frustum_lineset(poses[k], K, img_size, frustum_scale)
                   for k in range(poses.shape[0])]
    ow_poses = np.asarray(viz.get("ow_poses", np.zeros((0, 4, 4))))
    ow_frustums = [frustum_lineset(ow_poses[r], K, img_size,
                                   0.6 * frustum_scale)
                   for r in range(ow_poses.shape[0])]
    traj = trajectory_lineset(poses) if poses.shape[0] >= 2 else None
    lm = np.asarray(viz["P_lm"])[np.asarray(viz["lm_valid"])] \
        if "P_lm" in viz else np.zeros((0, 3))
    return dict(pcd_points=pts, pcd_colors=cols, kf_frustums=kf_frustums,
                ow_frustums=ow_frustums, trajectory=traj, landmarks=lm,
                follow_pose=follow_camera_pose(poses[-1]))


def _project_points(Pw, T_view, K, img_size):
    """World points -> pixel coords + in-front mask under a viewer pose."""
    H, W = img_size
    Tinv = np.linalg.inv(T_view)
    Pc = Pw @ Tinv[:3, :3].T + Tinv[:3, 3]
    z = Pc[:, 2]
    zs = np.where(z > 1e-6, z, 1.0)
    u = K[0, 0] * Pc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * Pc[:, 1] / zs + K[1, 2]
    ok = (z > 1e-6) & (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
    return u, v, ok


def _draw_segment(img, u0, v0, u1, v1, color):
    n = int(max(abs(u1 - u0), abs(v1 - v0), 1)) + 1
    us = np.linspace(u0, u1, n).astype(int)
    vs = np.linspace(v0, v1, n).astype(int)
    img[vs, us] = color


class SnapshotViewer:
    """Writes map_NNNNN.png into out_dir at most every period_s seconds.
    A snapshot that fails is reported and counted in `failures`; it never
    stops the engine."""

    def __init__(self, engine, out_dir: str = "results/viz",
                 period_s: float = 1.0, follow: bool = True):
        self.engine = engine
        self.out_dir = out_dir
        self.period_s = period_s
        self.follow = follow
        self._last = 0.0
        self._count = 0
        self.failures = 0
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, viz):
        now = time.monotonic()
        if now - self._last < self.period_s:
            return
        self._last = now
        try:
            self._snapshot(viz)
        except Exception:  # noqa: BLE001  (viz must never take down the engine)
            self.failures += 1
            print("[viz] snapshot failed:", file=sys.stderr)
            traceback.print_exc()

    def _snapshot(self, viz):
        from como_tpu_torch.geometry.lie import se3_exp
        from como_tpu_torch.viz.renderer import render_map

        poses = viz["poses"]
        dev = poses.device if isinstance(poses, torch.Tensor) else torch.device("cpu")

        def f32(a):
            return torch.as_tensor(a).to(dtype=torch.float32, device=dev)

        poses_t = f32(poses)
        n = poses_t.shape[0]
        K = self.engine.mapping.K
        # virtual camera: behind and above the latest keyframe
        offset = se3_exp(f32([0.25, 0.0, 0.0, 0.0, -0.15, -0.8]))
        T_view_t = poses_t[-1] @ offset if self.follow else torch.eye(4, device=dev)
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
        rgb, _ = render_map(f32(viz["rgbs"]), f32(viz["depths"]), poses_t, valid, f32(K),
                            T_view_t)
        img = np.clip(rgb.cpu().numpy() * 255, 0, 255).astype(np.uint8)
        host = viz_to_host(viz)
        T_view = T_view_t.cpu().numpy()

        # overlays: trajectory polyline (green) + landmarks (red dots),
        # projected into the virtual view with the output canvas's
        # intrinsics, as render_map scales K to its out_size
        hw = img.shape[:2]
        Hin, Win = np.asarray(host["rgbs"]).shape[-2:]
        sy, sx = hw[0] / Hin, hw[1] / Win
        Kn = np.asarray(_host(K)) * np.array([[sx, 1, sx], [1, sy, sy], [1, 1, 1]])
        traj = np.asarray(host["poses"])[:, :3, 3]
        if traj.shape[0] >= 2:
            u, v, ok = _project_points(traj, T_view, Kn, hw)
            for a in range(len(traj) - 1):
                if ok[a] and ok[a + 1]:
                    _draw_segment(img, u[a], v[a], u[a + 1], v[a + 1],
                                  (40, 230, 70))
        if "P_lm" in host:
            lm = np.asarray(host["P_lm"])[np.asarray(host["lm_valid"])]
            if lm.size:
                u, v, ok = _project_points(lm, T_view, Kn, hw)
                img[v[ok].astype(int), u[ok].astype(int)] = (235, 60, 60)

        write_png(os.path.join(self.out_dir, f"map_{self._count:05d}.png"), img)
        self._count += 1


class Open3DViewer:
    """Interactive Open3D window (open3d is an optional dependency).

    Scene parity with the reference GuiWindow: dense point cloud, KF
    frustums (blue), one-way frustums (gray), trajectory (green),
    landmark spheres (red points), camera follow.  Controls:
        SPACE pause/resume   N step one refresh while paused
        F     toggle follow  S save trajectory to results/
    """

    KF_COLOR = (0.1, 0.3, 0.9)
    OW_COLOR = (0.6, 0.6, 0.6)
    TRAJ_COLOR = (0.1, 0.85, 0.25)
    LM_COLOR = (0.9, 0.2, 0.2)

    def __init__(self, engine):
        import open3d as o3d  # ImportError where it is not installed

        self.o3d = o3d
        self.engine = engine
        self.vis = o3d.visualization.VisualizerWithKeyCallback()
        self.vis.create_window("como_tpu_torch", width=960, height=720)
        self.pcd = o3d.geometry.PointCloud()
        self.lm_pcd = o3d.geometry.PointCloud()
        self.frusta = o3d.geometry.LineSet()
        self.traj = o3d.geometry.LineSet()
        self._added = False
        self.paused = False
        self.follow = True
        self._step_once = False
        self.vis.register_key_callback(ord(" "), self._toggle_pause)
        self.vis.register_key_callback(ord("N"), self._step)
        self.vis.register_key_callback(ord("F"), self._toggle_follow)
        self.vis.register_key_callback(ord("S"), self._save_traj)

    # -- controls -----------------------------------------------------------
    def _toggle_pause(self, _vis):
        self.paused = not self.paused
        return False

    def _step(self, _vis):
        self._step_once = True
        return False

    def _toggle_follow(self, _vis):
        self.follow = not self.follow
        return False

    def _save_traj(self, _vis):
        os.makedirs("results", exist_ok=True)
        self.engine.save_trajectory("results/viewer_traj.txt")
        print("[viz] trajectory -> results/viewer_traj.txt")
        return False

    # -- update -------------------------------------------------------------
    def __call__(self, viz):
        o3d = self.o3d
        scene = build_scene(viz_to_host(viz), _host(self.engine.mapping.K),
                            self.engine.mapping.img_size)

        self.pcd.points = o3d.utility.Vector3dVector(scene["pcd_points"])
        self.pcd.colors = o3d.utility.Vector3dVector(scene["pcd_colors"])
        self.lm_pcd.points = o3d.utility.Vector3dVector(scene["landmarks"])
        self.lm_pcd.paint_uniform_color(self.LM_COLOR)

        # all frustums in one LineSet (point/line offsets)
        pts, lines, cols = [], [], []
        off = 0
        for plist, color in ((scene["kf_frustums"], self.KF_COLOR),
                             (scene["ow_frustums"], self.OW_COLOR)):
            for p, l in plist:
                pts.append(p)
                lines.append(l + off)
                cols.append(np.tile(color, (len(l), 1)))
                off += len(p)
        if pts:
            self.frusta.points = o3d.utility.Vector3dVector(np.concatenate(pts))
            self.frusta.lines = o3d.utility.Vector2iVector(
                np.concatenate(lines))
            self.frusta.colors = o3d.utility.Vector3dVector(
                np.concatenate(cols))
        if scene["trajectory"] is not None:
            tp, tl = scene["trajectory"]
            self.traj.points = o3d.utility.Vector3dVector(tp)
            self.traj.lines = o3d.utility.Vector2iVector(tl)
            self.traj.colors = o3d.utility.Vector3dVector(
                np.tile(self.TRAJ_COLOR, (len(tl), 1)))

        geoms = (self.pcd, self.lm_pcd, self.frusta, self.traj)
        if not self._added:
            for g in geoms:
                self.vis.add_geometry(g)
            self._added = True
        else:
            for g in geoms:
                self.vis.update_geometry(g)
        if self.follow:
            self._apply_follow(scene["follow_pose"])
        self.vis.poll_events()
        self.vis.update_renderer()
        # pause blocks the (headless) engine loop inside the observer
        # callback: the inversion of the reference, where the GUI owns the
        # loop and pause gates it
        while self.paused and not self._step_once:
            self.vis.poll_events()
            self.vis.update_renderer()
            time.sleep(0.03)
        self._step_once = False

    def _apply_follow(self, T_wc):
        ctl = self.vis.get_view_control()
        cam = ctl.convert_to_pinhole_camera_parameters()
        cam.extrinsic = np.linalg.inv(T_wc)
        ctl.convert_from_pinhole_camera_parameters(cam, True)


def attach_viewer(engine, out_dir: str = "results/viz"):
    """Attach the Open3D viewer, or the SnapshotViewer where open3d is not
    installed; any other failure to build the viewer raises."""
    try:
        viewer = Open3DViewer(engine)
    except ImportError:
        viewer = SnapshotViewer(engine, out_dir=out_dir)
    engine.viz_listener = viewer
    return viewer
