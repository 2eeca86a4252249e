"""Dataset loaders: TUM RGB-D (rgb stream), Replica, ScanNet, RealSense
(port of como_tpu/data/datasets.py).

Host-side (OpenCV) decode / undistort / resize; frames are handed to the
engine as host numpy float32 (1, 3, H, W) in [0, 1], and the engine uploads
them.  `intrinsics` is a (3, 3) tensor on the dataset's `device`.  OpenCV
and pyrealsense2 are import-gated: the synthetic datasets need neither.
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

import torch

from como_tpu_torch.geometry.camera import resize_intrinsics

# TUM freiburg camera calibrations (intrinsics + plumb-bob distortion)
_TUM_CALIB = {
    1: (np.array([[517.3, 0.0, 318.6], [0.0, 516.5, 255.3], [0.0, 0.0, 1.0]]),
        np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])),
    2: (np.array([[520.9, 0.0, 325.1], [0.0, 521.0, 249.7], [0.0, 0.0, 1.0]]),
        np.array([0.2312, -0.7849, -0.0033, -0.0001, 0.9172])),
    3: (np.array([[535.4, 0.0, 320.1], [0.0, 539.2, 247.6], [0.0, 0.0, 1.0]]),
        None),
}


def _to_chw_float(rgb_np: np.ndarray) -> np.ndarray:
    x = rgb_np.astype(np.float32) / 255.0
    return np.ascontiguousarray(x.transpose(2, 0, 1)[None])


def _K(K0, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(K0, np.float32), device=device)


def _need_cv2(who: str):
    if cv2 is None:
        raise ImportError(f"{who} needs OpenCV (cv2)")


class OdometryDataset:
    is_live = False

    def __init__(self, img_size, device="cuda"):
        self.img_size = tuple(img_size)
        self.device = torch.device(device)

    def __len__(self):
        return self.data_len

    def __getitem__(self, idx):
        return self.load_timestamp(idx), self.load_rgb(idx)


class TumDataset(OdometryDataset):
    """TUM rgb.txt stream with undistort-rectify + resize."""

    def __init__(self, seq_path: str, img_size, device="cuda"):
        super().__init__(img_size, device)
        _need_cv2("TumDataset")
        self.seq_path = seq_path
        parts = seq_path.rstrip("/").rsplit("/", 2)
        self.save_traj_name = "_".join(parts[-2:])

        self.ts_list: List[float] = []
        self.rgb_list: List[str] = []
        with open(os.path.join(seq_path, "rgb.txt")) as f:
            for line in f.readlines()[3:]:
                ts, rel = line.split()[:2]
                self.ts_list.append(float(ts))
                self.rgb_list.append(os.path.join(seq_path, rel))
        self.data_len = len(self.rgb_list)

        ind = int(re.search(r"freiburg(\d+)", seq_path).group(1))
        K0, dist = _TUM_CALIB[ind]
        size_orig = (480, 640)
        if dist is not None:
            wh = (size_orig[1], size_orig[0])
            K_u, _ = cv2.getOptimalNewCameraMatrix(K0, dist, wh, alpha=0,
                                                   newImgSize=wh)
            self.map1, self.map2 = cv2.initUndistortRectifyMap(
                K0, dist, None, K_u, wh, cv2.CV_32FC1)
            K0 = K_u
        else:
            self.map1 = self.map2 = None
        scale = np.array(self.img_size) / np.array(size_orig)
        self.intrinsics = resize_intrinsics(_K(K0, self.device), scale.tolist())

    def load_rgb(self, idx):
        bgr = cv2.imread(self.rgb_list[idx])
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        if self.map1 is not None:
            rgb = cv2.remap(rgb, self.map1, self.map2, cv2.INTER_LINEAR)
        rgb = cv2.resize(rgb, (self.img_size[1], self.img_size[0]),
                         interpolation=cv2.INTER_LINEAR)
        return _to_chw_float(rgb)

    def load_timestamp(self, idx):
        return self.ts_list[idx]


class ReplicaDataset(OdometryDataset):
    def __init__(self, seq_path: str, img_size, device="cuda"):
        super().__init__(img_size, device)
        _need_cv2("ReplicaDataset")
        self.rgb_list = sorted(glob.glob(os.path.join(seq_path, "results/*.jpg")))
        self.data_len = len(self.rgb_list)
        parts = seq_path.rstrip("/").rsplit("/", 2)
        self.save_traj_name = "_".join(parts[-2:])
        K0 = _K([[600.0, 0.0, 599.5], [0.0, 600.0, 339.5], [0.0, 0.0, 1.0]],
                self.device)
        scale = np.array(self.img_size) / np.array([680, 1200])
        self.intrinsics = resize_intrinsics(K0, scale.tolist())

    def load_rgb(self, idx):
        bgr = cv2.imread(self.rgb_list[idx])
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        rgb = cv2.resize(rgb, (self.img_size[1], self.img_size[0]),
                         interpolation=cv2.INTER_LINEAR)
        return _to_chw_float(rgb)

    def load_timestamp(self, idx):
        return idx / 30.0


class ScanNetDataset(OdometryDataset):
    def __init__(self, seq_path: str, img_size, crop_size: int = 8, device="cuda"):
        super().__init__(img_size, device)
        _need_cv2("ScanNetDataset")
        self.crop = crop_size
        scene_id = seq_path.rstrip("/").rsplit("/", 1)[-1]
        self.save_traj_name = scene_id
        rgb_dir = os.path.join(seq_path, "color")
        self.rgb_list = sorted(
            (os.path.join(rgb_dir, f) for f in os.listdir(rgb_dir)
             if f.endswith(".jpg")),
            key=lambda x: int(re.findall(r"\d+", os.path.basename(x))[0]))
        self.data_len = len(self.rgb_list)

        info = {}
        with open(os.path.join(seq_path, scene_id + ".txt")) as f:
            for line in f:
                if " = " in line:
                    k, v = line.split(" = ")
                    info[k.strip()] = v.strip()
        K0 = np.array([[float(info["fx_color"]), 0.0, float(info["mx_color"])],
                       [0.0, float(info["fy_color"]), float(info["my_color"])],
                       [0.0, 0.0, 1.0]], np.float32)
        size_orig = np.array([float(info["colorHeight"]),
                              float(info["colorWidth"])])
        # images are stored at 480x640; crop then resize
        K = resize_intrinsics(_K(K0, self.device),
                              (np.array([480, 640]) / size_orig).tolist())
        K[0, 2] -= crop_size
        K[1, 2] -= crop_size
        scale = np.array(self.img_size) / np.array(
            [480 - 2 * crop_size, 640 - 2 * crop_size])
        self.intrinsics = resize_intrinsics(K, scale.tolist())

    def load_rgb(self, idx):
        bgr = cv2.imread(self.rgb_list[idx])
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        c = self.crop
        rgb = rgb[c:rgb.shape[0] - c, c:rgb.shape[1] - c]
        rgb = cv2.resize(rgb, (self.img_size[1], self.img_size[0]),
                         interpolation=cv2.INTER_AREA)
        return _to_chw_float(rgb)

    def load_timestamp(self, idx):
        return idx / 30.0


class RealsenseDataset(OdometryDataset):
    """Live RealSense color stream (import-gated)."""
    is_live = True

    def __init__(self, img_size, rs_cfg: Optional[dict] = None, device="cuda"):
        super().__init__(img_size, device)
        _need_cv2("RealsenseDataset")
        import pyrealsense2 as rs  # gated: an optional dependency

        self.rs = rs
        self.pipeline = rs.pipeline()
        cfg = rs.config()
        w, h, fps = 640, 480, 30
        if rs_cfg:
            w = rs_cfg.get("width", w)
            h = rs_cfg.get("height", h)
            fps = rs_cfg.get("fps", fps)
        cfg.enable_stream(rs.stream.color, w, h, rs.format.rgb8, fps)
        profile = self.pipeline.start(cfg)
        intr = profile.get_stream(rs.stream.color) \
            .as_video_stream_profile().get_intrinsics()
        K0 = _K([[intr.fx, 0.0, intr.ppx], [0.0, intr.fy, intr.ppy],
                 [0.0, 0.0, 1.0]], self.device)
        scale = np.array(self.img_size) / np.array([h, w])
        self.intrinsics = resize_intrinsics(K0, scale.tolist())
        self.data_len = 1 << 30
        self.save_traj_name = "realsense"

    def __getitem__(self, idx):
        frames = self.pipeline.wait_for_frames()
        color = frames.get_color_frame()
        ts = color.get_timestamp() / 1000.0
        rgb = np.asanyarray(color.get_data())
        rgb = cv2.resize(rgb, (self.img_size[1], self.img_size[0]),
                         interpolation=cv2.INTER_LINEAR)
        return ts, _to_chw_float(rgb)


def get_dataset(dataset_type: str, img_size, dataset_dir: Optional[str] = None,
                device="cuda", **kwargs):
    """Factory: tum | replica | scannet | realsense | synthetic[:scene]."""
    if dataset_type == "tum":
        return TumDataset(dataset_dir, img_size, device=device)
    if dataset_type == "replica":
        return ReplicaDataset(dataset_dir, img_size, device=device)
    if dataset_type == "scannet":
        return ScanNetDataset(dataset_dir, img_size, device=device, **kwargs)
    if dataset_type == "realsense":
        return RealsenseDataset(img_size, kwargs.get("rs_cfg"), device=device)
    if dataset_type.startswith("synthetic"):
        # "synthetic" (plane world) or "synthetic:<scene>" (e.g.
        # synthetic:clutter — the hard multi-object world)
        from como_tpu_torch.data.synthetic import SyntheticDataset
        scene = dataset_type.split(":", 1)[1] if ":" in dataset_type else "plane"
        return SyntheticDataset(img_size=img_size, scene=scene,
                                n_frames=kwargs.get("n_frames", 120),
                                step=kwargs.get("step", 0.02), device=device)
    raise ValueError(f"unknown dataset_type '{dataset_type}'")
