"""Training data of the DepthCov trainer (ports of synthetic_batch and
RgbdFolder, scripts/train_depthcov.py:46-158).

  * synthetic: a random view of one of 12 pooled procedural scenes (plane
    and clutter worlds, homogeneous low-frequency variants, chroma
    variants), rendered on the training device;
  * rgbd: an RGB-D folder, TUM format (rgb.txt + depth.txt, nearest
    timestamp association, 16-bit depth / 5000) or ScanNet-style
    (color/*.jpg + depth/*.png in millimetres).  Needs OpenCV (cv2), which
    is imported when a folder is opened.
Both return rgb (1, 3, H, W) in [0, 1] and depth (1, 1, H, W) in metres,
f32 tensors on the device.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from como_tpu_torch.data.synthetic import ClutterScene, PlaneScene
from como_tpu_torch.geometry import lie

POOL = 12
_SCENES: dict = {}


def _make_scene(sid: int, img_size, device):
    """The round-3 training mix, by sid % 6: plane, clutter, homogeneous
    plane (few low-frequency waves: large length scales), chroma plane,
    chroma clutter, near-textureless clutter."""
    kind = sid % 6
    kw = dict(img_size=img_size, seed=sid, device=device)
    if kind == 0:
        return PlaneScene(**kw)
    if kind == 1:
        return ClutterScene(**kw)
    if kind == 2:
        return PlaneScene(**kw, num_waves=6, max_freq=2.0)
    if kind == 3:
        return PlaneScene(**kw, chroma=True)
    if kind == 4:
        return ClutterScene(**kw, chroma=True)
    return ClutterScene(**kw, num_waves=6, max_freq=2.0)


def synthetic_view(seed: int, img_size=(96, 128), pool: int = POOL, device="cuda"):
    """The view synthetic_batch renders for the integer draw `seed`: scene
    seed % pool (built once per size and device, with its 48-view
    trajectory), one of its views chosen by numpy's generator of `seed`,
    perturbed by 0.03 N(0, 1) in se3."""
    img_size, device = tuple(img_size), torch.device(device)
    sid = seed % pool
    key = (img_size, sid, str(device))
    if key not in _SCENES:
        scene = _make_scene(sid, img_size, device)
        _SCENES[key] = (scene, np.array(scene.trajectory(48, step=0.04, seed=sid + 1)))
    scene, views = _SCENES[key]
    rng = np.random.default_rng(seed)
    base = views[rng.integers(len(views))]
    xi = 0.03 * rng.normal(size=6)
    pose = torch.as_tensor(base, device=device) @ lie.se3_exp(
        torch.as_tensor(xi, dtype=torch.float32, device=device))
    return scene.render(pose)


def synthetic_batch(rng: np.random.Generator, img_size=(96, 128), pool: int = POOL,
                    device="cuda"):
    """A random view of a pooled synthetic scene: (rgb, depth)."""
    return synthetic_view(int(rng.integers(0, 1 << 20)), img_size, pool, device)


class RgbdFolder:
    """RGB-D pairs of a TUM-format or ScanNet-style folder (see module doc)."""

    def __init__(self, root: str, img_size, depth_scale: float | None = None,
                 max_dt: float = 0.03, device="cuda"):
        try:
            import cv2
        except ImportError as e:
            raise ImportError("RgbdFolder needs OpenCV (cv2)") from e
        self.cv2 = cv2
        self.img_size = tuple(img_size)
        self.device = torch.device(device)
        self.pairs = []  # (rgb_path, depth_path)
        if os.path.exists(os.path.join(root, "rgb.txt")):
            self.depth_scale = depth_scale or 5000.0
            rgb = self._read_list(os.path.join(root, "rgb.txt"))
            dep = self._read_list(os.path.join(root, "depth.txt"))
            dts = np.array([t for t, _ in dep])
            for t, rp in rgb:
                k = int(np.argmin(np.abs(dts - t)))
                if abs(dts[k] - t) <= max_dt:
                    self.pairs.append((os.path.join(root, rp), os.path.join(root, dep[k][1])))
        elif os.path.isdir(os.path.join(root, "color")):
            self.depth_scale = depth_scale or 1000.0

            def num(p):
                return int(re.findall(r"\d+", os.path.basename(p))[0])

            rgbs = {num(f): os.path.join(root, "color", f)
                    for f in os.listdir(os.path.join(root, "color"))
                    if f.endswith((".jpg", ".png"))}
            deps = {num(f): os.path.join(root, "depth", f)
                    for f in os.listdir(os.path.join(root, "depth")) if f.endswith(".png")}
            for i in sorted(rgbs.keys() & deps.keys()):
                self.pairs.append((rgbs[i], deps[i]))
        if not self.pairs:
            raise FileNotFoundError(
                f"no RGB-D pairs under {root} (need TUM rgb.txt/depth.txt "
                "or ScanNet-style color/ + depth/)")

    @staticmethod
    def _read_list(path):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                out.append((float(ts), rel))
        return out

    def sample(self, rng: np.random.Generator):
        cv2 = self.cv2
        h, w = self.img_size
        rp, dp = self.pairs[rng.integers(len(self.pairs))]
        rgb = cv2.cvtColor(cv2.imread(rp), cv2.COLOR_BGR2RGB)
        rgb = cv2.resize(rgb, (w, h), interpolation=cv2.INTER_LINEAR)
        depth = cv2.imread(dp, cv2.IMREAD_UNCHANGED).astype(np.float32) / self.depth_scale
        # nearest-neighbour resize: bilinear would blur across depth edges
        depth = cv2.resize(depth, (w, h), interpolation=cv2.INTER_NEAREST)
        rgb_t = torch.from_numpy(rgb.astype(np.float32).transpose(2, 0, 1)[None] / 255.0)
        return rgb_t.to(self.device), torch.from_numpy(depth[None, None]).to(self.device)
