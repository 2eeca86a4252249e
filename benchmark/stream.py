"""The camera stream of a traffic mix: frames rendered on the device from the
seed, with exact ground truth.

A frozen copy of the synthetic clutter world (ground plane, back wall,
spheres and boxes, procedural textures) and its look-at orbit, so the
yardstick does not move when the program's own scene code does.  The mix
fixes the geometry (`geometry_seed`) and the trajectory's noise
(`trajectory_seed`); the run's seed draws the textures (numpy's generator
from [seed, 0]).  So every seed sees new images over the same motion and
the same depths, and the keyframe and one-way decisions, which follow
motion and depth, ask about the same work of every seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def default_intrinsics(img_size, device) -> torch.Tensor:
    h, w = img_size
    f = 0.9 * w
    return torch.tensor([[f, 0.0, (w - 1) / 2.0], [0.0, f, (h - 1) / 2.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _camera_rays(img_size, K):
    h, w = img_size
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=K.device),
                            torch.arange(w, dtype=torch.float32, device=K.device),
                            indexing="ij")
    rx = (xs - K[0, 2]) / K[0, 0]
    ry = (ys - K[1, 2]) / K[1, 1]
    return torch.stack([rx, ry, torch.ones_like(rx)], -1)   # (H, W, 3), z = 1


class ClutterScene:
    """Ground plane + back wall + spheres + boxes: occlusions and depth
    discontinuities, every view exactly multi-view consistent."""

    EPS = 5e-2

    def __init__(self, img_size, geo_rng: np.random.Generator, tex_rng: np.random.Generator,
                 device, num_waves: int = 24, max_freq: float = 6.0, num_spheres: int = 5,
                 num_boxes: int = 3):
        """Geometry (where the spheres and boxes are) from `geo_rng`, the
        procedural textures from `tex_rng`."""
        self.img_size = tuple(img_size)
        self.device = torch.device(device)
        self.K = default_intrinsics(img_size, self.device)
        planes_n = np.array([[0.0, -1.0, 0.02], [0.08, -0.06, -1.0]])
        planes_n = planes_n / np.linalg.norm(planes_n, axis=-1, keepdims=True)
        planes_d = np.array([np.dot(planes_n[0], [0.0, 0.9, 0.0]),
                             np.dot(planes_n[1], [0.0, 0.0, 4.8])])
        rng = geo_rng
        centers = np.stack([rng.uniform(-0.9, 0.9, size=num_spheres),
                            rng.uniform(-0.35, 0.75, size=num_spheres),
                            rng.uniform(1.8, 3.4, size=num_spheres)], -1)
        radii = rng.uniform(0.15, 0.35, size=num_spheres)
        box_c = np.stack([rng.uniform(-1.0, 1.0, size=num_boxes),
                          rng.uniform(0.0, 0.7, size=num_boxes),
                          rng.uniform(2.0, 3.6, size=num_boxes)], -1)
        box_h = np.stack([rng.uniform(0.15, 0.4, size=num_boxes),
                          rng.uniform(0.15, 0.5, size=num_boxes),
                          rng.uniform(0.12, 0.3, size=num_boxes)], -1)
        rng = tex_rng
        dev = self.device
        self.planes_n = _f32(planes_n, dev)
        self.planes_d = _f32(planes_d, dev)
        self.sph_c = _f32(centers, dev)
        self.sph_r = _f32(radii, dev)
        self.box_lo = _f32(box_c - box_h, dev)
        self.box_hi = _f32(box_c + box_h, dev)
        n_prim = 2 + num_spheres + num_boxes
        f = rng.uniform(0.8, max_freq, size=(n_prim, num_waves, 3))
        a = rng.uniform(0.2, 1.0, size=(n_prim, num_waves))
        a = 0.35 * a / a.sum(axis=-1, keepdims=True) * num_waves ** 0.5
        ph = rng.uniform(0, 2 * np.pi, size=(n_prim, num_waves))
        self.base = _f32(rng.uniform(0.35, 0.65, size=n_prim), dev)
        self.freqs = _f32(f, dev)
        self.amps = _f32(a, dev)
        self.phases = _f32(ph, dev)
        self.rays = _camera_rays(self.img_size, self.K)

    def render(self, T_wc: torch.Tensor) -> torch.Tensor:
        """rgb (B, 3, H, W) in [0, 1] of B poses (B, 4, 4) by exact ray
        casting (gray texture)."""
        B = T_wc.shape[0]
        R, o = T_wc[:, :3, :3], T_wc[:, :3, 3]
        d = torch.einsum("bij,hwj->bhwi", R, self.rays)
        INF = torch.tensor(1e9, dtype=torch.float32, device=self.device)
        ob = o[:, None, None, :]

        ndotd = torch.einsum("bhwi,pi->bhwp", d, self.planes_n)
        t_pl = (self.planes_d - o @ self.planes_n.T)[:, None, None, :] / ndotd
        t_pl = torch.where(t_pl > self.EPS, t_pl, INF)

        oc = o[:, None, :] - self.sph_c[None]                         # (B, S, 3)
        a2 = torch.sum(d * d, -1)[..., None]
        b = 2.0 * torch.einsum("bhwi,bsi->bhws", d, oc)
        c = (torch.sum(oc * oc, -1) - self.sph_r ** 2)[:, None, None, :]
        disc = b * b - 4.0 * a2 * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_sp = (-b - sq) / (2.0 * a2)
        t_sp = torch.where((disc > 0) & (t_sp > self.EPS), t_sp, INF)

        safe_d = torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)[..., None, :]
        t0 = (self.box_lo - ob[..., None, :]) / safe_d
        t1 = (self.box_hi - ob[..., None, :]) / safe_d
        t_near = torch.amax(torch.minimum(t0, t1), -1)
        t_far = torch.amin(torch.maximum(t0, t1), -1)
        t_bx = torch.where((t_near <= t_far) & (t_near > self.EPS), t_near, INF)

        t_all = torch.cat([t_pl, t_sp, t_bx], -1)
        idx = torch.argmin(t_all, -1)
        t_hit = torch.gather(t_all, -1, idx[..., None])[..., 0]
        t_hit = torch.clamp(t_hit, max=50.0)
        Pw = ob + t_hit[..., None] * d
        arg = torch.einsum("bhwi,bhwki->bhwk", Pw, self.freqs[idx]) + self.phases[idx]
        tex = self.base[idx] + torch.einsum("bhwk,bhwk->bhw", torch.sin(arg), self.amps[idx])
        tex = torch.clamp(tex, 0.0, 1.0)
        return tex[:, None].expand(B, 3, *tex.shape[1:]).contiguous()


def orbit(steps: np.ndarray, rot_step: float, rng: np.random.Generator) -> np.ndarray:
    """(n, 4, 4) camera-to-world poses: a look-at orbit arc around the
    scene with smooth positional and target noise, advancing steps[i] m
    after frame i."""
    n_frames = len(steps)
    center = np.array([0.0, 0.25, 2.8])
    start = np.zeros(3)
    radius = np.linalg.norm(center - start)
    theta = np.arctan2(start[0] - center[0], start[2] - center[2])
    down = np.array([0.0, 1.0, 0.0])
    poses = np.zeros((n_frames, 4, 4), np.float32)
    pos_noise = np.zeros(3)
    tgt_noise = np.zeros(3)
    for i in range(n_frames):
        step = float(steps[i])
        pos_noise = 0.85 * pos_noise + 0.3 * step * rng.normal(size=3)
        tgt_noise = 0.85 * tgt_noise + (0.2 * step + 0.5 * rot_step) * rng.normal(size=3)
        pos = center + radius * np.array([np.sin(theta), 0.0, np.cos(theta)]) + pos_noise
        pos[1] = start[1] + pos_noise[1]
        z = center + tgt_noise - pos
        z = z / np.linalg.norm(z)
        x = np.cross(down, z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        poses[i] = np.eye(4, dtype=np.float32)
        poses[i, :3, 0], poses[i, :3, 1], poses[i, :3, 2], poses[i, :3, 3] = x, y, z, pos
        theta += step / radius
    return poses


RENDER_BATCH = 32


class Stream:
    """Every frame of a run, rendered up front on `device` in batches of
    RENDER_BATCH poses.  frame(i) -> (timestamp, rgb (1, 3, H, W)); asking
    past the end raises, so a run that outruns its frames fails instead of
    ending its window early."""

    def __init__(self, traffic: dict, img_size, seed: int, n_frames: int, device):
        if traffic["scene"] != "clutter" or traffic.get("variant", ""):
            raise ValueError(f"unknown scene {traffic['scene']!r}{traffic.get('variant')!r}")
        self.hz = float(traffic["camera_hz"])
        seed = seed % 2 ** 64
        self.scene = ClutterScene(img_size, np.random.default_rng(int(traffic["geometry_seed"])),
                                  np.random.default_rng([seed, 0]), device)
        steps = np.full(n_frames, float(traffic["step"]))
        self.poses = orbit(steps, float(traffic["rot_step"]),
                           np.random.default_rng(int(traffic["trajectory_seed"])))
        poses = torch.as_tensor(self.poses, device=self.scene.device)
        self.frames = []
        for i in range(0, n_frames, RENDER_BATCH):
            self.frames.extend(self.scene.render(poses[i:i + RENDER_BATCH]).split(1))
        self.K = self.scene.K

    def __len__(self):
        return len(self.frames)

    def frame(self, i: int):
        if i >= len(self.frames):
            raise RuntimeError(f"the stream ran out of frames at frame {i}: "
                               f"render more for this run")
        return i / self.hz, self.frames[i]

    def index_of(self, ts: float) -> int:
        return int(math.floor(ts * self.hz + 0.5))
