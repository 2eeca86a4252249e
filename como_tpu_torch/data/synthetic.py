"""Procedural multi-view test scenes with exact ground truth (port of
como_tpu/data/synthetic.py): the scenes "plane" and "clutter", their
chromatic variants and the photometric-nuisance variants.

Scene parameters are drawn with numpy from the same seeds and in the same
order as the JAX package, so the rendered frames match its frames; frames
are rendered by ray casting on the dataset's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from como_tpu_torch.geometry import lie


class PhotoNuisance(NamedTuple):
    """Photometric nuisance applied to a clean render I:

        I' = exp(a_t) * (V(p) * I) + b_t + noise_sigma * N(0, 1)

    (a_t, b_t) is a known per-frame AR(1) walk (SyntheticDataset.gt_affine)
    and V(p) = 1 - vignette * (r / r_max)^2 a static radial falloff.
    Exposure and bias are exactly the system's affine-brightness model;
    vignetting and noise are deliberate violations of it that stress the
    robust losses.  No sensor clipping.
    """
    exposure_jitter: float = 0.0   # AR(1) innovation std of log-gain a_t
    bias_jitter: float = 0.0       # AR(1) innovation std of bias b_t
    noise_sigma: float = 0.0       # per-pixel Gaussian sensor noise
    vignette: float = 0.0          # corner falloff strength in [0, 1)
    ar_decay: float = 0.97         # AR(1) pole


# the "photo" variant: stationary log-gain std ~0.16, bias std ~0.04, 1%
# sensor noise, 15% corner vignetting
PHOTO_NUISANCE = PhotoNuisance(exposure_jitter=0.04, bias_jitter=0.01,
                               noise_sigma=0.01, vignette=0.15)


def _apply_nuisance(rgb, a: float, b: float, vmap_img, generator, noise_sigma: float):
    """`generator` is a CPU generator: the noise field is drawn on the CPU
    and moved, so a frame does not depend on the device it is rendered on."""
    out = float(np.exp(np.float32(a))) * (vmap_img * rgb) + float(b)
    if noise_sigma > 0.0:
        noise = torch.randn(rgb.shape, generator=generator, dtype=rgb.dtype)
        out = out + noise_sigma * noise.to(rgb.device)
    return out


def default_intrinsics(img_size=(192, 256), device="cuda") -> torch.Tensor:
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


class PlaneScene:
    """A slightly tilted textured plane ~2 m away."""

    def __init__(self, img_size=(192, 256), seed: int = 0, num_waves: int = 24,
                 max_freq: float = 6.0, chroma: bool = False, device="cuda"):
        self.img_size = tuple(img_size)
        self.device = torch.device(device)
        self.K = default_intrinsics(img_size, self.device)
        rng = np.random.default_rng(seed)
        n = np.array([0.15, -0.1, 1.0])
        self.normal_np = (n / np.linalg.norm(n)).astype(np.float32)
        self.normal = _f32(self.normal_np, self.device)
        self.d0 = 2.0
        f = rng.uniform(0.5, max_freq, size=(num_waves, 3))
        a = rng.uniform(0.2, 1.0, size=num_waves)
        a = 0.35 * a / a.sum() * num_waves ** 0.5
        self.freqs = _f32(f, self.device)
        self.amps = _f32(a, self.device)
        self.phases = _f32(rng.uniform(0, 2 * np.pi, size=num_waves), self.device)
        # chroma: per-channel phase offsets + an RGB base color decorrelate
        # the channels (chroma=False keeps the gray x3 render)
        self.chroma = chroma
        if chroma:
            self.base_rgb = _f32(rng.uniform(0.3, 0.7, size=3), self.device)
            self.chan_phase = _f32(rng.uniform(0, 2 * np.pi, size=3), self.device)

    def render(self, T_wc: torch.Tensor):
        """rgb (1, 3, H, W) in [0, 1] and z-depth (1, 1, H, W) from T_wc."""
        T_wc = T_wc.to(self.device)
        r = _camera_rays(self.img_size, self.K)
        R, t = T_wc[:3, :3], T_wc[:3, 3]
        d_world = torch.einsum("ij,hwj->hwi", R, r)
        denom = torch.einsum("hwi,i->hw", d_world, self.normal)
        s = (self.d0 - torch.dot(self.normal, t)) / denom
        Pw = t[None, None] + s[..., None] * d_world
        arg = torch.einsum("hwi,ki->hwk", Pw, self.freqs) + self.phases
        if self.chroma:
            argc = arg[..., None] + self.chan_phase               # (H, W, K, 3)
            tex = self.base_rgb + torch.einsum("hwkc,k->hwc", torch.sin(argc), self.amps)
            return torch.clamp(tex, 0.0, 1.0).permute(2, 0, 1)[None], s[None, None]
        tex = torch.clamp(0.5 + torch.einsum("hwk,k->hw", torch.sin(arg), self.amps),
                          0.0, 1.0)
        return torch.stack([tex, tex, tex], 0)[None], s[None, None]

    def trajectory(self, n_frames: int, step: float = 0.02, rot_step: float = 0.004,
                   seed: int = 1, min_dist: float = 0.8):
        """Smooth forward-sideways walk reflected off a standoff surface
        `min_dist` in front of the plane; (n, 4, 4) world poses."""
        rng = np.random.default_rng(seed)
        poses = [np.eye(4, dtype=np.float32)]
        n_np = self.normal_np.astype(np.float64)
        d0 = float(self.d0)
        xi = np.zeros(6, dtype=np.float32)

        def exp(x):
            return lie.se3_exp(torch.as_tensor(x, dtype=torch.float32)).numpy()

        for _ in range(n_frames - 1):
            xi[:3] = 0.7 * xi[:3] + rot_step * rng.normal(size=3)
            xi[3:] = 0.7 * xi[3:] + step * (rng.normal(size=3) * [1.0, 1.0, 0.4]
                                            + [0.5, 0.1, 0.0])
            T_next = poses[-1] @ exp(xi)
            if d0 - n_np @ T_next[:3, 3] < min_dist:
                n_body = (poses[-1][:3, :3].T @ n_np).astype(np.float32)
                xi[3:] -= 2.0 * (xi[3:] @ n_body) * n_body
                T_next = poses[-1] @ exp(xi)
            poses.append(T_next.astype(np.float32))
        return np.stack(poses)


class ClutterScene:
    """Ground plane + back wall + spheres + boxes: occlusions and depth
    discontinuities, every view exactly multi-view consistent."""

    EPS = 5e-2

    def __init__(self, img_size=(192, 256), seed: int = 0, num_waves: int = 24,
                 max_freq: float = 6.0, num_spheres: int = 5, num_boxes: int = 3,
                 chroma: bool = False, device="cuda"):
        self.img_size = tuple(img_size)
        self.device = torch.device(device)
        self.K = default_intrinsics(img_size, self.device)
        self.chroma = chroma
        rng = np.random.default_rng(seed)
        planes_n = np.array([[0.0, -1.0, 0.02], [0.08, -0.06, -1.0]])
        planes_n = planes_n / np.linalg.norm(planes_n, axis=-1, keepdims=True)
        planes_d = np.array([np.dot(planes_n[0], [0.0, 0.9, 0.0]),
                             np.dot(planes_n[1], [0.0, 0.0, 4.8])])
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
        # chroma: per-primitive RGB base color + per-channel phase offsets
        if chroma:
            self.base_rgb = _f32(rng.uniform(0.3, 0.7, size=(n_prim, 3)), dev)
            self.chan_phase = _f32(rng.uniform(0, 2 * np.pi, size=(n_prim, 3)), dev)

    def render(self, T_wc: torch.Tensor):
        """rgb (1, 3, H, W) in [0, 1] and z-depth (1, 1, H, W) by exact ray casting."""
        T_wc = T_wc.to(self.device)
        r = _camera_rays(self.img_size, self.K)
        R, o = T_wc[:3, :3], T_wc[:3, 3]
        d = torch.einsum("ij,hwj->hwi", R, r)
        INF = torch.tensor(1e9, dtype=torch.float32, device=self.device)

        ndotd = torch.einsum("hwi,pi->hwp", d, self.planes_n)
        t_pl = (self.planes_d[None, None] - self.planes_n @ o) / ndotd
        t_pl = torch.where(t_pl > self.EPS, t_pl, INF)

        oc = o[None] - self.sph_c
        a2 = torch.sum(d * d, -1)[..., None]
        b = 2.0 * torch.einsum("hwi,si->hws", d, oc)
        c = torch.sum(oc * oc, -1)[None, None] - (self.sph_r ** 2)[None, None]
        disc = b * b - 4.0 * a2 * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_sp = (-b - sq) / (2.0 * a2)
        t_sp = torch.where((disc > 0) & (t_sp > self.EPS), t_sp, INF)

        safe_d = torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)[:, :, None, :]
        t0 = (self.box_lo[None, None] - o) / safe_d
        t1 = (self.box_hi[None, None] - o) / safe_d
        t_near = torch.amax(torch.minimum(t0, t1), -1)
        t_far = torch.amin(torch.maximum(t0, t1), -1)
        t_bx = torch.where((t_near <= t_far) & (t_near > self.EPS), t_near, INF)

        t_all = torch.cat([t_pl, t_sp, t_bx], -1)
        idx = torch.argmin(t_all, -1)
        t_hit = torch.gather(t_all, -1, idx[..., None])[..., 0]
        t_hit = torch.clamp(t_hit, max=50.0)
        Pw = o[None, None] + t_hit[..., None] * d
        arg = torch.einsum("hwi,hwki->hwk", Pw, self.freqs[idx]) + self.phases[idx]
        if self.chroma:
            argc = arg[..., None] + self.chan_phase[idx][..., None, :]   # (H, W, K, 3)
            tex = self.base_rgb[idx] + torch.einsum("hwkc,hwk->hwc", torch.sin(argc),
                                                    self.amps[idx])
            return torch.clamp(tex, 0.0, 1.0).permute(2, 0, 1)[None], t_hit[None, None]
        tex = self.base[idx] + torch.einsum("hwk,hwk->hw", torch.sin(arg), self.amps[idx])
        tex = torch.clamp(tex, 0.0, 1.0)
        return torch.stack([tex, tex, tex], 0)[None], t_hit[None, None]

    def trajectory(self, n_frames: int, step: float = 0.012, rot_step: float = 0.0,
                   seed: int = 1):
        """Look-at orbit arc around the scene with smooth positional noise."""
        rng = np.random.default_rng(seed)
        center = np.array([0.0, 0.25, 2.8])
        start = np.zeros(3)
        radius = np.linalg.norm(center - start)
        theta = np.arctan2(start[0] - center[0], start[2] - center[2])
        down = np.array([0.0, 1.0, 0.0])
        poses = []
        pos_noise = np.zeros(3)
        tgt_noise = np.zeros(3)
        for _ in range(n_frames):
            pos_noise = 0.85 * pos_noise + 0.3 * step * rng.normal(size=3)
            tgt_noise = 0.85 * tgt_noise + (0.2 * step + 0.5 * rot_step) \
                * rng.normal(size=3)
            pos = center + radius * np.array([np.sin(theta), 0.0, np.cos(theta)]) + pos_noise
            pos[1] = start[1] + pos_noise[1]
            z = center + tgt_noise - pos
            z = z / np.linalg.norm(z)
            x = np.cross(down, z)
            x = x / np.linalg.norm(x)
            y = np.cross(z, x)
            T = np.eye(4, dtype=np.float32)
            T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, pos
            poses.append(T)
            theta += step / radius
        return np.stack(poses)


_SCENES = {"plane": PlaneScene, "clutter": ClutterScene}


class SyntheticDataset:
    """Dataset-shaped wrapper: dataset[i] -> (timestamp, rgb (1, 3, H, W)
    tensor on `device`).

    scene="plane" is the single-plane world, scene="clutter" the
    multi-object world with occlusions.  Variants (scene="<base>_<variant>"):
      * "<base>_chroma": chromatic textures, clean photometry;
      * "<base>_photo": chroma + the PHOTO_NUISANCE preset (per-frame
        exposure/bias walk with known ground truth, sensor noise,
        vignetting).
    An explicit `nuisance=PhotoNuisance(...)` overrides the preset.

    The exposure/bias walk is numpy's from `seed + 77` and equals the JAX
    package's.  The sensor noise of frame idx comes from a torch.Generator
    seeded from (seed + 177, idx); the JAX package folds idx into
    PRNGKey(seed + 177).  The two noise fields have the same distribution
    and differ draw by draw, so a noisy frame equals the JAX frame only up
    to the noise.
    """

    def __init__(self, n_frames: int = 60, img_size=(192, 256), fps: float = 30.0,
                 seed: int = 0, step: float = 0.02, scene: str = "plane",
                 rot_step: float | None = None,
                 nuisance: PhotoNuisance | None = None, device="cuda"):
        base, _, variant = scene.partition("_")
        if base not in _SCENES or variant not in ("", "chroma", "photo"):
            raise ValueError(f"unknown synthetic scene '{scene}' (have "
                             f"{sorted(_SCENES)} x ['', '_chroma', '_photo'])")
        if nuisance is None and variant == "photo":
            nuisance = PHOTO_NUISANCE
        self.device = torch.device(device)
        self.scene = _SCENES[base](img_size=img_size, seed=seed,
                                   chroma=variant in ("chroma", "photo"),
                                   device=self.device)
        kw = {} if rot_step is None else {"rot_step": rot_step}
        self.poses = self.scene.trajectory(n_frames, step=step, **kw)   # numpy
        self._poses_dev = torch.as_tensor(self.poses, device=self.device)
        self.fps = fps
        self.intrinsics = self.scene.K
        self.img_size = tuple(img_size)
        self.is_live = False
        self.save_traj_name = "synthetic"

        self.nuisance = nuisance
        if nuisance is not None:
            rng = np.random.default_rng(seed + 77)
            aff = np.zeros((n_frames, 2), np.float32)
            for t in range(1, n_frames):
                aff[t, 0] = (nuisance.ar_decay * aff[t - 1, 0]
                             + nuisance.exposure_jitter * rng.normal())
                aff[t, 1] = (nuisance.ar_decay * aff[t - 1, 1]
                             + nuisance.bias_jitter * rng.normal())
            self.gt_aff = aff
            h, w = self.img_size
            ys, xs = np.meshgrid(np.arange(h) - (h - 1) / 2,
                                 np.arange(w) - (w - 1) / 2, indexing="ij")
            r2 = (ys ** 2 + xs ** 2) / (((h - 1) / 2) ** 2 + ((w - 1) / 2) ** 2)
            self._vmap = _f32(1.0 - nuisance.vignette * r2, self.device)
            self._noise_seed = seed + 177
            self._noise_gen = torch.Generator()

    def __len__(self):
        return self.poses.shape[0]

    def __getitem__(self, idx):
        rgb, _ = self.scene.render(self._poses_dev[idx])
        if self.nuisance is not None:
            self._noise_gen.manual_seed(self._noise_seed * 1_000_003 + int(idx))
            rgb = _apply_nuisance(rgb, self.gt_aff[idx, 0], self.gt_aff[idx, 1],
                                  self._vmap, self._noise_gen, self.nuisance.noise_sigma)
        return idx / self.fps, rgb

    def gt_pose(self, idx):
        return self.poses[idx]

    def gt_affine(self, idx):
        """Ground-truth (log-gain, bias) applied to frame idx (zeros for
        clean worlds)."""
        if self.nuisance is None:
            return np.zeros(2, np.float32)
        return self.gt_aff[idx]

    def gt_depth(self, idx):
        return self.scene.render(self._poses_dev[idx])[1]
