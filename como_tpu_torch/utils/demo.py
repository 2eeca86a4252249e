"""Demo window states (port of como_tpu/utils/demo.py): fill a WindowState
from the synthetic plane scene with ground-truth geometry, without running
the full engine.  Realistic shapes and numerically sane content for tests,
probes and benchmarks of the mapping backend."""

from __future__ import annotations

import numpy as np
import torch

from como_tpu_torch.data.synthetic import PlaneScene
from como_tpu_torch.geometry import lie
from como_tpu_torch.net.analytic_prior import cov_params_from_rgb
from como_tpu_torch.odom import window as win
from como_tpu_torch.odom.backend import pairs as pairs_mod
from como_tpu_torch.odom.mapping import _prep_ow_img, prep_keyframe
from como_tpu_torch.ops import linalg


def anchor_grid(img_size, M, device="cuda") -> torch.Tensor:
    """~sqrt(M) x sqrt(M) uniform anchor grid, (M, 2) xy pixels."""
    H, W = img_size
    n = int(np.ceil(np.sqrt(M)))
    ys = np.linspace(8, H - 9, n)
    xs = np.linspace(8, W - 9, n)
    g = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)[:M]
    return torch.as_tensor(g.astype(np.float32), device=device)


def make_demo_state(dims: win.WindowDims, num_kf: int = 3, num_ow: int = 2,
                    seed: int = 0, step: float = 0.03,
                    scene_kwargs: dict | None = None, channels: int = 1,
                    device="cuda"):
    """WindowState with num_kf keyframes + num_ow one-way frames rendered
    from the synthetic plane scene at ground truth.  Returns
    (state, pair tensors, intrinsics), all on `device`.  channels must
    match dims.C (mapping.color: gray=1, rgb=3); scene_kwargs are forwarded
    to PlaneScene (e.g. chroma=True)."""
    assert channels == dims.C, (channels, dims.C)
    device = torch.device(device)
    img_size = (dims.H, dims.W)
    scene = PlaneScene(img_size=img_size, seed=seed, device=device,
                       **(scene_kwargs or {}))
    K_intr = scene.K
    M = dims.M
    st = win.empty_state(dims, device=device)
    axy = anchor_grid(img_size, M, device)
    kf_ts, ow_ts = [], []

    t = 0.0
    for k in range(num_kf):
        xi = np.zeros(6, np.float32)
        xi[3] = step * k
        xi[1] = 0.01 * k
        pose = lie.se3_exp(torch.as_tensor(xi, device=device))
        rgb, depth = scene.render(pose)
        cov = cov_params_from_rgb(rgb)
        prep = prep_keyframe(rgb, cov, axy, K_intr, 1.0, 4, C=channels)
        z = depth[0, 0, axy[:, 1].long(), axy[:, 0].long()]
        ray = torch.stack([(axy[:, 0] - K_intr[0, 2]) / K_intr[0, 0],
                           (axy[:, 1] - K_intr[1, 2]) / K_intr[1, 1],
                           torch.ones((M,), device=device)], -1)
        Pw = (z[:, None] * ray) @ pose[:3, :3].T + pose[:3, 3]
        lm = torch.arange(k * M, (k + 1) * M, device=device)
        st.kf_pose[k] = pose
        st.kf_valid[k] = True
        st.kf_img[k] = prep["iag"]
        st.kf_rgb[k] = rgb[0]
        st.cov_img[k] = cov
        for f in ("Kmm_inv", "L_mm", "Knm_full", "knm_colmean", "dense_rc",
                  "dense_vals", "dense_knm"):
            getattr(st, f)[k] = prep[f]
        st.pm_first[k] = axy
        st.pm[k] = axy
        st.obs_ref[k] = True
        st.anchor_lm[k] = lm
        st.logzm[k] = torch.log(z)
        st.median_depth[k] = linalg.median(z)
        st.P_lm[lm] = Pw
        st.lm_valid[lm] = True
        kf_ts.append(t)
        t += 0.2

    t_ow = 0.1
    for j in range(num_ow):
        xi = np.zeros(6, np.float32)
        xi[3] = step * (j + 0.5)
        pose = lie.se3_exp(torch.as_tensor(xi, device=device))
        rgb, _ = scene.render(pose)
        st.ow_pose[j] = pose
        st.ow_valid[j] = True
        st.ow_img[j] = _prep_ow_img(rgb, channels)
        ow_ts.append(t_ow)
        t_ow += 0.2

    # scale anchor convention: mean *predicted dense* log-depth of KF0
    # (= colmean(Knm_full) . logzm), matching the SfM bootstrap
    st.pose_anchor.copy_(st.kf_pose[0])
    st.scale_anchor.copy_(torch.dot(st.knm_colmean[0], st.logzm[0]))
    pb = pairs_mod.build_pairs(num_kf, kf_ts, ow_ts, dims.K, dims.P)
    pairs = (torch.as_tensor(pb.ref_kf.astype(np.int64), device=device),
             torch.as_tensor(pb.target_slot.astype(np.int64), device=device),
             torch.as_tensor(pb.valid, device=device))
    return st, pairs, K_intr
