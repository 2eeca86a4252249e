"""Mapping backend: sliding-window keyframe BA bookkeeping (port of
como_tpu/odom/mapping.py).

Two-frame bootstrap, keyframe / one-way insertion (correspondence +
GP-predictor prep + window shift) and the GN iteration.  Host code does
the bookkeeping (timestamps, landmark slots, pair lists); tensor work runs
on the mapping device.  Insertion writes the window's slots in place (see
odom/window.py); values handed out of the window are clones.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from como_tpu_torch.config import MappingConfig
from como_tpu_torch.geometry import affine, lie, transforms
from como_tpu_torch.gp import kernels, sampler
from como_tpu_torch.net.depthcov import DepthCovPrior
from como_tpu_torch.odom import window as win
from como_tpu_torch.odom.backend import pairs as pairs_mod
from como_tpu_torch.odom.backend.gn_step import SigmaStatic, _gn_step_impl
from como_tpu_torch.odom.frontend import corr as corr_mod
from como_tpu_torch.odom.frontend import sfm as sfm_mod
from como_tpu_torch.ops import image as img_ops
from como_tpu_torch.ops import linalg
from como_tpu_torch.ops.coords import coord_grid_rc, normalize_coords
from como_tpu_torch.parallel import sharded
from como_tpu_torch.utils.log import NULL_LOG
from como_tpu_torch.utils.profiling import RECORDER


def prep_keyframe(rgb, cov_img, coords_m_xy, K, scale, nms_window: int, C: int = 1):
    """Per-KF tensors: img+grads, GP predictor, dense-site cache."""
    H, W = rgb.shape[-2:]
    dtype, dev = rgb.dtype, rgb.device
    gray = img_ops.rgb_to_gray(rgb)
    photo_img = gray if C == 1 else rgb
    iag = img_ops.img_and_grads(photo_img)[0]
    gray_iag = iag if C == 1 else img_ops.img_and_grads(gray)[0]

    rc_m = torch.stack([coords_m_xy[:, 1], coords_m_xy[:, 0]], -1)
    m_norm = normalize_coords(rc_m, [H, W])
    e_m = kernels.interpolate_cov_params(cov_img, m_norm)
    M = coords_m_xy.shape[0]
    K_mm = kernels.cross_covariance(m_norm, e_m, m_norm, e_m, scale)
    L_mm = linalg.cholesky(K_mm + 1e-6 * torch.eye(M, dtype=dtype, device=dev))
    Kmm_inv = linalg.cholesky_inverse(L_mm)

    rc_all = coord_grid_rc((H, W), dtype, dev)
    n_norm = normalize_coords(rc_all, [H, W])
    e_n = cov_img.reshape(3, -1).T
    K_nm = kernels.cross_covariance(n_norm, e_n, m_norm, e_m, scale)
    Knm_full = K_nm @ Kmm_inv                                # (HW, M)
    colmean = torch.mean(Knm_full, 0)

    # dense photometric sites: max-gradient pixel per nms_window^2 window
    gmag2 = gray_iag[1] ** 2 + gray_iag[2] ** 2
    nw = nms_window
    g4 = gmag2.reshape(H // nw, nw, W // nw, nw).permute(0, 2, 1, 3)
    g4 = g4.reshape(H // nw, W // nw, nw * nw)
    arg = torch.argmax(g4, -1)
    rows = (torch.arange(H // nw, device=dev)[:, None] * nw + arg // nw).reshape(-1)
    cols = (torch.arange(W // nw, device=dev)[None, :] * nw + arg % nw).reshape(-1)
    dense_rc = torch.stack([rows, cols], -1).to(dtype)
    flat_idx = rows * W + cols
    dense_vals = photo_img[0].reshape(C, -1)[:, flat_idx]
    dense_knm = Knm_full[flat_idx]
    return dict(iag=iag, Kmm_inv=Kmm_inv, L_mm=L_mm, Knm_full=Knm_full,
                knm_colmean=colmean, dense_rc=dense_rc, dense_vals=dense_vals,
                dense_knm=dense_knm)


# --- window-state updates (in place) -----------------------------------------

_KF_FIELDS = ["kf_pose", "kf_aff", "kf_valid", "kf_img", "kf_rgb", "cov_img",
              "Kmm_inv", "L_mm", "Knm_full", "knm_colmean", "dense_rc",
              "dense_vals", "dense_knm", "pm_first", "pm", "obs_ref",
              "anchor_lm", "logzm", "median_depth"]
_OW_FIELDS = ["ow_pose", "ow_aff", "ow_img", "ow_valid"]


def _roll_left(a: torch.Tensor) -> None:
    """a <- concat(a[1:], a[-1:]) in place."""
    a[:-1] = a[1:].clone()


def _write_kf(st, slot: int, pose, aff, prep, rgb, cov_img, coords_xy, logzm,
              obs_ref, lm_row, Pw_new, new_mask):
    st.kf_pose[slot] = pose
    st.kf_aff[slot] = aff
    st.kf_img[slot] = prep["iag"]
    st.kf_rgb[slot] = rgb[0]
    st.cov_img[slot] = cov_img
    for f in ("Kmm_inv", "L_mm", "Knm_full", "knm_colmean", "dense_rc",
              "dense_vals", "dense_knm"):
        getattr(st, f)[slot] = prep[f]
    st.pm_first[slot] = coords_xy
    st.pm[slot] = coords_xy
    st.obs_ref[slot] = obs_ref
    st.anchor_lm[slot] = lm_row
    st.logzm[slot] = logzm
    st.P_lm[lm_row] = torch.where(new_mask[:, None], Pw_new, st.P_lm[lm_row])
    st.lm_valid[lm_row] = st.lm_valid[lm_row] | new_mask
    # this KF's median depth from its full-image GP prediction
    logz = st.Knm_full[slot] @ logzm
    st.median_depth[slot] = linalg.median(torch.exp(logz))


def _roll_kf(st, released_mask):
    for f in _KF_FIELDS:
        _roll_left(getattr(st, f))
    st.lm_valid &= ~released_mask


def _finalize_kf(st, slot: int, window_full: bool, reanchor: bool, fix_mask):
    st.kf_valid[slot] = True
    st.window_full.fill_(window_full)
    if reanchor:
        st.pose_anchor.copy_(st.kf_pose[0])
        st.kf_aff -= st.kf_aff[0].clone()[None]
        st.aff_anchor.zero_()
    if window_full:
        st.P_anchor_mask.copy_(fix_mask)
        st.P_anchor_vals.copy_(st.P_lm)


def dense_depth_image(Knm_full, logzm, hw):
    """(H, W) depth image of one keyframe from its GP predictor."""
    return torch.exp(Knm_full @ logzm).reshape(hw)


def _anchors_world(pose, coords_xy, z, K):
    ray = torch.stack([(coords_xy[:, 0] - K[0, 2]) / K[0, 0],
                       (coords_xy[:, 1] - K[1, 2]) / K[1, 1],
                       torch.ones_like(z)], -1)
    return (z[:, None] * ray) @ pose[:3, :3].T + pose[:3, 3]


def _compose_world(kf_pose_k, kf_aff_k, pose_rel, aff_rel):
    pose_w = transforms.get_T_w_curr(kf_pose_k[None], pose_rel[None])[0]
    aff_w = affine.get_aff_w_curr(kf_aff_k[None, :, None], aff_rel[None, :, None])[0, :, 0]
    return lie.normalize_rotation(pose_w), aff_w


def _prep_ow_img(rgb, C: int = 1):
    img = img_ops.rgb_to_gray(rgb) if C == 1 else rgb
    return img_ops.img_and_grads(img)[0]


def _sfm_pyr3(rgb, start: int, end: int):
    pyr = img_ops.image_pyramid(img_ops.rgb_to_gray(rgb), start, end)
    return [img_ops.img_and_grads(p)[0] for p in pyr]


def _corr_and_prep(pose_last, pose_init, pm_last, logzm_last, Knm_full_last, rgb,
                   cov_img, K, scale, M: int, ccfg, nms_window: int, hw,
                   generator=None, C: int = 1):
    """Keyframe-insertion compute: last-KF dense depth -> anchor
    correspondence/distill -> new-KF GP predictor prep."""
    depth_last = torch.exp(Knm_full_last @ logzm_last).reshape(hw)
    res = corr_mod.track_and_init(pose_last, pose_init, pm_last, logzm_last,
                                  depth_last, cov_img, K, scale, M, ccfg, generator)
    prep = prep_keyframe(rgb, cov_img, res.coords_all, K, scale, nms_window, C)
    Pw_new = _anchors_world(pose_init, res.coords_all,
                            torch.clamp(res.z_all, min=1e-9), K)
    return res, prep, Pw_new


def sample_initial_anchors(cov_img, scale, M: int, border: int, dist_thresh: float,
                           stdev_thresh: float, fixed_var: float,
                           mode: str = "greedy_conditional_entropy", generator=None):
    """(M, 2) row/col anchor coords, by greedy conditional entropy or
    (sampling.mode "random_uniform", reading `generator`) uniformly."""
    dom_norm, e_dom, dom_valid, dom_rc = sampler.full_image_domain(cov_img, border)
    if mode == "random_uniform":
        idx, _ = sampler.random_uniform_sample(generator, dom_valid, M)
        return dom_rc[idx]
    dtype, dev = dom_norm.dtype, dom_norm.device
    res = sampler.greedy_entropy_sample(
        dom_norm, e_dom, dom_valid,
        torch.zeros((M, 2), dtype=dtype, device=dev),
        torch.zeros((M, 3), dtype=dtype, device=dev),
        torch.zeros((M,), dtype=torch.bool, device=dev),
        torch.zeros((M,), dtype=dtype, device=dev),
        signal_var=scale, fixed_var=fixed_var, max_stdev_thresh=stdev_thresh,
        dist_thresh=dist_thresh, num_slots=M, terminate_early=False)
    return dom_rc[torch.clamp(res.domain_inds, min=0)]


class Mapping:
    def __init__(self, cfg: MappingConfig, intrinsics, img_size, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        # multi-device BA (cfg.mesh_devices >= 2): every GN step splits the
        # pairs over the mesh (parallel/sharded.py): cuda:0 .. cuda:N-1 for a
        # CUDA engine, N shards on the CPU for a CPU one
        self.mesh = None
        n = cfg.mesh_devices
        if n >= 2:
            if self.device.type == "cuda":
                avail = torch.cuda.device_count()
                if avail < n:
                    raise RuntimeError(f"mapping.mesh_devices={n} but only {avail} CUDA "
                                       "devices are visible")
                self.mesh = [torch.device("cuda", i) for i in range(n)]
            else:
                self.mesh = [self.device] * n
        self.K = torch.as_tensor(intrinsics, dtype=torch.float32).to(self.device)
        self.img_size = tuple(img_size)
        self.is_init = False
        self.log = NULL_LOG

    # -- setup ------------------------------------------------------------
    def setup(self):
        cfg = self.cfg
        pc = cfg.photo_construction
        self._radius_mode = (pc.radius_thresh > 0.0) and (pc.degrees_thresh > 0.0)
        self.C = 3 if cfg.color == "rgb" else 1
        self.dims = win.make_dims(
            num_kf=cfg.graph.num_keyframes, num_ow=cfg.graph.num_one_way_frames,
            M=cfg.sampling.max_num_coords, img_size=self.img_size,
            nms_window=pc.nonmax_suppression_window,
            radius_pairs=self._radius_mode, channels=self.C)
        if self.mesh is not None:
            # round the pair capacity up so the pairs split evenly over the
            # mesh (the extra slots are invalid pairs)
            n = len(self.mesh)
            self.dims = self.dims._replace(P=-(-self.dims.P // n) * n)
        self.dtype = {"float32": torch.float32}[cfg.dtype]
        self.state = win.empty_state(self.dims, dtype=self.dtype, device=self.device)
        self.alloc = win.LandmarkAllocator(self.dims.L)
        self.anchor_lm_host = np.zeros((self.dims.K, self.dims.M), np.int64)
        self.kf_ts: List[float] = []
        self.ow_ts: List[float] = []
        self.num_kf = 0
        self.num_ow = 0
        self.prior = DepthCovPrior(mode=cfg.prior, model_path=cfg.model_path,
                                   device=self.device)
        self.scale = self.prior.scale
        self.corr_cfg = corr_mod.CorrStatic(
            corr_thresh=cfg.corr.corr_thresh, min_obs_depth=cfg.corr.min_obs_depth,
            logz_grad_mag_thresh=cfg.corr.logz_grad_mag_thresh,
            distill_with_prior=cfg.corr.distill_with_prior,
            max_stdev_thresh=cfg.sampling.max_stdev_thresh,
            border=cfg.sampling.border, dist_thresh=cfg.sampling.dist_thresh,
            fixed_var=cfg.sampling.fixed_var, sigma_median=cfg.sigmas.distill_median,
            corr_mode=cfg.corr.corr_mode, sample_mode=cfg.sampling.mode)
        s = cfg.sigmas
        self.sigmas = SigmaStatic(
            mean_depth_prior=s.mean_depth_prior, scale_prior=s.scale_prior,
            pose_prior=s.pose_prior, gp_prior=s.gp_prior,
            log_depth_first=s.log_depth_first, log_depth_all=s.log_depth_all,
            pixel_first=s.pixel_first, pixel_all=s.pixel_all,
            log_depth_mode=s.log_depth_mode, pixel_mode=s.pixel_mode,
            far_depth_ratio=s.far_depth_ratio, lm_step_frac=s.lm_step_frac,
            occlusion_thresh=s.occlusion_thresh, estimate_affine=cfg.estimate_affine)
        self.sfm_term = dict(max_iter=cfg.init.max_iter, delta_norm=cfg.init.delta_norm,
                             rel_tol=cfg.init.rel_tol)
        self._sfm_ref = None
        self._pairs = None
        self.converged = False
        self.iter_count = 0
        self.total_iters = 0
        self._stats_hist = []
        self._prev_err = float("inf")
        self.damping = cfg.gn_damping
        self._sharded_step = None if self.mesh is None else sharded.make_sharded_gn_step(
            self.mesh, self.dims, self.sigmas, cfg.gn_damping)
        # (warm_start: the JAX package pre-runs every insertion program to
        # pay XLA compilation at setup; eager PyTorch has nothing to warm)

    def _eye4(self):
        return torch.eye(4, dtype=self.dtype, device=self.device)

    def _zeros(self, *shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)

    # -- two-frame bootstrap ------------------------------------------------
    def attempt_two_frame_init(self, timestamp, rgb) -> bool:
        with RECORDER.span("mapping.two_frame_init"):
            cfg = self.cfg
            if self._sfm_ref is None:
                cov_img = self.prior.cov_params(rgb)
                coords_m_rc = sample_initial_anchors(
                    cov_img, self.scale, self.dims.M, cfg.sampling.border,
                    cfg.sampling.dist_thresh, cfg.sampling.max_stdev_thresh,
                    cfg.sampling.fixed_var, mode=cfg.sampling.mode,
                    generator=torch.Generator().manual_seed(0))
                ref = sfm_mod.setup_reference(rgb, cov_img, coords_m_rc, self.K,
                                              self.scale, cfg.init.start_level,
                                              cfg.init.end_level)
                self._sfm_ref = dict(ref=ref, rgb=rgb, cov_img=cov_img,
                                     coords_m_rc=coords_m_rc, ts=timestamp,
                                     Tji=self._eye4(), logzm=self._zeros(self.dims.M))
                return False

            pyr3 = _sfm_pyr3(rgb, cfg.init.start_level, cfg.init.end_level)
            Tji, logzm, mean_logz, count, med = sfm_mod.sfm_align(
                self._sfm_ref["ref"], pyr3, self._sfm_ref["Tji"],
                self._sfm_ref["logzm"], self.sfm_term)
            self._sfm_ref["Tji"], self._sfm_ref["logzm"] = Tji, logzm

            n_pix = self.img_size[0] * self.img_size[1]
            with RECORDER.span("sync.two_frame_init"):
                host = torch.stack([count.to(self.dtype), torch.linalg.norm(Tji[:3, 3]),
                                    med]).cpu().numpy()
            frac = float(host[0]) / n_pix
            kf_dist, med_f = float(host[1]), float(host[2])
            if frac < cfg.init.kf_num_pixels_frac:
                self._sfm_ref = None     # lost overlap: re-seed the reference
                return False
            if kf_dist <= cfg.init.kf_depth_motion_ratio * med_f:
                return False

            r = self._sfm_ref
            self._init_keyframe(r["rgb"], r["cov_img"], r["coords_m_rc"], logzm, r["ts"])
            self.state.scale_anchor.copy_(mean_logz)
            pose2 = transforms.get_T_w_curr(self._eye4()[None], Tji[None])[0]
            self.add_keyframe(rgb, pose2, self._zeros(2), timestamp)
            self._sfm_ref = None
            self.is_init = True
            return True

    # -- keyframe insertion ---------------------------------------------------
    def _init_keyframe(self, rgb, cov_img, coords_m_rc, logzm, timestamp):
        M = self.dims.M
        coords_xy = torch.stack([coords_m_rc[:, 1], coords_m_rc[:, 0]], -1)
        prep = prep_keyframe(rgb, cov_img, coords_xy, self.K, self.scale,
                             self.dims.NW, self.C)
        self.anchor_lm_host[0] = self.alloc.alloc(M)
        pose = self._eye4()
        Pw = _anchors_world(pose, coords_xy, torch.exp(logzm), self.K)
        ones = torch.ones((M,), dtype=torch.bool, device=self.device)
        _write_kf(self.state, 0, pose, self._zeros(2), prep, rgb, cov_img,
                  coords_xy, logzm, ones,
                  torch.as_tensor(self.anchor_lm_host[0], device=self.device),
                  Pw, ones)
        self.kf_ts = [timestamp]
        self.num_kf = 1
        _finalize_kf(self.state, 0, False, True,
                     self._zeros(self.dims.L, dtype=torch.bool))
        self._rebuild_pairs()

    def add_keyframe_dispatch(self, rgb, pose_init, aff_init, timestamp):
        """Phase 1: prior + correspondence + predictor prep, and copy the
        (small) arrays the host bookkeeping reads to the host."""
        st = self.state
        last = self.num_kf - 1
        with RECORDER.span("mapping.prior"):
            cov_img = self.prior.cov_params(rgb)
        with RECORDER.span("mapping.corr_and_prep"):
            res, prep, Pw_new = _corr_and_prep(
                st.kf_pose[last], pose_init, st.pm[last], st.logzm[last],
                st.Knm_full[last], rgb, cov_img, self.K, self.scale, self.dims.M,
                self.corr_cfg, self.dims.NW, self.img_size,
                torch.Generator().manual_seed(len(self.kf_ts) + len(self.ow_ts)), self.C)
        host = torch.stack([res.tracked.to(torch.int64), res.src_anchor])
        with RECORDER.span("sync.insert_host"):
            host = host.to("cpu", non_blocking=False)
        return dict(rgb=rgb, pose_init=pose_init, aff_init=aff_init, ts=timestamp,
                    cov_img=cov_img, res=res, prep=prep, Pw_new=Pw_new, host=host)

    def add_keyframe_finalize(self, pend):
        """Phase 2: landmark-slot bookkeeping (host) + window writes."""
        M, Kdim = self.dims.M, self.dims.K
        dev = self.device
        res, prep, Pw_new = pend["res"], pend["prep"], pend["Pw_new"]
        last = self.num_kf - 1
        host = pend["host"].numpy()
        tracked = host[0].astype(bool)
        src = host[1]
        n_new = int((~tracked).sum())

        new_row = np.zeros(M, np.int64)
        new_row[tracked] = self.anchor_lm_host[last][src[tracked]]
        shifting = self.num_kf >= Kdim
        rel_mask = np.zeros(self.dims.L, bool)
        if shifting:
            dropped = self.anchor_lm_host[0].copy()
            self.anchor_lm_host[:-1] = self.anchor_lm_host[1:]
            referenced = np.unique(np.concatenate(
                [self.anchor_lm_host[: Kdim - 1].reshape(-1), new_row[tracked]]))
            released = np.setdiff1d(dropped, referenced)
            self.alloc.release(released)
            new_row[~tracked] = self.alloc.alloc(n_new)
            self.anchor_lm_host[-1] = new_row
            slot = Kdim - 1
            self.kf_ts = self.kf_ts[1:] + [pend["ts"]]
            rel_mask[released] = True
        else:
            new_row[~tracked] = self.alloc.alloc(n_new)
            slot = self.num_kf
            self.anchor_lm_host[slot] = new_row
            self.kf_ts.append(pend["ts"])
            self.num_kf += 1

        window_full = self.num_kf >= Kdim
        fix = np.zeros(self.dims.L, bool)
        if window_full:
            fix[self.anchor_lm_host[0]] = True
        st = self.state
        if shifting:
            _roll_kf(st, torch.as_tensor(rel_mask, device=dev))
        new_mask = torch.as_tensor(~tracked, device=dev)
        _write_kf(st, slot, pend["pose_init"], pend["aff_init"], prep, pend["rgb"],
                  pend["cov_img"], res.coords_all,
                  torch.log(torch.clamp(res.z_all, min=1e-9)), new_mask,
                  torch.as_tensor(new_row, device=dev), Pw_new, new_mask)
        _finalize_kf(st, slot, window_full, window_full, torch.as_tensor(fix, device=dev))
        self.prune_one_way()
        self._rebuild_pairs()
        self.converged = False
        self.iter_count = 0
        self._stats_hist = []
        self._prev_err = float("inf")

    def add_keyframe(self, rgb, pose_init, aff_init, timestamp):
        with RECORDER.span("mapping.add_keyframe"):
            pend = self.add_keyframe_dispatch(rgb, pose_init, aff_init, timestamp)
            with RECORDER.span("mapping.finalize"):
                self.add_keyframe_finalize(pend)
            RECORDER.count("mapping.keyframes")

    # -- one-way frames -------------------------------------------------------
    def add_one_way_frame(self, rgb, pose_init, aff_init, timestamp):
        with RECORDER.span("mapping.add_one_way_frame"):
            O = self.dims.O
            iag = _prep_ow_img(rgb, self.C)
            st = self.state
            if self.num_ow >= O:
                self.ow_ts = self.ow_ts[1:]
                self.num_ow -= 1
                for f in _OW_FIELDS:
                    _roll_left(getattr(st, f))
            slot = self.num_ow
            self.ow_ts.append(timestamp)
            self.num_ow += 1
            st.ow_pose[slot] = pose_init
            st.ow_aff[slot] = aff_init
            st.ow_img[slot] = iag
            st.ow_valid[slot] = True
            self._rebuild_pairs()
            self.converged = False
            RECORDER.count("mapping.one_way_frames")

    def prune_one_way(self):
        """Drop one-way frames older than the oldest keyframe."""
        if not self.kf_ts:
            return
        oldest = self.kf_ts[0]
        r = 0
        for i, t in enumerate(self.ow_ts):
            if t < oldest:
                r = i + 1
        if r == 0:
            return
        keep = self.num_ow - r
        st = self.state
        for f in ("ow_pose", "ow_aff", "ow_img"):
            a = getattr(st, f)
            a.copy_(torch.roll(a, -r, 0))
        st.ow_valid.copy_(torch.arange(self.dims.O, device=self.device) < keep)
        self.ow_ts = self.ow_ts[r:]
        self.num_ow = keep

    # -- frame-in handlers ----------------------------------------------------
    def find_kf_from_timestamp(self, ts):
        for i in range(len(self.kf_ts) - 1, -1, -1):
            if self.kf_ts[i] == ts:
                return i
        return len(self.kf_ts) - 1

    def handle_tracking_data(self, data):
        with RECORDER.span("mapping.handle_tracking_data"):
            kind, rgb, pose_curr_kf, aff_curr_kf, kf_ts, ts = data
            k = self.find_kf_from_timestamp(float(kf_ts))
            pose_w, aff_w = _compose_world(self.state.kf_pose[k], self.state.kf_aff[k],
                                           pose_curr_kf, aff_curr_kf)
            if kind == "keyframe":
                self.add_keyframe(rgb, pose_w, aff_w, ts)
                return True
            self.add_one_way_frame(rgb, pose_w, aff_w, ts)
            return False

    # -- GN iteration ---------------------------------------------------------
    def _rebuild_pairs(self):
        kwargs = {}
        if self._radius_mode and self.num_kf > 0:
            pc = self.cfg.photo_construction
            with RECORDER.span("sync.rebuild_pairs"):
                kwargs = dict(
                    poses=self.state.kf_pose[: self.num_kf].cpu().numpy(),
                    median_depths=self.state.median_depth[: self.num_kf].cpu().numpy(),
                    ow_poses=self.state.ow_pose[: self.num_ow].cpu().numpy()
                    if self.num_ow else None,
                    radius_thresh=pc.radius_thresh, degrees_thresh=pc.degrees_thresh)
        pb = pairs_mod.build_pairs(self.num_kf, self.kf_ts, self.ow_ts,
                                   self.dims.K, self.dims.P, **kwargs)
        self._pairs = tuple(torch.as_tensor(a, device=self.device) for a in
                            (pb.ref_kf.astype(np.int64), pb.target_slot.astype(np.int64),
                             pb.valid))

    def should_iterate(self) -> bool:
        """Convergence gate: after each insertion up to max_iter iterations,
        stopping early on delta_norm / rel_tol / abs_tol, judged every 4
        iterations from the stats of one check period before."""
        if self.converged or not self.is_init:
            return False
        term = self.cfg.term_criteria
        if self.iter_count >= term.max_iter:
            self.converged = True
            return False
        if self.iter_count > 0 and self.iter_count % 4 == 0:
            cand = [s for it, s in self._stats_hist if it <= self.iter_count - 4]
            if not cand:
                return True
            with RECORDER.span("sync.should_iterate"):
                vals = torch.stack(list(cand[-1])).cpu().numpy()
            err, delta, grad = float(vals[0]), float(vals[2]), float(vals[3])
            rel = abs(self._prev_err - err) / max(self._prev_err, 1e-20)
            self._prev_err = err
            if (delta < term.delta_norm or rel < term.rel_tol
                    or err < term.abs_tol or grad < term.grad_norm):
                self.converged = True
                return False
        return True

    def note_iteration(self, stats):
        """Bookkeeping for a GN iteration (run here or in the engine)."""
        self.iter_count += 1
        self.total_iters += 1
        self._stats_hist.append((self.iter_count, stats))
        del self._stats_hist[:-8]

    @property
    def uses_mesh(self) -> bool:
        return self.mesh is not None

    def iterate(self):
        """One GN iteration on the window: the step the sequential engine
        runs beside each frame's tracking, with the same bookkeeping;
        sharded over the mesh where there is one."""
        if self._sharded_step is not None:
            self.state, stats = self._sharded_step(self.state, *self._pairs, self.K,
                                                   self.damping)
        else:
            self.state, stats = _gn_step_impl(self.state, *self._pairs, self.K, self.dims,
                                              self.sigmas, self.damping)
        self.note_iteration(stats)
        return stats

    def maybe_iterate(self):
        return self.iterate() if self.should_iterate() else None

    # -- data out ----------------------------------------------------------------
    def get_kf_ref_data(self, num_ref: int = 1):
        """(timestamps, rgb, pose, aff, depth) of the trailing num_ref KFs,
        cloned out of the window."""
        with RECORDER.span("mapping.get_kf_ref_data"):
            st = self.state
            lo = max(0, self.num_kf - num_ref)
            idx = slice(lo, self.num_kf)
            logz = torch.einsum("rnm,rm->rn", st.Knm_full[idx], st.logzm[idx])
            depth = torch.exp(logz).reshape((self.num_kf - lo,) + self.img_size)[:, None]
            return (self.kf_ts[lo:self.num_kf], st.kf_rgb[idx].clone(),
                    st.kf_pose[idx].clone(), st.kf_aff[idx].clone(), depth)

    def get_kf_viz_data(self):
        """What a viewer draws: per-keyframe images, poses, dense depths
        and anchors, the landmarks, the one-way poses and the pair graph.
        Tensors are cloned out of the window."""
        st = self.state
        n = self.num_kf
        depth = torch.stack([dense_depth_image(st.Knm_full[i], st.logzm[i], self.img_size)
                             for i in range(n)])[:, None]
        pr, pt, pv = (a.cpu().numpy() for a in self._pairs)
        kf_pairs = [(int(r), int(t)) for r, t, v in zip(pr, pt, pv)
                    if v and t < self.dims.K]
        ow_pairs = [(int(r), int(t) - self.dims.K) for r, t, v in zip(pr, pt, pv)
                    if v and t >= self.dims.K]
        return dict(timestamps=list(self.kf_ts), rgbs=st.kf_rgb[:n].clone(),
                    poses=st.kf_pose[:n].clone(), depths=depth,
                    sparse_pm=st.pm[:n].clone(), P_lm=st.P_lm.clone(),
                    lm_valid=st.lm_valid.clone(), obs_ref=st.obs_ref[:n].clone(),
                    ow_poses=st.ow_pose[: self.num_ow].clone(),
                    kf_pairs=kf_pairs, ow_pairs=ow_pairs)
