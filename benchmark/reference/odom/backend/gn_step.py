"""One sliding-window Gauss-Newton step (port of como_tpu/odom/backend/gn_step.py).

Dense photometric BA over keyframe pairs and one-way frames, jointly over
SE(3) poses, affine brightness and sparse 3D landmarks whose GP-predicted
dense depths drive the photometric term, plus GP / pixel / log-depth /
gauge priors: scaffold -> dense prediction -> pair linearization -> priors
-> assembly -> Jacobi-scaled Cholesky -> retract.

The JAX code accumulates the pair blocks with `.at[i].add` scatters whose
indices repeat across pairs.  Here every such accumulation is a one-hot
matmul (pairs x frames), never index_add_/index_put_(accumulate=True):
those use atomics on CUDA, whose order changes from run to run, while the
matmuls give bitwise-equal results for equal inputs.  The landmark-space
expansion is the same one-hot selection matmul as in the JAX package.
A failed Cholesky yields NaN (linalg.cholesky) and the non-finite step is
zeroed, as in the JAX package.

The per-pair halves (_photo_residual, _photo_pair_blocks) give each pair
a result that does not depend on the other pairs of the call, bit for bit,
so that the sharded step (parallel/sharded.py), whose shards get fewer
pairs, equals the single step on the card too: on CUDA a batched
contraction's rounding depends on the batch count (cuBLAS picks its kernel
by it, seen on an H100 in the tap sum of ops/interp.bilinear_sample_frames
and the per-pair dot products here).  So, on every device: per-pose terms
are computed over every frame and then gathered; contractions over 3 to 6
terms are elementwise multiply-adds in a fixed order (_mac, _csum); the
contractions over a pair's dense sites run in chunks of
pair_chunk(dims.P) pairs (_pair_einsum), each call with the same shapes.
The chunk is the most even split of the window's pairs into chunks of at
most PAIR_CHUNK, so the default window (64 pairs) makes one call per
contraction, as an unchunked einsum does; the last call of a longer window
overlaps the one before it, and a shard with fewer pairs pads them with
zero pairs up to a chunk.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.geometry import lie
from benchmark.reference.odom.backend.robust import huber as _huber_w
from benchmark.reference.odom.window import WindowDims, WindowState
from benchmark.reference.ops import linalg
from benchmark.reference.ops.interp import bilinear_sample_frames
from benchmark.reference.ops.reduce import fast_mad_sigma_shards, histogram_median_rows


class GNStats(NamedTuple):
    total_err: torch.Tensor
    photo_err: torch.Tensor
    delta_norm: torch.Tensor
    grad_norm: torch.Tensor


class SigmaStatic(NamedTuple):
    """Sigma/mode set (values from config.SigmasConfig)."""
    mean_depth_prior: float = 1e-2
    scale_prior: float = 1e-4
    pose_prior: float = 1e-6
    gp_prior: float = 1e0
    log_depth_first: float = 1e0
    log_depth_all: float = 1e0
    pixel_first: float = 1e-2
    pixel_all: float = 3.33e-1
    log_depth_mode: str = "first_mean"
    pixel_mode: str = "first"
    far_depth_ratio: float = 50.0
    lm_step_frac: float = 0.25
    occlusion_thresh: float = 0.1
    estimate_affine: bool = True


PAIR_CHUNK = 64


def pair_chunk(P: int) -> int:
    """The pair-chunk size of a window with P pairs: the most even split
    into chunks of at most PAIR_CHUNK (see module doc)."""
    n = -(-P // PAIR_CHUNK)
    return -(-P // n)


def _mac(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """sum_k x[..., k, None] * a[..., k, :] by elementwise multiply-adds,
    k in order (see module doc)."""
    out = x[..., 0, None] * a[..., 0, :]
    for k in range(1, x.shape[-1]):
        out = torch.addcmul(out, x[..., k, None], a[..., k, :])
    return out


def _pair_einsum(eq: str, chunk: int, *ops: torch.Tensor) -> torch.Tensor:
    """torch.einsum over operands whose leading dim is the pair, in calls of
    exactly `chunk` pairs, so that each pair's result is that of such a
    call, however many pairs the caller has (see module doc).  The calls
    start at every multiple of `chunk` but the last, which ends at the last
    pair and keeps only the rows the one before it lacks (no operand is
    copied); fewer than `chunk` pairs (a shard's) are padded with zero pairs."""
    P = ops[0].shape[0]
    if P < chunk:
        ops = tuple(torch.cat([o, o.new_zeros((chunk - P,) + o.shape[1:])]) for o in ops)
    n = max(P, chunk)
    starts = list(range(0, n - chunk, chunk)) + [n - chunk]
    parts = [torch.einsum(eq, *(o[c:c + chunk] for o in ops)) for c in starts]
    if len(parts) == 1:
        return parts[0][:P]
    parts[-1] = parts[-1][starts[-2] + 2 * chunk - n:]
    return torch.cat(parts)


def _csum(x: torch.Tensor) -> torch.Tensor:
    """x summed over dim 1 (the channels) in order."""
    out = x[:, 0]
    for c in range(1, x.shape[1]):
        out = out + x[:, c]
    return out


def _onehot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., n) one-hot rows (a comparison: F.one_hot range-checks its
    input on the host, a sync per call on CUDA)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


# ---------------------------------------------------------------------------
# scaffold: landmarks -> per-KF anchors

def _scaffold(state: WindowState, K_intr, dims: WindowDims, far_ratio: float = 50.0):
    K, M = dims.K, dims.M
    pose = state.kf_pose
    Twc_inv = lie.invert_se3(pose)
    Rcw = Twc_inv[:, :3, :3]
    tcw = Twc_inv[:, :3, 3]
    Adj = lie.adjoint(pose)

    Pw = state.P_lm[state.anchor_lm]                        # (K, M, 3)
    Pc = torch.einsum("kij,kmj->kmi", Rcw, Pw) + tcw[:, None]

    fx, fy, cx, cy = K_intr[0, 0], K_intr[1, 1], K_intr[0, 2], K_intr[1, 2]
    med = state.median_depth[:, None]
    rx = (state.pm_first[..., 0] - cx) / fx
    ry = (state.pm_first[..., 1] - cy) / fy
    init_Pc = torch.stack([rx * med, ry * med, med.expand(rx.shape)], -1)
    init_Pw_km = torch.einsum("kij,kmj->kmi", pose[:, :3, :3], init_Pc) \
        + pose[:, None, :3, 3]
    w_first = (state.obs_ref & state.kf_valid[:, None]).to(Pw.dtype)
    sel_lm = _onehot(state.anchor_lm.reshape(-1), state.P_lm.shape[0], Pw.dtype)
    init_lm = sel_lm.T @ (init_Pw_km * w_first[..., None]).reshape(-1, 3)
    init_Pc_km = torch.einsum("kij,kmj->kmi", Rcw, init_lm[state.anchor_lm]) \
        + tcw[:, None]

    z = Pc[..., 2]
    z_bad = (z < 0.1 * med) | (z > far_ratio * med)
    Pc = torch.where(z_bad[..., None], init_Pc_km, Pc)
    z = torch.clamp(Pc[..., 2], min=1e-6)
    logzm = torch.log(z)

    u_pix = fx * Pc[..., 0] / z + cx
    v_pix = fy * Pc[..., 1] / z + cy
    pm = torch.stack([u_pix, v_pix], -1)
    zero = torch.zeros_like(z)
    dp_dPc = torch.stack([
        torch.stack([fx.expand(z.shape), zero, -(u_pix - cx)], -1),
        torch.stack([zero, fy.expand(z.shape), -(v_pix - cy)], -1),
    ], -2) / z[..., None, None]                              # (K, M, 2, 3)

    dPc_dTcw = torch.cat([
        -torch.einsum("kij,kmjl->kmil", Rcw, lie.skew(Pw)),
        Rcw[:, None].expand(Pw.shape[:2] + (3, 3)),
    ], -1)                                                   # (K, M, 3, 6)
    dPc_dTwc = torch.einsum("kmij,kjl->kmil", dPc_dTcw, -Adj)

    dz_dTwc = dPc_dTwc[:, :, 2, :]
    dz_dPw = Rcw[:, 2, :]
    dlogzm_dTwc = dz_dTwc / z[..., None]
    dp_dTwc = torch.einsum("kmij,kmjl->kmil", dp_dPc, dPc_dTwc)
    dp_dPw = torch.einsum("kmij,kjl->kmil", dp_dPc, Rcw)

    reinit_lm_w = sel_lm.T @ (z_bad & state.obs_ref & state.kf_valid[:, None]
                              ).to(Pw.dtype).reshape(-1)
    P_lm_new = torch.where((reinit_lm_w > 0)[:, None], init_lm, state.P_lm)

    return dict(Pc=Pc, z=z, logzm=logzm, pm=pm, dz_dPw=dz_dPw, dz_dTwc=dz_dTwc,
                dlogzm_dTwc=dlogzm_dTwc, dp_dTwc=dp_dTwc, dp_dPw=dp_dPw,
                Rcw=Rcw, Adj=Adj, P_lm_new=P_lm_new)


# ---------------------------------------------------------------------------
# dense reference points from anchors (GP prediction)

def _dense_points(state: WindowState, sc, K_intr, dims: WindowDims):
    Wk = state.dense_knm                                     # (K, ND, M)
    logzn = torch.einsum("knm,km->kn", Wk, sc["logzm"])
    z_n = torch.exp(logzn)
    fx, fy, cx, cy = K_intr[0, 0], K_intr[1, 1], K_intr[0, 2], K_intr[1, 2]
    rx = (state.dense_rc[..., 1] - cx) / fx
    ry = (state.dense_rc[..., 0] - cy) / fy
    ray = torch.stack([rx, ry, torch.ones_like(rx)], -1)
    Pc_n = z_n[..., None] * ray
    R = state.kf_pose[:, :3, :3]
    t = state.kf_pose[:, :3, 3]
    u = torch.einsum("kij,knj->kni", R, Pc_n)
    Pw_n = u + t[:, None]
    q = torch.einsum("knm,kmj->knj", Wk, sc["dlogzm_dTwc"])
    v = Wk / sc["z"][:, None, :]
    return dict(Pw_n=Pw_n, Pc_n=Pc_n, u=u, q=q, v=v, z_n=z_n, logzn=logzn)


# ---------------------------------------------------------------------------
# photometric pair linearization

def _photo(state, sc, dn, pairs_ref, pairs_tgt, pairs_valid, K_intr,
           dims: WindowDims, occl_thresh: float = 0.0,
           estimate_affine: bool = True):
    """Photometric blocks of the pairs: residuals, the robust MAD sigma
    over them, the per-pair Jacobian blocks, then their accumulation into
    frame grids.  The pair batch may be split into shards for the residual
    and per-pair halves (parallel/sharded.py); the sigma is then taken over
    every shard and the grids over every pair."""
    res = _photo_residual(state, sc, dn, pairs_ref, pairs_tgt, pairs_valid, K_intr,
                          dims, occl_thresh)
    blocks = _photo_pair_blocks(res, photo_sigma([res], res["r"].device), K_intr, dims,
                                estimate_affine)
    return _photo_grids(blocks, dims)


def photo_sigma(parts, device):
    """The robust photometric sigma (MAD of the valid residuals) over the
    residual halves of one or more pair shards, on `device`."""
    return fast_mad_sigma_shards(
        [p["r"] for p in parts], [p["valid_c"].expand(p["r"].shape) for p in parts],
        device) + 1e-12


_PHOTO_STATE_FIELDS = ("kf_pose", "kf_aff", "kf_img", "kf_valid", "ow_pose", "ow_aff",
                       "ow_img", "ow_valid", "dense_vals", "P_lm")
_PHOTO_DENSE_KEYS = ("Pw_n", "Pc_n", "u", "q", "v")


def photo_inputs(state, sc, dn, occl_thresh: float):
    """What _photo_residual reads of (state, sc, dn): the state fields, and
    the dense-point and scaffold entries (a shard's device needs only these;
    the full-image GP `Knm_full` only when the occlusion gate is on)."""
    fields = _PHOTO_STATE_FIELDS + (("Knm_full",) if occl_thresh > 0.0 else ())
    sc_keys = ("logzm",) if occl_thresh > 0.0 else ()
    return ({f: getattr(state, f) for f in fields}, {k: sc[k] for k in sc_keys},
            {k: dn[k] for k in _PHOTO_DENSE_KEYS})


def _photo_residual(state, sc, dn, pairs_ref, pairs_tgt, pairs_valid, K_intr,
                    dims: WindowDims, occl_thresh: float = 0.0):
    """First half of _photo: warped residuals and validity of the pairs,
    with what the block half reads.  `state` may be any object with the
    fields of photo_inputs."""
    K, C = dims.K, dims.C
    H_img, W_img = dims.H, dims.W
    fx, fy, cx, cy = K_intr[0, 0], K_intr[1, 1], K_intr[0, 2], K_intr[1, 2]

    pose_f = torch.cat([state.kf_pose, state.ow_pose], 0)
    aff_f = torch.cat([state.kf_aff, state.ow_aff], 0)
    img_f = torch.cat([state.kf_img, state.ow_img], 0)
    valid_f = torch.cat([state.kf_valid, state.ow_valid], 0)

    i, j = pairs_ref, pairs_tgt
    vals_i = state.dense_vals[i]                             # (P, C, ND)
    Pw_n = dn["Pw_n"][i]
    Pc_i = dn["Pc_n"][i]
    u_i = dn["u"][i]
    q_i = dn["q"][i]
    v_i = dn["v"][i]                                         # (P, ND, M)
    R_i = state.kf_pose[i, :3, :3]
    aff_i = state.kf_aff[i]

    aff_j = aff_f[j]
    # per frame, then per pair (a gather): the same bits however the pairs split
    Tcw_j = lie.invert_se3(pose_f)[j]
    Rcw_j = Tcw_j[:, :3, :3]
    tcw_j = Tcw_j[:, :3, 3]
    Adj_j = lie.adjoint(pose_f)[j]

    Pcj = _mac(Pw_n, Rcw_j.transpose(-1, -2)[:, None]) + tcw_j[:, None]
    zj = Pcj[..., 2]
    zj_safe = torch.where(zj > 1e-6, zj, torch.ones_like(zj))
    px = fx * Pcj[..., 0] / zj_safe + cx
    py = fy * Pcj[..., 1] / zj_safe + cy

    samp = bilinear_sample_frames(img_f, j, torch.stack([px, py], -1))
    I_t, gx, gy = samp[:, :C], samp[:, C:2 * C], samp[:, 2 * C:]

    valid = ((px >= 1) & (px < W_img - 1) & (py >= 1) & (py < H_img - 1)
             & (zj > 0) & pairs_valid[:, None] & state.kf_valid[i][:, None]
             & valid_f[j][:, None])

    if occl_thresh > 0.0:
        # gate residuals whose warped point lies behind the target KF's
        # own GP surface (nearest-neighbour lookup of the full-image GP)
        logz_tgt = torch.einsum("khm,km->kh", state.Knm_full, sc["logzm"])
        px_i = torch.clamp(torch.round(px).to(torch.int64), 0, W_img - 1)
        py_i = torch.clamp(torch.round(py).to(torch.int64), 0, H_img - 1)
        jk = torch.clamp(j, max=K - 1)
        lz_s = logz_tgt[jk[:, None], py_i * W_img + px_i]
        is_kf_tgt = (j < K)[:, None]
        occluded = is_kf_tgt & (torch.log(zj_safe) > lz_s + occl_thresh)
        valid = valid & ~occluded

    ea = torch.exp(aff_j[:, 0] - aff_i[:, 0])[:, None, None]
    vals_scaled = ea * vals_i
    r = I_t - vals_scaled + (aff_j[:, 1] - aff_i[:, 1])[:, None, None]

    return dict(i=i, j=j, r=r, valid_c=valid[:, None, :], vals_scaled=vals_scaled,
                px=px, py=py, zj_safe=zj_safe, gx=gx, gy=gy, Rcw_j=Rcw_j, Adj_j=Adj_j,
                R_i=R_i, Pw_n=Pw_n, Pc_i=Pc_i, u_i=u_i, q_i=q_i, v_i=v_i)


def _photo_pair_blocks(res, sigma, K_intr, dims: WindowDims, estimate_affine: bool = True):
    """Second half of _photo: robust weights under `sigma`, Jacobians and
    the per-pair Hessian / gradient blocks of one shard's _photo_residual,
    with the shard's photometric error."""
    M, ND, C = dims.M, dims.ND, dims.C
    fx, fy, cx, cy = K_intr[0, 0], K_intr[1, 1], K_intr[0, 2], K_intr[1, 2]
    i, j, r, valid_c, vals_scaled = (res[k] for k in ("i", "j", "r", "valid_c",
                                                      "vals_scaled"))
    px, py, zj_safe, gx, gy = (res[k] for k in ("px", "py", "zj_safe", "gx", "gy"))
    Rcw_j, Adj_j, R_i, Pw_n, Pc_i, u_i, q_i, v_i = (
        res[k] for k in ("Rcw_j", "Adj_j", "R_i", "Pw_n", "Pc_i", "u_i", "q_i", "v_i"))
    P, chunk = i.shape[0], pair_chunk(dims.P)
    w = _huber_w(r / sigma) * valid_c / (sigma * sigma * C)
    photo_err = torch.sum(w * r * r)

    zc = zj_safe[:, None, :]
    a_img = torch.stack([gx * fx, gy * fy], -1) / zc[..., None]   # (P,C,ND,2)
    pxc, pyc = px[:, None, :], py[:, None, :]
    dIt_dPcj = torch.stack([
        a_img[..., 0], a_img[..., 1],
        -(a_img[..., 0] * (pxc - cx) / fx + a_img[..., 1] * (pyc - cy) / fy),
    ], -1)                                                    # (P, C, ND, 3)

    dIt_dPwn = _mac(dIt_dPcj, Rcw_j[:, None, None])
    s = _mac(dIt_dPwn, u_i[:, None, :, :, None])[..., 0]

    aR = _mac(dIt_dPwn, R_i[:, None, None])
    rot_i = torch.linalg.cross(Pc_i[:, None].expand(aR.shape), aR)
    J_ti = torch.cat([rot_i, aR], -1) + s[..., None] * q_i[:, None]
    pre = torch.cat([torch.linalg.cross(Pw_n[:, None].expand(dIt_dPwn.shape),
                                        dIt_dPwn), dIt_dPwn], -1)
    J_tj = -_mac(pre, Adj_j[:, None, None])

    one = torch.ones_like(vals_scaled)
    if estimate_affine:
        vs_col, one_col = vals_scaled, one
    else:
        vs_col, one_col = torch.zeros_like(one), torch.zeros_like(one)
    J8_i = torch.cat([J_ti, vs_col[..., None], -one_col[..., None]], -1)
    J8_j = torch.cat([J_tj, -vs_col[..., None], one_col[..., None]], -1)

    Jw_i = J8_i * w[..., None]
    H_ii = _pair_einsum("pcnk,pcnl->pkl", chunk, Jw_i, J8_i)
    H_jj = _pair_einsum("pcnk,pcnl->pkl", chunk, J8_j * w[..., None], J8_j)
    H_ij = _pair_einsum("pcnk,pcnl->pkl", chunk, Jw_i, J8_j)
    g_i = -_pair_einsum("pcnk,pcn->pk", chunk, J8_i, w * r)
    g_j = -_pair_einsum("pcnk,pcn->pk", chunk, J8_j, w * r)

    ws = w * s
    wss_n = _csum(ws * s)
    wsr_n = _csum(ws * r)
    Hzm_p = _pair_einsum("pnm,pnl->pml", chunk, v_i * wss_n[..., None], v_i)
    Hi_zm = _pair_einsum("pcnk,pcnm->pkm", chunk, J8_i * ws[..., None],
                         v_i[:, None].expand(P, C, ND, M))
    Hj_zm = _pair_einsum("pcnk,pcnm->pkm", chunk, J8_j * ws[..., None],
                         v_i[:, None].expand(P, C, ND, M))
    g_zm_p = -_pair_einsum("pn,pnm->pm", chunk, wsr_n, v_i)
    return dict(i=i, j=j, H_ii=H_ii, H_jj=H_jj, H_ij=H_ij, g_i=g_i, g_j=g_j, Hzm_p=Hzm_p,
                Hi_zm=Hi_zm, Hj_zm=Hj_zm, g_zm_p=g_zm_p, photo_err=photo_err)


PAIR_BLOCK_KEYS = ("i", "j", "H_ii", "H_jj", "H_ij", "g_i", "g_j", "Hzm_p", "Hi_zm",
                   "Hj_zm", "g_zm_p")


def _photo_grids(blocks, dims: WindowDims):
    """Accumulate the per-pair blocks (all pairs, PAIR_BLOCK_KEYS) into the
    frame grids with one-hot matmuls (deterministic; see module doc):
    (HPP, gP, Hzm, HPzm, gzm, photo_err)."""
    K, O = dims.K, dims.O
    F_ = K + O
    i, j, H_ii, H_jj, H_ij, g_i, g_j, Hzm_p, Hi_zm, Hj_zm, g_zm_p = (
        blocks[k] for k in PAIR_BLOCK_KEYS)
    dtype = H_ii.dtype
    oi = _onehot(i, F_, dtype)                                # (P, F)
    oj = _onehot(j, F_, dtype)
    oik = oi[:, :K]
    HPP = (torch.einsum("pa,pb,pkl->abkl", oi, oi, H_ii)
           + torch.einsum("pa,pb,pkl->abkl", oj, oj, H_jj)
           + torch.einsum("pa,pb,pkl->abkl", oi, oj, H_ij)
           + torch.einsum("pa,pb,pkl->abkl", oj, oi, H_ij.transpose(-1, -2)))
    gP = oi.T @ g_i + oj.T @ g_j
    Hzm = torch.einsum("pk,pml->kml", oik, Hzm_p)
    HPzm = (torch.einsum("pf,pk,pam->fkam", oi, oik, Hi_zm)
            + torch.einsum("pf,pk,pam->fkam", oj, oik, Hj_zm))
    gzm = oik.T @ g_zm_p
    return HPP, gP, Hzm, HPzm, gzm, blocks["photo_err"]


# ---------------------------------------------------------------------------
# priors + global assembly

def _prior_mode_weights(mode: str, first_mask, info_first: float, info_all: float):
    first = first_mask.to(torch.float32)
    rest = 1.0 - first
    if mode in ("first", "first_mean"):
        w_H = info_first * first
        w_r = w_H
    elif mode == "first_curr":
        w_H = info_first * first
        w_r = torch.zeros_like(first)
    elif mode == "all_curr":
        w_H = info_all * torch.ones_like(first)
        w_r = torch.zeros_like(first)
    elif mode == "all_mean":
        w_H = info_all * torch.ones_like(first)
        w_r = w_H
    elif mode == "first_plus_rest_mean":
        w_H = info_first * first + info_all * rest
        w_r = w_H
    elif mode == "first_plus_rest_curr":
        w_H = info_first * first + info_all * rest
        w_r = info_first * first
    else:
        raise ValueError(f"unknown prior mode '{mode}'")
    return w_H, w_r


def _assemble(state: WindowState, sc, dn, photo, K_intr, dims: WindowDims, sigmas):
    K, O, M, L = dims.K, dims.O, dims.M, dims.L
    F_ = K + O
    dtype, dev = state.P_lm.dtype, state.P_lm.device
    HPP, gP, Hzm, HPzm, gzm, photo_err = photo

    kfv = state.kf_valid.to(dtype)
    z = sc["z"]
    inv_z = 1.0 / z
    A = sc["dlogzm_dTwc"]                                    # (K, M, 6)
    log_med = torch.log(torch.clamp(state.median_depth, min=1e-6))[:, None]
    total_err = photo_err

    # GP marginal-likelihood prior
    info = kfv / (sigmas.gp_prior ** 2)
    y = sc["logzm"] - log_med
    Kinv = state.Kmm_inv
    Kinv_y = torch.einsum("kmn,kn->km", Kinv, y)
    Dz = inv_z
    Hzm = Hzm + info[:, None, None] * (Dz[:, :, None] * Kinv * Dz[:, None, :])
    KinvA = torch.einsum("kmn,knj->kmj", Kinv, A)
    H_pose_gp = info[:, None, None] * torch.einsum("kmi,kmj->kij", A, KinvA)
    H_pose_zm_gp = info[:, None, None] * (
        torch.einsum("kmi,kmn->kin", A, Kinv) * Dz[:, None, :])
    g_pose_gp = -info[:, None] * torch.einsum("kmi,km->ki", A, Kinv_y)
    g_zm_gp = -info[:, None] * (Dz * Kinv_y)
    total_err = total_err + torch.sum(info * torch.einsum("km,km->k", y, Kinv_y))

    # log-depth prior (gated modes)
    wH_ld, wr_ld = _prior_mode_weights(
        sigmas.log_depth_mode, state.obs_ref,
        1.0 / (sigmas.log_depth_first ** 2), 1.0 / (sigmas.log_depth_all ** 2))
    wH_ld = wH_ld * kfv[:, None]
    wr_ld = wr_ld * kfv[:, None]
    r_ld = y
    Hzm = Hzm + torch.diag_embed(wH_ld * inv_z * inv_z)
    H_pose_ld = torch.einsum("km,kmi,kmj->kij", wH_ld, A, A)
    H_pose_zm_ld = torch.einsum("km,kmi->kim", wH_ld * inv_z, A)
    g_pose_ld = -torch.einsum("km,kmi->ki", wr_ld * r_ld, A)
    g_zm_ld = -wr_ld * inv_z * r_ld
    total_err = total_err + torch.sum(wr_ld * r_ld * r_ld)

    # scale prior on the oldest KF until the window fills
    not_full = (~state.window_full).to(dtype)
    info_s = not_full * kfv[0] / (sigmas.mean_depth_prior ** 2)
    c0 = state.knm_colmean[0]
    r_s = torch.dot(c0, sc["logzm"][0]) - state.scale_anchor
    dr_dzm0 = c0 * inv_z[0]
    dr_dT0 = torch.einsum("m,mi->i", c0, A[0])
    Hzm0 = Hzm[0] + info_s * torch.outer(dr_dzm0, dr_dzm0)
    Hzm = torch.cat([Hzm0[None], Hzm[1:]], 0)
    H_pose_s0 = info_s * torch.outer(dr_dT0, dr_dT0)
    H_pose_zm_s0 = info_s * torch.outer(dr_dT0, dr_dzm0)
    g_pose_s0 = -info_s * dr_dT0 * r_s
    g_zm_s0 = -info_s * dr_dzm0 * r_s
    total_err = total_err + info_s * r_s * r_s

    # pixel prior (gated modes): landmark-space 3x3 anchor blocks
    wH_px, wr_px = _prior_mode_weights(
        sigmas.pixel_mode, state.obs_ref,
        1.0 / (sigmas.pixel_first ** 2), 1.0 / (sigmas.pixel_all ** 2))
    wH_px = wH_px * kfv[:, None]
    wr_px = wr_px * kfv[:, None]
    r_pix = sc["pm"] - state.pm_first
    dp_dPw = sc["dp_dPw"]
    dp_dTwc = sc["dp_dTwc"]
    H_anchor_pix = torch.einsum("km,kmci,kmcj->kmij", wH_px, dp_dPw, dp_dPw)
    H_pose_pix = torch.einsum("km,kmci,kmcj->kij", wH_px, dp_dTwc, dp_dTwc)
    H_pose_anchor_pix = torch.einsum("km,kmci,kmcj->kmij", wH_px, dp_dTwc, dp_dPw)
    g_anchor_pix = -torch.einsum("km,kmci,kmc->kmi", wr_px, dp_dPw, r_pix)
    g_pose_pix = -torch.einsum("km,kmci,kmc->ki", wr_px, dp_dTwc, r_pix)
    total_err = total_err + torch.sum(wr_px * torch.sum(r_pix * r_pix, -1))

    # fold pose-side prior terms into the grids (unique indices)
    kf = torch.arange(K, device=dev)
    pose_extra = H_pose_gp + H_pose_ld + H_pose_pix
    pose_extra = torch.cat([(pose_extra[0] + H_pose_s0)[None], pose_extra[1:]], 0)
    HPP = HPP.clone()
    HPP[kf, kf, :6, :6] += pose_extra
    gP = gP.clone()
    gP[:K, :6] += g_pose_gp + g_pose_ld + g_pose_pix
    gP[0, :6] += g_pose_s0

    H_pose_zm = H_pose_zm_gp + H_pose_zm_ld
    H_pose_zm = torch.cat([(H_pose_zm[0] + H_pose_zm_s0)[None], H_pose_zm[1:]], 0)
    HPzm = HPzm.clone()
    HPzm[kf, kf, :6, :] += H_pose_zm
    gzm = gzm + g_zm_gp + g_zm_ld
    gzm = torch.cat([(gzm[0] + g_zm_s0)[None], gzm[1:]], 0)

    # gauge priors: oldest KF pose + affine
    info_pp = kfv[0] / (sigmas.pose_prior ** 2)
    xi_pp = lie.se3_log((lie.invert_se3(state.kf_pose[0]) @ state.pose_anchor)[None])[0]
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    HPP[0, 0, :6, :6] += info_pp * eye6
    gP[0, :6] += info_pp * xi_pp
    info_sc = kfv[0] / (sigmas.scale_prior ** 2)
    r_aff = state.kf_aff[0] - state.aff_anchor
    HPP[0, 0, 6, 6] += info_sc
    HPP[0, 0, 7, 7] += info_sc
    gP[0, 6:8] += -info_sc * r_aff
    total_err = total_err + info_pp * torch.sum(xi_pp ** 2) \
        + info_sc * torch.sum(r_aff ** 2)

    # expand anchor z-space blocks to landmark space (one-hot selection)
    e = sc["dz_dPw"]                                          # (K, 3)
    HLL = torch.einsum("kab,ki,kj->kaibj", Hzm, e, e)
    HLL = HLL + torch.einsum("kmij,mn->kminj", H_anchor_pix,
                             torch.eye(M, dtype=dtype, device=dev))
    HLL = HLL.reshape(K, 3 * M, 3 * M)
    HPL = torch.einsum("fkpm,ki->fkpmi", HPzm, e).reshape(F_, K, 8, 3 * M)
    HPL = HPL.clone()
    HPL[kf, kf, :6, :] += H_pose_anchor_pix.permute(0, 2, 1, 3).reshape(K, 6, 3 * M)

    gL = (gzm[:, :, None] * e[:, None, :] + g_anchor_pix).reshape(K, 3 * M)

    lm_idx = (3 * state.anchor_lm[..., None]
              + torch.arange(3, device=dev)[None, None, :]).reshape(K, 3 * M)
    sel = _onehot(lm_idx, 3 * L, dtype)                        # (K, 3M, 3L)
    HLL_g = torch.einsum("kaj,kaJ->jJ", torch.bmm(HLL, sel), sel)
    HPL_flat = HPL.permute(0, 2, 1, 3).reshape(8 * F_, K, 3 * M)
    G = torch.einsum("rka,kaJ->rJ", HPL_flat, sel)
    gl_g = torch.einsum("ka,kaJ->J", gL, sel)

    # frozen-landmark prior (marginalization surrogate)
    info_fz = state.window_full.to(dtype) / (sigmas.scale_prior ** 2)
    fz_mask = state.P_anchor_mask.to(dtype) * info_fz
    r_fz = state.P_lm - state.P_anchor_vals
    HLL_g = HLL_g + torch.diag(fz_mask.repeat_interleave(3))
    gl_g = gl_g + (-fz_mask[:, None] * r_fz).reshape(-1)
    total_err = total_err + torch.sum(fz_mask[:, None] * r_fz * r_fz)

    HPP_flat = HPP.permute(0, 2, 1, 3).reshape(8 * F_, 8 * F_)
    Hbig = torch.cat([torch.cat([HPP_flat, G], 1),
                      torch.cat([G.T, HLL_g], 1)], 0)
    gbig = torch.cat([gP.reshape(-1), gl_g])
    return Hbig, gbig, total_err


def _linearize(state, pairs_ref, pairs_tgt, pairs_valid, K_intr, dims, sigmas):
    sc = _scaffold(state, K_intr, dims, sigmas.far_depth_ratio)
    state = state.replace(P_lm=sc["P_lm_new"])
    dn = _dense_points(state, sc, K_intr, dims)
    photo = _photo(state, sc, dn, pairs_ref, pairs_tgt, pairs_valid, K_intr,
                   dims, occl_thresh=sigmas.occlusion_thresh,
                   estimate_affine=sigmas.estimate_affine)
    return state, sc, dn, photo


def gn_system(state: WindowState, pairs_ref, pairs_tgt, pairs_valid, K_intr,
              dims: WindowDims, sigmas):
    """Assembled (H, g, total_err) of one linearization (tests/diagnostics)."""
    state, sc, dn, photo = _linearize(state, pairs_ref, pairs_tgt, pairs_valid,
                                      K_intr, dims, sigmas)
    return _assemble(state, sc, dn, photo, K_intr, dims, sigmas)


def _gn_step_impl(state: WindowState, pairs_ref, pairs_tgt, pairs_valid,
                  K_intr, dims: WindowDims, sigmas, damping=1e-6):
    """One GN iteration -> (new state, GNStats).  The input state is not
    modified; unchanged fields are shared with the output."""
    state, sc, dn, photo = _linearize(state, pairs_ref, pairs_tgt, pairs_valid,
                                      K_intr, dims, sigmas)
    return _finish(state, sc, dn, photo, K_intr, dims, sigmas, damping)


def _finish(state: WindowState, sc, dn, photo, K_intr, dims: WindowDims,
            sigmas, damping):
    K, O, M, L = dims.K, dims.O, dims.M, dims.L
    F_ = K + O
    D = dims.D
    dtype, dev = state.P_lm.dtype, state.P_lm.device
    photo_err = photo[5]
    Hbig, gbig, total_err = _assemble(state, sc, dn, photo, K_intr, dims, sigmas)

    pose_dim_valid = torch.cat([state.kf_valid, state.ow_valid]).repeat_interleave(8)
    lm_dim_valid = state.lm_valid.repeat_interleave(3)
    dim_valid = torch.cat([pose_dim_valid, lm_dim_valid]).to(dtype)
    Hbig = Hbig * dim_valid[:, None] * dim_valid[None, :]
    Hbig = Hbig + torch.diag(1.0 - dim_valid)
    gbig = gbig * dim_valid

    # Jacobi scaling: solve (S H S)(S^-1 delta) = S g with S = diag(H)^-1/2
    dH = torch.diagonal(Hbig)
    s = torch.rsqrt(torch.clamp(dH, min=1e-20))
    Hs = Hbig * s[:, None] * s[None, :]
    Hs = Hs + damping * torch.eye(D, dtype=dtype, device=dev)
    gs_ = s * gbig
    Lc = linalg.cholesky(Hs)
    delta = linalg.chol_solve(Lc, gs_[:, None])[:, 0]
    delta = s * delta
    delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))

    d_kf = delta[: 8 * K].reshape(K, 8)
    d_ow = delta[8 * K: 8 * F_].reshape(O, 8)
    d_lm = delta[8 * F_:].reshape(L, 3)
    # landmark trust region: cap each step at lm_step_frac x scene scale
    kfw = state.kf_valid.to(dtype)
    scene_scale = torch.sum(state.median_depth * kfw) / torch.clamp(kfw.sum(), min=1.0)
    cap = sigmas.lm_step_frac * scene_scale
    d_norm = torch.linalg.norm(d_lm, dim=-1, keepdim=True)
    d_lm = d_lm * torch.clamp(cap / torch.clamp(d_norm, min=1e-12), max=1.0)
    kf_pose = state.kf_pose @ lie.se3_exp(d_kf[:, :6])
    ow_pose = state.ow_pose @ lie.se3_exp(d_ow[:, :6])
    state = state.replace(
        kf_pose=torch.where(state.kf_valid[:, None, None], kf_pose, state.kf_pose),
        kf_aff=state.kf_aff + d_kf[:, 6:] * state.kf_valid[:, None],
        ow_pose=torch.where(state.ow_valid[:, None, None], ow_pose, state.ow_pose),
        ow_aff=state.ow_aff + d_ow[:, 6:] * state.ow_valid[:, None],
        P_lm=state.P_lm + d_lm * state.lm_valid[:, None],
        logzm=sc["logzm"], pm=sc["pm"],
    )
    # median depths from the dense-site GP prediction
    med_new = histogram_median_rows(dn["z_n"], state.kf_valid[:, None].expand(dn["z_n"].shape))
    state = state.replace(median_depth=torch.where(state.kf_valid, med_new,
                                                   state.median_depth))
    stats = GNStats(total_err=total_err, photo_err=photo_err,
                    delta_norm=torch.linalg.norm(delta),
                    grad_norm=torch.linalg.norm(gbig))
    return state, stats
