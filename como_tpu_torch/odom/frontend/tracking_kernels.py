"""Inverse-compositional photometric tracking (port of
como_tpu/odom/frontend/tracking_kernels.py).

Coarse-to-fine IC alignment of the current frame against the keyframe
reference: per iteration warp -> bilinear sample -> Huber/MAD 8x8 GN solve
-> T <- T exp(-delta), aff -= delta.

The JAX `lax.while_loop` per pyramid level becomes a Python loop of exactly
`max_iter` iterations with an on-device `done` flag: once the convergence
test fires, torch.where freezes (T, aff) at the values of the iteration
that fired, which is the state the while-loop returns.  No value is read
back to the host inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from como_tpu_torch.geometry import lie
from como_tpu_torch.geometry.camera import project, transform_project
from como_tpu_torch.odom.backend.robust import huber as huber_weight
from como_tpu_torch.ops import linalg
from como_tpu_torch.ops.interp import bilinear_sample
from como_tpu_torch.ops.reduce import fast_mad_sigma
from como_tpu_torch.utils.profiling import RECORDER


class TrackLevel(NamedTuple):
    vals: torch.Tensor   # (N,) reference intensities at sample sites
    P: torch.Tensor      # (N, 3) 3D points in the reference KF frame
    J_ic: torch.Tensor   # (N, 8) IC Jacobian dI/d[xi(6), a, b]
    mask: torch.Tensor   # (N,) sample validity
    K: torch.Tensor      # (3, 3) level intrinsics


class TermStatic(NamedTuple):
    max_iter: int
    delta_norm: float
    rel_tol: float
    grad_norm: float
    abs_tol: float = 0.0
    estimate_affine: bool = True


def precalc_ic_jacobians(grads: torch.Tensor, P: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) IC Jacobians at identity from grads (..., N, 2), P (..., N, 3)."""
    _, dp_dP = project(K, P)                                        # (..., N, 2, 3)
    eye = torch.eye(3, dtype=P.dtype, device=P.device).expand(P.shape[:-1] + (3, 3))
    dP_dxi = torch.cat([-lie.skew(P), eye], -1)                    # (..., N, 3, 6)
    dI_dxi = (grads[..., None, :] @ (dp_dP @ dP_dxi))[..., 0, :]   # (..., N, 6)
    ab = torch.cat([torch.zeros_like(P[..., :1]), torch.ones_like(P[..., :1])], -1)
    return torch.cat([dI_dxi, ab], -1)


def _gn_iter(Tji, aff, lvl: TrackLevel, img_j, term: TermStatic):
    C, H, W = img_j.shape
    N = lvl.vals.shape[0]
    Np = N // C
    dtype, dev = lvl.vals.dtype, lvl.vals.device
    p, z = transform_project(lvl.K, Tji[None], lvl.P[None])
    p, z = p[0], z[0, :, 0]
    x, y = p[..., 0], p[..., 1]
    valid = ((x >= 1) & (x < W - 1) & (y >= 1) & (y < H - 1) & (z > 0) & lvl.mask)
    pc = p.reshape(C, Np, 2)
    I_t = torch.cat([bilinear_sample(img_j[c:c + 1], pc[c], "zeros")[0]
                     for c in range(C)])                              # (N,)
    a, b = aff[0], aff[1]
    tmp = torch.exp(-a) * I_t
    r = tmp + b - lvl.vals
    J = lvl.J_ic.clone()
    J[:, 6] = -tmp
    if not term.estimate_affine:
        J[:, 6:] = 0.0
    sigma = fast_mad_sigma(r, valid) + 1e-12
    w = huber_weight(r / sigma) * valid / (sigma * sigma)
    Jw = J * w[:, None]
    Hm = Jw.T @ J
    g = Jw.T @ r
    total_err = torch.sum(w * r * r)
    n_valid = torch.clamp(valid.sum(), min=1)
    mean_sq = total_err / n_valid
    grad_norm = torch.linalg.norm(g)
    L = linalg.cholesky(Hm + 1e-8 * torch.eye(8, dtype=dtype, device=dev))
    delta = linalg.chol_solve(L, g[:, None])[:, 0]
    # a non-finite step (degenerate view) freezes rather than corrupts
    delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
    Tji_new = Tji @ lie.se3_exp(-delta[:6])
    return Tji_new, aff - delta[6:], torch.linalg.norm(delta), mean_sq, grad_norm


def _level_solve(Tji, aff, lvl: TrackLevel, img_j, term: TermStatic):
    """One pyramid level: max_iter masked IC iterations (see module doc).
    Returns (Tji, aff, iterations run before convergence)."""
    dev = Tji.device
    done = torch.zeros((), dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    prev_err = torch.full((), float("inf"), dtype=Tji.dtype, device=dev)
    for k in range(term.max_iter):
        Tji2, aff2, dn, mean_sq, gn = _gn_iter(Tji, aff, lvl, img_j, term)
        rel = torch.abs((prev_err - mean_sq) / prev_err)
        fire = ((k + 1 >= term.max_iter) | (dn < term.delta_norm)
                | (rel < term.rel_tol) | (gn < term.grad_norm)
                | (mean_sq < term.abs_tol))
        Tji = torch.where(done, Tji, Tji2)
        aff = torch.where(done, aff, aff2)
        prev_err = torch.where(done, prev_err, mean_sq)
        it = it + (~done).to(torch.int32)
        done = done | fire
    return Tji, aff, it


def track_pyramid(levels: Sequence[TrackLevel], img_pyr: Sequence[torch.Tensor],
                  Tji_init, aff_init, term: TermStatic):
    """Coarse-to-fine IC tracking; levels/img_pyr coarsest first.
    Returns (Tji (4, 4), aff (2,), iters per level).  Each level runs in a
    span "tracking.ic_level" whose payload holds its index and the
    iterations launched."""
    Tji, aff = Tji_init, aff_init
    iters = []
    for i, (lvl, img) in enumerate(zip(levels, img_pyr)):
        with RECORDER.span("tracking.ic_level", level=i, launched=term.max_iter):
            Tji, aff, it = _level_solve(Tji, aff, lvl, img[0], term)
        RECORDER.count("tracking.ic_iters_launched", term.max_iter)
        iters.append(it)
    return Tji, aff, torch.stack(iters)
