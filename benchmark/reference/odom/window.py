"""Sliding-window state, all static shapes (port of como_tpu/odom/window.py).

K_MAX keyframe slots and O_MAX one-way slots (valid-prefix masks, oldest at
slot 0), M anchors per keyframe mapped to L = K*M landmark slots through
`anchor_lm`, with a host-side free-list allocator.

Unlike the JAX pytree, the port's state is allocated once and keyframe /
one-way insertion writes its slots in place (slice assignment); only the
GN step replaces the fields it changes with new tensors.  Whatever leaves
the window (reference data, reported poses) is cloned first, so an
in-place write never changes a value someone already holds.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch


class WindowDims(NamedTuple):
    K: int
    O: int
    M: int
    H: int
    W: int
    ND: int
    L: int
    P: int
    C: int = 1
    NW: int = 4

    @property
    def D(self) -> int:
        """GN system dimension: 8 per frame + 3 per landmark."""
        return 8 * self.K + 8 * self.O + 3 * self.L


def make_dims(num_kf=9, num_ow=24, M=64, img_size=(192, 256), nms_window=4,
              radius_pairs=False, channels=1):
    from benchmark.reference.odom.backend.pairs import max_pairs
    H, W = img_size
    return WindowDims(K=num_kf, O=num_ow, M=M, H=H, W=W,
                      ND=(H // nms_window) * (W // nms_window), L=num_kf * M,
                      P=max_pairs(num_kf, num_ow, radius_pairs), C=channels,
                      NW=nms_window)


@dataclass
class WindowState:
    kf_pose: torch.Tensor      # (K, 4, 4) T_wc
    kf_aff: torch.Tensor       # (K, 2)
    kf_valid: torch.Tensor     # (K,) bool
    kf_img: torch.Tensor       # (K, 3C, H, W)
    kf_rgb: torch.Tensor       # (K, 3, H, W)
    cov_img: torch.Tensor      # (K, 3, H, W)
    Kmm_inv: torch.Tensor      # (K, M, M)
    L_mm: torch.Tensor         # (K, M, M)
    Knm_full: torch.Tensor     # (K, H*W, M)
    knm_colmean: torch.Tensor  # (K, M)
    dense_rc: torch.Tensor     # (K, ND, 2)
    dense_vals: torch.Tensor   # (K, C, ND)
    dense_knm: torch.Tensor    # (K, ND, M)
    pm_first: torch.Tensor     # (K, M, 2)
    obs_ref: torch.Tensor      # (K, M) bool
    anchor_lm: torch.Tensor    # (K, M) int64
    logzm: torch.Tensor        # (K, M)
    pm: torch.Tensor           # (K, M, 2)
    median_depth: torch.Tensor  # (K,)
    P_lm: torch.Tensor         # (L, 3)
    lm_valid: torch.Tensor     # (L,) bool
    ow_pose: torch.Tensor      # (O, 4, 4)
    ow_aff: torch.Tensor       # (O, 2)
    ow_valid: torch.Tensor     # (O,) bool
    ow_img: torch.Tensor       # (O, 3C, H, W)
    pose_anchor: torch.Tensor  # (4, 4)
    aff_anchor: torch.Tensor   # (2,)
    scale_anchor: torch.Tensor  # ()
    window_full: torch.Tensor  # () bool
    P_anchor_vals: torch.Tensor  # (L, 3)
    P_anchor_mask: torch.Tensor  # (L,) bool

    def replace(self, **kw) -> "WindowState":
        return dataclasses.replace(self, **kw)

    def fields(self):
        return [f.name for f in dataclasses.fields(self)]


def empty_state(dims: WindowDims, dtype=torch.float32, device="cuda") -> WindowState:
    K, O, M, H, W, ND, L, C = (dims.K, dims.O, dims.M, dims.H, dims.W,
                               dims.ND, dims.L, dims.C)
    kw = dict(dtype=dtype, device=device)
    eye4 = torch.eye(4, **kw)
    eyeM = torch.eye(M, **kw)
    return WindowState(
        kf_pose=eye4.repeat(K, 1, 1),
        kf_aff=torch.zeros((K, 2), **kw),
        kf_valid=torch.zeros((K,), dtype=torch.bool, device=device),
        kf_img=torch.zeros((K, 3 * C, H, W), **kw),
        kf_rgb=torch.zeros((K, 3, H, W), **kw),
        cov_img=torch.full((K, 3, H, W), 0.1, **kw),
        Kmm_inv=eyeM.repeat(K, 1, 1),
        L_mm=eyeM.repeat(K, 1, 1),
        Knm_full=torch.zeros((K, H * W, M), **kw),
        knm_colmean=torch.zeros((K, M), **kw),
        dense_rc=torch.zeros((K, ND, 2), **kw),
        dense_vals=torch.zeros((K, C, ND), **kw),
        dense_knm=torch.zeros((K, ND, M), **kw),
        pm_first=torch.zeros((K, M, 2), **kw),
        obs_ref=torch.zeros((K, M), dtype=torch.bool, device=device),
        anchor_lm=torch.zeros((K, M), dtype=torch.int64, device=device),
        logzm=torch.zeros((K, M), **kw),
        pm=torch.zeros((K, M, 2), **kw),
        median_depth=torch.ones((K,), **kw),
        P_lm=torch.zeros((L, 3), **kw),
        lm_valid=torch.zeros((L,), dtype=torch.bool, device=device),
        ow_pose=eye4.repeat(O, 1, 1),
        ow_aff=torch.zeros((O, 2), **kw),
        ow_valid=torch.zeros((O,), dtype=torch.bool, device=device),
        ow_img=torch.zeros((O, 3 * C, H, W), **kw),
        pose_anchor=eye4.clone(),
        aff_anchor=torch.zeros((2,), **kw),
        scale_anchor=torch.zeros((), **kw),
        window_full=torch.zeros((), dtype=torch.bool, device=device),
        P_anchor_vals=torch.zeros((L, 3), **kw),
        P_anchor_mask=torch.zeros((L,), dtype=torch.bool, device=device),
    )


def state_from_numpy(fields: dict, device) -> WindowState:
    """Port state from a dict of numpy arrays, e.g. a JAX WindowState's
    fields through np.asarray (`{k: np.asarray(v) for k, v in
    st._asdict().items()}`).  Integer fields become int64, bools stay bool,
    floats become f32."""
    out = {}
    for name in (f.name for f in dataclasses.fields(WindowState)):
        a = np.asarray(fields[name])
        if a.dtype == np.bool_:
            t = torch.from_numpy(a.copy())
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.from_numpy(a.astype(np.int64))
        else:
            t = torch.from_numpy(a.astype(np.float32))
        out[name] = t.to(device)
    return WindowState(**out)


def state_to_numpy(state: WindowState) -> dict:
    """dict of numpy arrays (field name -> array) of a port state."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in state.fields()}


class LandmarkAllocator:
    """Host-side free-list for landmark slots (numpy, tiny)."""

    def __init__(self, L: int):
        self.L = L
        self.free = list(range(L - 1, -1, -1))
        self.valid = np.zeros(L, bool)

    def alloc(self, n: int) -> np.ndarray:
        assert len(self.free) >= n, "landmark slots exhausted"
        idx = np.array([self.free.pop() for _ in range(n)], np.int64)
        self.valid[idx] = True
        return idx

    def release(self, idx) -> None:
        for i in np.atleast_1d(idx):
            if self.valid[i]:
                self.valid[i] = False
                self.free.append(int(i))
