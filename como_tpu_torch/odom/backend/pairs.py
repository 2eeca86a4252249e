"""Covisibility-graph pair construction (host-side, numpy).

Spec: reference como/odom/backend/graph_pair_construction.py.  Default
configuration (radius/degrees thresholds = 0) is purely temporal:
forward + backward consecutive keyframe chains, and each one-way frame
attached to the keyframes bracketing it in time.  The optional
radius/rotation edges are also implemented (numpy on 9 poses — trivial).

Design note: pair lists only change on frame insertion, never during
GN iterations, so they are computed once per insertion on the host and
shipped to the device padded to the static maximum
(P = 2*(K-1) + 2*O), with a validity mask.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class PairBatch(NamedTuple):
    ref_kf: np.ndarray       # (P,) int32: slot of the reference keyframe
    target_slot: np.ndarray  # (P,) int32: global frame slot of the target
                             #     (kf slot k -> k;  ow slot j -> K + j)
    valid: np.ndarray        # (P,) bool


def temporal_ow_attachments(kf_ts: List[float], ow_ts: List[float]):
    """Attach each one-way frame to the keyframes bracketing its timestamp
    (both sides when between two KFs; only the last KF when newer).
    Matches reference get_one_way_temporal_neighbors semantics."""
    pairs = []
    nk = len(kf_ts)
    for r, t in enumerate(ow_ts):
        # last keyframe with ts <= t ("behind")
        behind = 0
        while behind + 1 < nk and kf_ts[behind + 1] < t:
            behind += 1
        if behind + 1 < nk and kf_ts[behind + 1] >= t:
            pairs.append((behind, r))
            pairs.append((behind + 1, r))
        else:
            pairs.append((nk - 1, r))
    return pairs


def _scaled_dists_and_cos(kf_poses: np.ndarray, kf_median_depths: np.ndarray,
                          tgt_poses: np.ndarray):
    """(n_kf, n_tgt) camera distance scaled by the reference KF's median
    depth, and the rotation cosine between frames (reference
    calc_scaled_dist + calc_rotation_cos)."""
    t1 = kf_poses[:, :3, 3]
    t2 = tgt_poses[:, :3, 3]
    dists = np.linalg.norm(t1[:, None] - t2[None, :], axis=-1)
    scaled = dists / kf_median_depths[:, None]
    R12 = np.einsum("iab,jac->ijbc", kf_poses[:, :3, :3], tgt_poses[:, :3, :3])
    cos_theta = 0.5 * (np.trace(R12, axis1=-2, axis2=-1) - 1.0)
    return scaled, cos_theta


def radius_kf_edges(poses: np.ndarray, median_depths: np.ndarray,
                    radius_thresh: float, degrees_thresh: float):
    """Non-consecutive KF pairs within a scaled camera distance and
    rotation cone (reference get_kf_edges)."""
    n = poses.shape[0]
    scaled, cos_theta = _scaled_dists_and_cos(poses, median_depths, poses)
    cos_thresh = np.cos(np.deg2rad(degrees_thresh))
    valid = (scaled < radius_thresh) & (cos_theta > cos_thresh)
    out = []
    for i in range(n):
        for j in range(n):
            if valid[i, j] and abs(i - j) > 1:
                out.append((i, j))
    return out


def ow_nearest_radius_attachments(kf_poses: np.ndarray,
                                  kf_median_depths: np.ndarray,
                                  ow_poses: np.ndarray,
                                  radius_thresh: float,
                                  degrees_thresh: float):
    """One-way frames attach to their nearest keyframe (scaled distance)
    plus every keyframe within the radius/rotation cone (reference
    get_pose_pairs mode="nearest_and_radius",
    graph_pair_construction.py:53-71, selected at :141-146)."""
    scaled, cos_theta = _scaled_dists_and_cos(kf_poses, kf_median_depths,
                                              ow_poses)
    nearest = np.argmin(scaled, axis=0)                 # (n_ow,)
    cos_thresh = np.cos(np.deg2rad(degrees_thresh))
    valid = (scaled < radius_thresh) & (cos_theta > cos_thresh)
    valid[nearest, np.arange(ow_poses.shape[0])] = False  # dedupe nearest
    pairs = [(int(k), int(r)) for r, k in enumerate(nearest)]
    ks, rs = np.nonzero(valid)
    pairs += [(int(k), int(r)) for k, r in zip(ks, rs)]
    return pairs


def max_pairs(K: int, O: int, radius_mode: bool) -> int:
    """Static pair capacity.  Temporal default: forward+backward KF chains
    + <= 2 KFs per one-way frame.  Radius mode adds all non-consecutive KF
    pairs ((K-1)(K-2) ordered) and lets every one-way frame attach to all
    K keyframes."""
    if radius_mode:
        return 2 * (K - 1) + (K - 1) * (K - 2) + K * O
    return 2 * (K - 1) + 2 * O


def build_pairs(num_kf: int, kf_ts: List[float], ow_ts: List[float],
                K_slots: int, P_max: int,
                poses: np.ndarray | None = None,
                median_depths: np.ndarray | None = None,
                ow_poses: np.ndarray | None = None,
                radius_thresh: float = 0.0,
                degrees_thresh: float = 0.0) -> PairBatch:
    """All photometric pairs, padded to the static maximum.

    With radius/degrees thresholds > 0 and poses given, adds radius KF
    edges and switches one-way attachment from temporal bracketing to the
    nearest+radius mode (reference setup_photometric_pairs:155-182)."""
    radius_mode = radius_thresh > 0.0 and degrees_thresh > 0.0 and poses is not None
    ref, tgt = [], []
    # forward + backward consecutive keyframe chains
    for i in range(num_kf - 1):
        ref.append(i); tgt.append(i + 1)
        ref.append(i + 1); tgt.append(i)
    if radius_mode:
        for i, j in radius_kf_edges(poses[:num_kf], median_depths[:num_kf],
                                    radius_thresh, degrees_thresh):
            ref.append(i); tgt.append(j)
    # one-way frames: reference keyframe -> one-way target
    if radius_mode and ow_poses is not None and len(ow_ts) > 0:
        ow_pairs = ow_nearest_radius_attachments(
            poses[:num_kf], median_depths[:num_kf], ow_poses[: len(ow_ts)],
            radius_thresh, degrees_thresh)
    else:
        ow_pairs = temporal_ow_attachments(kf_ts, ow_ts)
    for k, r in ow_pairs:
        ref.append(k); tgt.append(K_slots + r)

    n = len(ref)
    if n > P_max:
        raise ValueError(
            f"pair count {n} exceeds static capacity {P_max}; size dims "
            f"with max_pairs(K, O, radius_mode=True) when radius edges are "
            f"enabled")
    ref_arr = np.zeros(P_max, np.int32)
    tgt_arr = np.zeros(P_max, np.int32)
    val_arr = np.zeros(P_max, bool)
    ref_arr[:n] = ref
    tgt_arr[:n] = tgt
    val_arr[:n] = True
    return PairBatch(ref_kf=ref_arr, target_slot=tgt_arr, valid=val_arr)
