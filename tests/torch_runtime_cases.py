"""Shared cases of the port's runtime tests (tests/test_torch_runtime.py,
tests/test_torch_placement.py): the 48x64 window of tests/test_runtime.py
for either package, plane frames rendered once by the JAX package, and the
checks that hold a ComoSeq option of the port against the JAX engine."""

import numpy as np
import torch

from como_tpu.config import ComoConfig as JConfig
from como_tpu.data.synthetic import SyntheticDataset
from como_tpu.runtime.seq import ComoSeq as JSeq
from como_tpu_torch.config import ComoConfig as TConfig
from como_tpu_torch.odom.backend.gn_step import _gn_step_impl
from como_tpu_torch.runtime.seq import ComoSeq as TSeq
from como_tpu_torch.utils.io import ate_rmse
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

IMG = (48, 64)


def small_config(cls, **top):
    """4 KF / 4 OW / 16 anchors at 48x64, for either package's config;
    keyword arguments set top-level fields (dispatch_depth, frame_batch...)."""
    cfg = cls()
    cfg.img_size = list(IMG)
    cfg.mapping.graph.num_keyframes = 4
    cfg.mapping.graph.num_one_way_frames = 4
    cfg.mapping.sampling.max_num_coords = 16
    cfg.mapping.sampling.border = 2
    for k, v in top.items():
        setattr(cfg, k, v)
    return cfg.validate()


class Frames:
    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]


def plane_frames(n, step):
    """(frames as numpy, intrinsics, ground-truth poses) of the plane scene,
    seed 0."""
    ds = SyntheticDataset(n_frames=n, img_size=IMG, seed=0, step=step)
    frames = Frames([(float(ds[i][0]), np.asarray(ds[i][1])) for i in range(len(ds))])
    return frames, np.asarray(ds.intrinsics), np.asarray(ds.poses)


def inserts(eng):
    return [(e["frame_kind"], round(e["ts"], 6)) for e in eng.log.ring
            if e["kind"] == "insert"]


def torch_run(frames, K, **opts):
    te = TSeq(small_config(TConfig, **opts), K, IMG, device="cpu")
    te.setup()
    ts, est = te.run(frames)
    return te, ts, est


def option_runs(option):
    """25 plane frames (step 0.02: an odd count after the bootstrap, so a
    batched run ends in the stash flush) with dispatch_depth 2 and
    `option`: 2, through the JAX engine once and the port twice."""
    opts = dict(dispatch_depth=2, **{option: 2})
    frames, K, gt = plane_frames(25, 0.02)
    je = JSeq(small_config(JConfig, **opts), K, IMG)
    je.setup()
    jts, jest = je.run(frames)
    out = dict(option=option, gt=gt, je=je, jts=jts, jest=jest)
    out["te"], out["te_ts"], out["te_est"] = torch_run(frames, K, **opts)
    out["te2"], out["te2_ts"], out["te2_est"] = torch_run(frames, K, **opts)
    return out


def takes_the_jax_engines_decisions(runs):
    """The same bootstrap frame, the same number of poses (the odd-count
    flush), every frame once, and the same keyframe / one-way decision
    sequence and GN iteration count."""
    np.testing.assert_array_equal(runs["te_ts"], runs["jts"])
    assert len(runs["te_ts"]) == len(set(runs["te_ts"].tolist())) == len(runs["te_est"])
    assert inserts(runs["te"]) == inserts(runs["je"])
    assert len(inserts(runs["te"])) >= 2
    assert runs["te"].mapping.num_kf == runs["je"].mapping.num_kf
    assert runs["te"].mapping.num_ow == runs["je"].mapping.num_ow
    assert runs["te"].mapping.total_iters == runs["je"].mapping.total_iters


def poses_agree_and_ate(runs):
    """Poses within 5 mm of the JAX engine's (the bound of
    tests/test_torch_seq.py) and ATE under 2 cm."""
    est, jest = runs["te_est"], runs["jest"]
    assert np.all(np.isfinite(est))
    assert np.abs(est[:, :3, 3] - jest[:, :3, 3]).max() < 5e-3
    idx = (np.asarray(runs["te_ts"]) * 30.0).round().astype(int)
    assert ate_rmse(est, runs["gt"][idx], with_scale=True) < 0.02


def repeat_run_bitwise_equal(runs):
    """Decisions resolve at fixed depths, so a second run is the first."""
    np.testing.assert_array_equal(runs["te_ts"], runs["te2_ts"])
    np.testing.assert_array_equal(runs["te_est"], runs["te2_est"])


def viz_data_has_the_jax_keys_and_shapes(runs):
    vj = runs["je"].mapping.get_kf_viz_data()
    m = runs["te"].mapping
    vt = m.get_kf_viz_data()
    assert set(vt) == set(vj)
    for k, v in vj.items():
        if k == "timestamps":
            np.testing.assert_allclose(vt[k], v)
        elif k in ("kf_pairs", "ow_pairs"):
            assert vt[k] == v
        else:
            assert tuple(vt[k].shape) == tuple(np.asarray(v).shape), k
    # cloned out of the window: an in-place write does not reach them
    before = vt["poses"].clone()
    m.state.kf_pose.add_(1.0)
    assert torch.equal(vt["poses"], before)
    m.state.kf_pose.sub_(1.0)


def mapping_iterate_is_the_fused_step(runs):
    """Mapping.iterate: the numbers of _gn_step_impl on the same window,
    bit for bit, with the fused path's bookkeeping."""
    m = runs["te2"].mapping
    want, want_stats = _gn_step_impl(m.state, *m._pairs, m.K, m.dims, m.sigmas, m.damping)
    it, total = m.iter_count, m.total_iters
    stats = m.iterate()
    for f in want.fields():
        assert torch.equal(getattr(m.state, f), getattr(want, f)), f
    assert all(torch.equal(a, b) for a, b in zip(stats, want_stats))
    assert (m.iter_count, m.total_iters) == (it + 1, total + 1)
    assert m._stats_hist[-1][0] == it + 1
    m.converged = True
    assert m.maybe_iterate() is None and m.total_iters == total + 1


OPTION_CHECKS = [takes_the_jax_engines_decisions, poses_agree_and_ate,
                 repeat_run_bitwise_equal, viz_data_has_the_jax_keys_and_shapes,
                 mapping_iterate_is_the_fused_step]
