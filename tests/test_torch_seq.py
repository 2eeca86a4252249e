"""Port parity end to end: como_tpu_torch's ComoSeq against como_tpu's on
the 25-frame plane sequence of tests/test_e2e_seq.py (small_config,
48x64), both fed the same frames (CPU).

Held: the same bootstrap frame, the same keyframe / one-way decision
sequence, poses within 5 mm of the JAX engine's, and ATE < 2 cm."""

import numpy as np
import pytest

from como_tpu.config import ComoConfig as JConfig
from como_tpu.data.synthetic import SyntheticDataset
from como_tpu.runtime.seq import ComoSeq as JSeq
from como_tpu_torch.config import ComoConfig as TConfig
from como_tpu_torch.runtime.seq import ComoSeq as TSeq
from como_tpu_torch.utils.io import ate_rmse

IMG = (48, 64)


def small_config(cls):
    """tests/test_e2e_seq.py::small_config, for either package's config."""
    cfg = cls()
    cfg.img_size = list(IMG)
    cfg.mapping.graph.num_keyframes = 4
    cfg.mapping.graph.num_one_way_frames = 4
    cfg.mapping.sampling.max_num_coords = 16
    cfg.mapping.sampling.border = 2
    cfg.mapping.init.max_iter = 30
    cfg.tracking.term_criteria.max_iter = 30
    return cfg.validate()


class _Frames:
    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]


def _inserts(eng):
    return [(e["frame_kind"], round(e["ts"], 6)) for e in eng.log.ring
            if e["kind"] == "insert"]


@pytest.fixture(scope="module")
def runs():
    ds = SyntheticDataset(n_frames=25, img_size=IMG, seed=0, step=0.012)
    frames = _Frames([ds[i] for i in range(len(ds))])
    K = np.asarray(ds.intrinsics)
    je = JSeq(small_config(JConfig), ds.intrinsics, IMG)
    je.setup()
    jts, jest = je.run(frames)
    te = TSeq(small_config(TConfig), K, IMG, device="cpu")
    te.setup()
    tts, test = te.run(frames)
    return dict(gt=np.asarray(ds.poses), je=je, jts=jts, jest=jest, te=te, tts=tts,
                test=test)


def test_same_bootstrap_and_decisions(runs):
    np.testing.assert_array_equal(runs["tts"], runs["jts"])   # first = bootstrap frame
    assert runs["te"].mapping.is_init
    assert _inserts(runs["te"]) == _inserts(runs["je"])
    assert runs["te"].mapping.num_kf == runs["je"].mapping.num_kf
    assert runs["te"].mapping.num_ow == runs["je"].mapping.num_ow


def test_poses_agree_and_ate(runs):
    est, jest = runs["test"], runs["jest"]
    assert np.all(np.isfinite(est))
    assert np.abs(est[:, :3, 3] - jest[:, :3, 3]).max() < 5e-3
    idx = (np.asarray(runs["tts"]) * 30.0).round().astype(int)
    assert ate_rmse(est, runs["gt"][idx], with_scale=True) < 0.02


def test_landmarks_on_the_plane(runs):
    st = runs["te"].mapping.state
    P = st.P_lm[st.lm_valid].numpy()
    assert np.all(np.isfinite(P)) and 0.2 < np.median(P[:, 2]) < 5.0
    A = np.concatenate([P[:, :2], np.ones((len(P), 1))], 1)
    coef, *_ = np.linalg.lstsq(A, P[:, 2], rcond=None)
    assert np.sqrt(((P[:, 2] - A @ coef) ** 2).mean()) < 0.05 * np.median(P[:, 2])


def test_engine_refuses_unported_options():
    cfg = small_config(TConfig)
    cfg.frame_batch, cfg.dispatch_depth = 2, 2
    with pytest.raises(NotImplementedError):
        TSeq(cfg.validate(), np.eye(3, dtype=np.float32), IMG, device="cpu")
