"""Port parity end to end: como_tpu_torch's ComoSeq against como_tpu's on
the 25-frame plane sequence of tests/test_e2e_seq.py (small_config,
48x64), both fed the same frames (CPU).

Held: the same bootstrap frame, the same keyframe / one-way decision
sequence, poses within 5 mm of the JAX engine's, and ATE < 2 cm."""

import os

import numpy as np
import pytest
import torch

from como_tpu.config import ComoConfig as JConfig
from como_tpu.data.synthetic import SyntheticDataset
from como_tpu.runtime.seq import ComoSeq as JSeq
from como_tpu_torch.config import ComoConfig as TConfig
from como_tpu_torch.runtime.seq import ComoSeq as TSeq
from como_tpu_torch.utils.io import ate_rmse
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

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
    K = np.array(ds.intrinsics)
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


CKPT = os.path.join(os.path.dirname(__file__), "..", "models", "depthcov.msgpack")


@pytest.fixture(scope="module", params=["f32", "bf16"])
def unet_runs(request):
    """The slice as a whole with the learned prior: both engines with
    `prior: unet` and the shipped weights on the same 25 plane frames, with
    f32 and with bf16 (the default) UNet convolutions on both sides.  The
    JAX engine gets its f32 UNet from here, before anything is traced
    (warm_start off); nothing in como_tpu changes."""
    import jax.numpy as jnp
    import torch

    from como_tpu.net.unet import UNet as JUNet
    from como_tpu_torch.net.depthcov import DepthCovPrior as TPrior

    f32 = request.param == "f32"
    ds = SyntheticDataset(n_frames=25, img_size=IMG, seed=0, step=0.012)
    frames = _Frames([ds[i] for i in range(len(ds))])
    out = dict(gt=np.asarray(ds.poses), dtype=request.param)
    for name, cfg_cls, seq_cls, kw in (("j", JConfig, JSeq, {}),
                                       ("t", TConfig, TSeq, dict(device="cpu"))):
        cfg = small_config(cfg_cls)
        cfg.mapping.prior, cfg.mapping.model_path = "unet", CKPT
        cfg.mapping.warm_start = False
        eng = seq_cls(cfg, np.array(ds.intrinsics), IMG, **kw)
        eng.setup()
        if f32 and name == "j":
            eng.mapping.prior._unet = JUNet(compute_dtype=jnp.float32)
        elif f32:
            eng.mapping.prior = TPrior("unet", CKPT, device="cpu",
                                       compute_dtype=torch.float32)
        out[name + "ts"], out[name + "est"] = eng.run(frames)
        out[name + "e"] = eng
    return out


def test_unet_prior_same_decisions_and_poses(unet_runs):
    """Same bootstrap frame and KF/OW decision sequence and ATE < 2 cm, as
    in the analytic case above.  Poses: with f32 UNet convolutions on both
    sides within the analytic case's 5 mm; with bf16 on both sides no
    decision flips, but the two bf16 covariance images differ by the bf16
    floor (0.6% median, tests/test_torch_unet.py) and the poses by up to
    6.8 mm, so that case is held to 1 cm."""
    r = unet_runs
    assert r["te"].mapping.prior.mode == "unet" and r["te"].mapping.prior.unet is not None
    np.testing.assert_array_equal(r["tts"], r["jts"])
    assert _inserts(r["te"]) == _inserts(r["je"])
    assert r["te"].mapping.num_kf == r["je"].mapping.num_kf >= 3
    assert r["te"].mapping.num_ow == r["je"].mapping.num_ow
    assert np.all(np.isfinite(r["test"]))
    bound = 5e-3 if r["dtype"] == "f32" else 1e-2
    assert np.abs(r["test"][:, :3, 3] - r["jest"][:, :3, 3]).max() < bound
    idx = (np.asarray(r["tts"]) * 30.0).round().astype(int)
    assert ate_rmse(r["test"], r["gt"][idx], with_scale=True) < 0.02


def test_unet_prior_differs_from_analytic(runs, unet_runs):
    """The learned prior is really in the loop: its covariance images are
    not the analytic prior's."""
    a = runs["te"].mapping.state.cov_img[0]
    u = unet_runs["te"].mapping.state.cov_img[0]
    assert float((a - u).abs().max()) > 1e-2


def test_engine_refuses_unported_options():
    """mapping.mesh_devices asks for that many devices: a CUDA engine with
    fewer visible cards raises before anything is built (here: none), as
    the JAX package does (tests/test_multichip.py::test_mesh_devices_validation);
    it never falls back to sharing a card or to the CPU.  A CPU engine's
    mesh is that many shards on the CPU."""
    from como_tpu_torch.odom.mapping import Mapping

    cfg = small_config(TConfig)
    cfg.mapping.mesh_devices = max(2, torch.cuda.device_count() + 1)
    cfg.validate()
    K = np.eye(3, dtype=np.float32)
    with pytest.raises(RuntimeError, match="mesh_devices"):
        Mapping(cfg.mapping, K, IMG, device="cuda")
    m = Mapping(cfg.mapping, K, IMG, device="cpu")
    assert m.uses_mesh and m.mesh == [torch.device("cpu")] * cfg.mapping.mesh_devices
