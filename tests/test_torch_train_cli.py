"""The port's DepthCov trainer and checkpoint selector as a user runs them
(python -m como_tpu_torch.train.train_depthcov / .select_checkpoint), on
the CPU at small sizes; and utils/io.load_traj against the JAX package."""

import inspect
import sys

import jax
import numpy as np
import pytest
import torch

from como_tpu.net.depthcov import load_params as jload
from como_tpu.utils.io import load_traj as jload_traj
from como_tpu_torch.geometry.lie import se3_exp
from como_tpu_torch.net.depthcov import load_params as tload
from como_tpu_torch.net.depthcov import save_params
from como_tpu_torch.train import data as tdata
from como_tpu_torch.train import select_checkpoint as tsel
from como_tpu_torch.train import train_depthcov
from como_tpu_torch.utils.io import load_traj, save_traj
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)
from test_torch_train import ROOT, _write_tum


def _small_window(cfg):
    """48x64-sized window of tests/test_torch_cli.py: 4 KF / 4 OW / 16 anchors."""
    cfg.tracking.term_criteria.max_iter = 30
    cfg.mapping.graph.num_keyframes = 4
    cfg.mapping.graph.num_one_way_frames = 4
    cfg.mapping.sampling.max_num_coords = 16
    cfg.mapping.sampling.border = 2
    cfg.mapping.init.max_iter = 30


SMALL_SCORER = dict(frames=14, img=(48, 64), verbose=False, device="cpu", config=_small_window,
                    worlds=(("plane", (14,)), ("clutter", (13,))))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Three steps at 32x64 (and 192x256, multires), validated at step 3."""
    out = tmp_path_factory.mktemp("train") / "ck.msgpack"
    res = train_depthcov.main(["--device", "cpu", "--steps", "3", "--val_every", "3",
                               "--img", "32", "64", "--out", str(out)])
    return res, out


def test_trainer_runs_and_saves_the_selected_ema(trained):
    res, out = trained
    assert res["device"] == "cpu" and res["sizes"] == [[32, 64], [32, 64], [192, 256]]
    assert len(res["losses"]) == 3 and np.all(np.isfinite(res["losses"]))
    assert np.all(np.isfinite(res["grad_norms"])) and res["selected"] == "mse"
    (val,) = res["validations"]
    assert val["step"] == 2 and set(val["per"]) == {"plane", "clutter", "plane_hom"}
    assert res["best_score"] == val["score"] == pytest.approx(np.mean(list(val["per"].values())))
    # either package reads the checkpoint, with the same arrays
    sd = tload(str(out), "cpu")
    flat = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jload(str(out)))))
    assert len(flat) == len(sd)
    w = sd["base.conv1.weight"].numpy()
    np.testing.assert_array_equal(
        flat[next(k for k in flat if jax.tree_util.keystr(k).endswith(
            "['base']['conv1']['kernel']"))], np.transpose(w, (2, 3, 1, 0)))


def test_trainer_without_validation_saves_the_final_ema(tmp_path):
    """--data rgbd has no validation set: the final EMA is saved (never the
    raw parameters); --no-multires keeps every step at --img."""
    _write_tum(tmp_path / "tum")
    out = tmp_path / "ck.msgpack"
    res = train_depthcov.main(["--device", "cpu", "--data", "rgbd", "--dataset_dir",
                               str(tmp_path / "tum"), "--steps", "2", "--img", "32", "64",
                               "--no-multires", "--out", str(out)])
    assert res["selected"] == "final_ema" and res["validations"] == []
    assert res["sizes"] == [[32, 64]] * 3 and res["best_score"] is None
    raw = train_depthcov.make_model("cpu").state_dict()
    sd = tload(str(out), "cpu")
    # the EMA after two updates: 0.999^2 of the start plus 0.001-weighted steps
    moved = [k for k in sd if not torch.equal(sd[k], raw[k])]
    assert moved and all(float((sd[k] - raw[k]).abs().max()) < 1e-5 for k in moved)


def test_trainer_needs_a_gpu_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_depthcov.main(["--steps", "1"])
    with pytest.raises(ValueError, match="dataset_dir"):
        train_depthcov.main(["--device", "cpu", "--data", "rgbd", "--steps", "1"])


def test_train_entry_points_default_to_cuda():
    for fn in (tdata.synthetic_view, tdata.synthetic_batch, tdata.RgbdFolder.__init__,
               tsel.run_slam, tsel.E2EScorer.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert train_depthcov.build_parser().parse_args([]).device == "cuda"
    args = train_depthcov.build_parser().parse_args([])
    assert (args.steps, args.lr, args.img, args.multires, args.seed, args.val_every,
            args.select, args.select_every) == (1000, 3e-4, [96, 128], True, 1, 250, "mse", 500)


def test_e2e_scorer_on_a_small_window(tmp_path):
    """The worst ratio of per-world mean ATE against the analytic prior,
    for the shipped checkpoint; a state_dict scores through its msgpack
    exactly as the file does."""
    scorer = tsel.E2EScorer(**SMALL_SCORER)
    path = str(ROOT / "models" / "depthcov.msgpack")
    worst, detail = scorer.score_path(path)
    assert set(detail) == {"plane", "clutter"} and set(scorer.baselines) == set(detail)
    for world, (ate, ratio) in detail.items():
        assert np.isfinite(ate) and ratio == ate / scorer.baselines[world]
    assert worst == max(r for _, r in detail.values())
    assert scorer.score_state_dict(tload(path, "cpu")) == (worst, detail)


def test_trainer_selects_by_e2e(tmp_path, monkeypatch):
    """--select e2e scores the EMA every --select_every steps with the
    scorer and saves the best."""
    made, scorer_cls = [], tsel.E2EScorer

    def small_scorer(device):
        made.append(device)
        return scorer_cls(**SMALL_SCORER)

    monkeypatch.setattr(tsel, "E2EScorer", small_scorer)
    out = tmp_path / "ck.msgpack"
    res = train_depthcov.main(["--device", "cpu", "--steps", "2", "--select", "e2e",
                               "--select_every", "2", "--img", "32", "64", "--no-multires",
                               "--out", str(out)])
    assert made == [torch.device("cpu")]
    assert res["selected"] == "e2e" and np.isfinite(res["best_score"]) and out.exists()
    assert res["validations"] == []


def test_select_checkpoint_cli_needs_a_gpu_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tsel.main([str(ROOT / "models" / "depthcov.msgpack")])


def test_load_traj_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    poses = se3_exp(torch.from_numpy(rng.normal(scale=0.3, size=(5, 6)).astype(np.float32)))
    ts = np.arange(5) / 30.0
    save_traj(str(tmp_path / "t.txt"), ts, poses.numpy())
    t_ts, t_poses = load_traj(str(tmp_path / "t.txt"))
    j_ts, j_poses = jload_traj(str(tmp_path / "t.txt"))
    np.testing.assert_array_equal(t_ts, np.asarray(j_ts))
    np.testing.assert_allclose(t_poses, np.asarray(j_poses), atol=1e-12)
    save_traj(str(tmp_path / "one.txt"), ts[:1], poses.numpy()[:1])
    one_ts, one = load_traj(str(tmp_path / "one.txt"))
    assert one_ts.shape == (1,) and one.shape == (1, 4, 4)


def test_save_params_takes_a_module_or_a_state_dict(tmp_path):
    net = train_depthcov.make_model("cpu", seed=3)
    save_params(net, str(tmp_path / "a.msgpack"))
    save_params(net.state_dict(), str(tmp_path / "b.msgpack"))
    assert (tmp_path / "a.msgpack").read_bytes() == (tmp_path / "b.msgpack").read_bytes()
    assert "jax" not in sys.modules["como_tpu_torch.net.depthcov"].__dict__
