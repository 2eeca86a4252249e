"""The port's product surface: como_tpu_torch.cli.main on the CPU at 48x64
(synthetic plane, the config of tests/test_e2e_seq.py)."""

import inspect
import json
import sys

import numpy as np
import pytest
import yaml

from como_tpu_torch import cli
from como_tpu_torch.config import load_config
from como_tpu_torch.data.datasets import get_dataset
from como_tpu_torch.geometry.lie import tq_to_pose
from como_tpu_torch.runtime.seq import ComoSeq
from como_tpu_torch.utils.io import ate_rmse
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

SMALL = dict(
    img_size=[48, 64],
    tracking=dict(term_criteria=dict(max_iter=30)),
    mapping=dict(graph=dict(num_keyframes=4, num_one_way_frames=4),
                 sampling=dict(max_num_coords=16, border=2), init=dict(max_iter=30)))


def _read_tum(path):
    rows = np.loadtxt(path)
    return rows[:, 0], np.stack([tq_to_pose(r[1:]) for r in rows])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    cfg_path = d / "small.yml"
    cfg_path.write_text(yaml.safe_dump(SMALL))
    args = ["--dataset_type", "synthetic", "--device", "cpu", "--max_frames", "25",
            "--config", str(cfg_path), "--save_traj", str(d / "traj"),
            "--log", str(d / "events.jsonl"), "--save_state", str(d / "state.bin")]
    eng = cli.main(args)
    return dict(dir=d, cfg=str(cfg_path), eng=eng, args=args)


def test_cli_writes_the_engines_trajectory(run, capsys):
    """The TUM file holds ComoSeq.run's poses on the same dataset (to the
    file's 4 decimals), one line per tracked frame."""
    ts, poses = _read_tum(run["dir"] / "traj" / "synthetic.txt")
    cfg = load_config(run["cfg"])
    ds = get_dataset("synthetic", cfg.img_size, device="cpu")
    eng = ComoSeq(cfg, ds.intrinsics, cfg.img_size, device="cpu")
    eng.setup()
    ets, eposes = eng.run(ds, max_frames=25)
    assert len(ts) == len(ets) >= 15
    np.testing.assert_allclose(ts, ets, atol=5e-5)
    np.testing.assert_allclose(poses[:, :3, 3], eposes[:, :3, 3], atol=1e-4)
    np.testing.assert_allclose(poses[:, :3, :3], eposes[:, :3, :3], atol=5e-4)
    np.testing.assert_array_equal(run["eng"].poses_numpy(), eposes)


def test_cli_trajectory_ate(run):
    """Parsed back from the file, against the dataset's ground truth: the
    0.02 m bound of tests/test_e2e_seq.py (default step 0.02 here)."""
    ts, poses = _read_tum(run["dir"] / "traj" / "synthetic.txt")
    ds = get_dataset("synthetic", (48, 64), device="cpu")
    idx = np.round(ts * ds.fps).astype(int)
    assert np.all(np.isfinite(poses))
    assert ate_rmse(poses, ds.poses[idx], with_scale=True) < 0.02


def test_cli_log_and_state(run, tmp_path):
    events = [json.loads(l) for l in (run["dir"] / "events.jsonl").read_text().splitlines()]
    inserts = [e for e in events if e["kind"] == "insert"]
    m = run["eng"].mapping
    assert inserts and all("t" in e for e in events)
    assert inserts[-1]["num_kf"] == m.num_kf and inserts[-1]["num_ow"] == m.num_ow
    # --resume: a second run starts from the snapshot's window
    eng2 = cli.main(["--dataset_type", "synthetic", "--device", "cpu", "--max_frames", "3",
                     "--config", run["cfg"], "--save_traj", str(tmp_path),
                     "--resume", str(run["dir"] / "state.bin")])
    assert eng2.mapping.is_init and eng2.mapping.num_kf >= m.num_kf - 1
    assert eng2.mapping.kf_ts[0] in m.kf_ts
    assert (tmp_path / "synthetic.txt").exists()


@pytest.mark.parametrize("flag", [["--viz"]], ids=["viz"])
def test_cli_unported_options_raise(run, flag, tmp_path, monkeypatch):
    """--viz, the last option that raised, runs: without open3d the CLI
    attaches the snapshot viewer, which writes PNGs of the map under
    results/viz of the working directory."""
    from como_tpu_torch.viz.png import read_png
    from como_tpu_torch.viz.viewer import SnapshotViewer

    monkeypatch.setitem(sys.modules, "open3d", None)       # import raises ImportError
    monkeypatch.chdir(tmp_path)
    eng = cli.main(["--dataset_type", "synthetic", "--device", "cpu", "--max_frames", "12",
                    "--config", run["cfg"], "--save_traj", "traj", *flag])
    viewer = eng.viz_listener
    assert isinstance(viewer, SnapshotViewer) and viewer.failures == 0
    files = sorted((tmp_path / "results" / "viz").glob("map_*.png"))
    assert len(files) == viewer._count >= 1
    assert read_png(files[-1]).shape == (384, 512, 3)
    assert (tmp_path / "traj" / "synthetic.txt").exists()


def test_cli_runtime_pipeline_writes_a_trajectory(run, tmp_path, capsys):
    """--runtime pipeline on the CPU, to the end: the stage threads are
    joined, the TUM file parses, its poses are finite and near the ground
    truth (the pipeline's timing is not deterministic, so no pose is
    compared with ComoSeq's), and a snapshot is written."""
    import threading

    from como_tpu_torch.runtime.pipeline import ComoPipeline

    out = {}

    def target():
        out["eng"] = cli.main(["--dataset_type", "synthetic", "--device", "cpu",
                               "--runtime", "pipeline", "--max_frames", "25",
                               "--config", run["cfg"], "--save_traj", str(tmp_path),
                               "--log", str(tmp_path / "events.jsonl"),
                               "--save_state", str(tmp_path / "state.bin")])

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(240.0)
    assert not th.is_alive(), "the pipeline run did not end"
    eng = out["eng"]
    assert isinstance(eng, ComoPipeline) and eng.mapping.is_init
    assert not any(t.is_alive() for t in eng._threads)
    assert "25 frames in" in capsys.readouterr().out
    ts, poses = _read_tum(tmp_path / "synthetic.txt")
    assert len(ts) == len(eng.timestamps) > 5 and np.all(np.isfinite(poses))
    ds = get_dataset("synthetic", (48, 64), device="cpu")
    idx = np.round(ts * ds.fps).astype(int)
    assert ate_rmse(poses, ds.poses[idx], with_scale=True) < 0.05
    assert (tmp_path / "state.bin").stat().st_size > 0


def test_cli_defaults_to_cuda_and_fails_without_it(run):
    """No --device means the card; without one the run fails, it does not
    carry on on the CPU."""
    src = inspect.getsource(cli.main)
    assert '"--device", type=str, default="cuda"' in src
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--dataset_type", "synthetic", "--config", run["cfg"]])


def test_cli_realtime_paces_and_profile_traces(run, tmp_path):
    import time

    from como_tpu_torch.runtime import queues
    t = queues.monotonic_now()                     # the pacing helpers the CLI uses
    queues.sleep_until(t + 0.05)
    assert queues.monotonic_now() - t >= 0.05
    queues.sleep_until(t - 1.0)                    # a past deadline returns at once
    assert "sleep_until(t_pace0 + (ts - t0_ts))" in inspect.getsource(cli.main)
    t0 = time.perf_counter()
    cli.main(["--dataset_type", "synthetic", "--device", "cpu", "--max_frames", "4",
              "--config", run["cfg"], "--save_traj", str(tmp_path), "--realtime",
              "--profile", str(tmp_path / "prof")])
    assert time.perf_counter() - t0 >= 3 / 30.0    # 4 frames at 30 fps
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
