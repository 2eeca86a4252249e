"""Port parity of the measurement tools under como_tpu_torch/tools/ against
the JAX package's scripts/ (CPU, 48x64): eval_matrix's cell, the two GT
converters, run_full's flags, profile_e2e's phases and profile_gn's stages;
runs of bench_runtimes and probe_pair_throughput at a small size; and every
tool's device rule (cuda by default, raises without a GPU unless --device
cpu)."""

import ast
import importlib
import importlib.util
import inspect
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from como_tpu.data.synthetic import SyntheticDataset as JDataset
from como_tpu.odom.backend import gn_step as jgn
from como_tpu.odom.window import make_dims as jmake_dims
from como_tpu.utils.demo import make_demo_state as jdemo_state
from como_tpu_torch import bench
from como_tpu_torch.config import ComoConfig as TConfig
from como_tpu_torch.data.synthetic import SyntheticDataset as TDataset
from como_tpu_torch.odom.backend.gn_step import SigmaStatic
from como_tpu_torch.runtime.seq import ComoSeq as TSeq
from como_tpu_torch.tools import (bench_runtimes, common, eval_matrix, probe_pair_throughput,
                                  profile_e2e, profile_gn, run_full)
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

ROOT = Path(__file__).resolve().parents[1]
IMG = (48, 64)
DEVICE_TOOLS = ("eval_matrix", "bench_runtimes", "run_full", "profile_e2e", "profile_gn",
                "probe_pair_throughput")


def _script(name):
    """scripts/<name>.py, imported by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_config():
    """tests/test_e2e_seq.py::small_config: 4 KF / 4 OW / 16 anchors."""
    cfg = TConfig()
    cfg.img_size = list(IMG)
    cfg.mapping.graph.num_keyframes = 4
    cfg.mapping.graph.num_one_way_frames = 4
    cfg.mapping.sampling.max_num_coords = 16
    cfg.mapping.sampling.border = 2
    cfg.mapping.init.max_iter = 30
    cfg.tracking.term_criteria.max_iter = 30
    return cfg.validate()


# ---- eval_matrix -------------------------------------------------------------

def test_eval_matrix_run_cell_matches_jax():
    """Plane, analytic prior, seed 0, 20 frames at 48x64 (ComoConfig()):
    the JAX script's row keys, frames tracked and keyframes, ATE within
    5 mm."""
    want = _script("eval_matrix").run_cell("plane", 0, "analytic", "", 20, IMG)
    got = eval_matrix.run_cell("plane", 0, "analytic", "", 20, IMG, device="cpu")
    assert set(got) == set(want)
    assert (got["scene"], got["seed"], got["prior"]) == ("plane", 0, "analytic")
    assert got["frames_tracked"] == want["frames_tracked"]
    assert got["num_kf"] == want["num_kf"]
    assert abs(got["ate_cm"] - want["ate_cm"]) < 0.5
    assert abs(got["path_len_m"] - want["path_len_m"]) < 1e-3


# ---- the GT converters ---------------------------------------------------------

def _poses(rng, n):
    from como_tpu_torch.geometry.lie import se3_exp

    xi = rng.normal(scale=[0.2, 0.2, 0.2, 1.0, 1.0, 1.0], size=(n, 6)).astype(np.float32)
    return se3_exp(torch.from_numpy(xi)).numpy().astype(np.float64)


def _replica(root, rng):
    root.mkdir()
    np.savetxt(root / "traj.txt", _poses(rng, 7).reshape(7, 16))


def _scannet(root, rng):
    (root / "pose").mkdir(parents=True)
    for i, T in enumerate(_poses(rng, 12)):
        if i == 4:
            T[0, 0] = -np.inf            # an invalid frame, skipped
        np.savetxt(root / "pose" / f"{i}.txt", T)


@pytest.mark.parametrize("name,make", [("convert_replica_gt", _replica),
                                       ("convert_scannet_gt", _scannet)])
def test_gt_converter_writes_the_jax_file(name, make, tmp_path, monkeypatch, capsys):
    """The same TUM file, byte for byte, as the JAX script on a small
    dataset (the default --out and an explicit one)."""
    data = tmp_path / "data"
    make(data, np.random.default_rng(0))
    monkeypatch.setattr(sys, "argv", [name, "--dataset_dir", str(data),
                                      "--out", str(tmp_path / "jax.txt")])
    _script(name).main()
    port = importlib.import_module(f"como_tpu_torch.tools.{name}")
    assert port.main(["--dataset_dir", str(data), "--out", str(tmp_path / "port.txt")]) == 0
    assert port.main(["--dataset_dir", str(data)]) == 0
    want = (tmp_path / "jax.txt").read_bytes()
    assert len(want.splitlines()) == (7 if "replica" in name else 11)
    assert (tmp_path / "port.txt").read_bytes() == want
    assert (data / "gt_traj_tum.txt").read_bytes() == want
    assert capsys.readouterr().out.count("poses ->") == 3


# ---- run_full -------------------------------------------------------------------

def _add_argument_calls(path, within=None):
    """{flag: {keyword: source}} of the add_argument calls in a file (in
    function `within` if given), help texts left out."""
    tree = ast.parse(Path(path).read_text())
    if within:
        tree = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                    and n.name == within)
    out = {}
    for n in ast.walk(tree):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "add_argument"):
            out[n.args[0].value] = {k.arg: ast.unparse(k.value) for k in n.keywords
                                    if k.arg != "help"}
    return out


def test_run_full_has_the_jax_flags():
    """run_full_tpu.py's flags with the same types, defaults, choices and
    actions, plus --device (default cuda)."""
    want = _add_argument_calls(ROOT / "scripts" / "run_full_tpu.py")
    got = _add_argument_calls(inspect.getsourcefile(run_full), "build_parser")
    assert len(want) == 24
    assert set(got) == set(want) | {"--device"}
    for flag, kw in want.items():
        assert got[flag] == kw, flag
    assert run_full.build_parser().parse_args([]).device == "cuda"


def test_run_full_maps_flags_onto_the_config():
    """Each flag lands on the field the JAX script sets."""
    parse = run_full.build_parser().parse_args
    cfg = run_full.make_config(parse(
        ["--img", "48", "64", "--prior", "unet", "--model", "m.msgpack", "--stride", "2",
         "--lag", "3", "--kf_ratio", "0.2", "--rot_weight", "0.5", "--rot_mode", "sum",
         "--stat_ema", "0.3", "--one_way_freq", "4", "--kf_pixels_frac", "0.6", "--motion",
         "--promote", "--anticipate", "3", "--radius", "0.5", "--degrees", "20"]))
    kf = cfg.tracking.keyframing
    assert cfg.img_size == [48, 64] and cfg.mapping.prior == "unet"
    assert cfg.mapping.model_path == "m.msgpack"
    assert (cfg.resolve_stride, cfg.frame_batch, cfg.dispatch_depth) == (2, 1, 3)
    assert (kf.kf_depth_motion_ratio, kf.kf_rot_weight, kf.kf_rot_mode, kf.stat_ema,
            kf.one_way_freq, kf.kf_num_pixels_frac, kf.kf_promote_latest,
            kf.kf_anticipate) == (0.2, 0.5, "sum", 0.3, 4, 0.6, True, 3)
    assert cfg.tracking.use_motion_model
    pc = cfg.mapping.photo_construction
    assert (pc.radius_thresh, pc.degrees_thresh) == (0.5, 20.0)
    # --batch 2 without --lag raises the dispatch depth to at least 2
    cfg = run_full.make_config(parse(["--batch", "2"]))
    assert (cfg.frame_batch, cfg.dispatch_depth) == (2, 2)
    assert run_full.make_config(parse([])) == _default(TConfig)


def _default(cls):
    cfg = cls()
    cfg.img_size = [192, 256]
    return cfg.validate()


# ---- profile_e2e ----------------------------------------------------------------

def test_profile_e2e_wraps_the_jax_phases():
    """The eleven wraps of scripts/profile_e2e.py, under its labels, each a
    method of the port's engine."""
    tree = ast.parse((ROOT / "scripts" / "profile_e2e.py").read_text())
    want = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id == "wrap":
            owner = n.args[0].attr if isinstance(n.args[0], ast.Attribute) else ""
            name = n.args[1].value
            want.append((owner, name, n.args[2].value if len(n.args) > 2 else name))
    assert len(want) == 11
    assert list(profile_e2e.PHASES) == want
    eng = TSeq(small_config(), np.eye(3, dtype=np.float32), IMG, device="cpu")
    for owner, name, _ in want:
        assert callable(getattr(getattr(eng, owner) if owner else eng, name)), name


def test_profile_e2e_run_records_the_phases():
    """A 16-frame plane run (small window, frame_batch 1): the dispatch,
    resolve, decide and reference phases are timed after the warm-up."""
    ds = TDataset(n_frames=16, img_size=IMG, seed=0, step=0.02, device="cpu")
    acc, lat = profile_e2e.profile_run(small_config(), ds, "cpu", warmup=6)
    assert len(lat) == 16 - 7
    for label in ("_dispatch_fused", "_resolve_one", "tracking.decide",
                  "tracking.update_kf_ref", "mapping.get_kf_ref_data", "_refresh_reference"):
        assert acc[label] and all(t >= 0 for t in acc[label]), label
    assert not acc["_dispatch_pair"]          # frame_batch 1
    assert len(acc["tracking.decide"]) == len(acc["_resolve_one"])


# ---- profile_gn -------------------------------------------------------------------

@pytest.fixture(scope="module")
def gn_stages():
    """JAX's stages (scripts/profile_gn.py's, each jitted) and profile_gn's,
    on tests/test_torch_gn_step.py's window at 48x64.  The window, pairs and
    intrinsics are arguments of each jitted stage: the JAX script closes
    over them, and XLA's constant folding of the pair indices then moves
    the photometric grids by up to 3.8% of their largest entry against the
    same stage run op by op (which the port matches within 8.1e-5)."""
    dims = jmake_dims(num_kf=4, num_ow=3, M=16, img_size=IMG)
    st, pairs, K = jdemo_state(dims, num_kf=3, num_ow=2)
    sig = jgn.SigmaStatic()

    @jax.jit
    def scaffold_only(st, K):
        return jgn._scaffold(st, K, dims, sig.far_depth_ratio)

    @jax.jit
    def dense_only(st, K):
        sc = jgn._scaffold(st, K, dims, sig.far_depth_ratio)
        return jgn._dense_points(st._replace(P_lm=sc["P_lm_new"]), sc, K, dims)

    @jax.jit
    def photo_only(st, pairs, K):
        sc = jgn._scaffold(st, K, dims, sig.far_depth_ratio)
        st = st._replace(P_lm=sc["P_lm_new"])
        dn = jgn._dense_points(st, sc, K, dims)
        return jgn._photo(st, sc, dn, *pairs, K, dims, occl_thresh=sig.occlusion_thresh,
                          estimate_affine=sig.estimate_affine)

    want = {"scaffold": scaffold_only(st, K), "+dense": dense_only(st, K),
            "+photo": photo_only(st, pairs, K),
            "+assemble": jgn.gn_system(st, *pairs, K, dims, sig),
            "full(step+solve)": jgn.gn_step(st, *pairs, K, dims, sig, 1e-6)}
    tst, tpairs, tK, tdims = bench.gn_window("cpu", IMG, num_kf=4, num_ow=3, fill_kf=3,
                                             fill_ow=2, M=16)
    fns = profile_gn.stage_fns(tpairs, tK, tdims, SigmaStatic())
    return want, {name: fn(tst) for name, fn in fns.items()}


def _rel(a, b):
    """Largest difference over the reference's largest |entry|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("stage", profile_gn.STAGES)
def test_profile_gn_stage_matches_jax(gn_stages, stage):
    """Each cumulative stage against the JAX script's.  The scaffold and the
    dense points (direct f32 arithmetic) within 1e-5 of each array's largest
    entry; the photometric grids and the system at
    tests/test_torch_gn_step.py::test_gn_system_matches's 1e-4 (sums of
    thousands of terms in another order; the system Jacobi-scaled); the
    step at test_gn_step_matches's tolerances."""
    want, got = gn_stages[0][stage], gn_stages[1][stage]
    if stage in ("scaffold", "+dense"):
        assert set(got) == set(want)
        for k in want:
            assert _rel(got[k], want[k]) <= 1e-5, k
    elif stage == "+photo":
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert _rel(a, b) <= 1e-4
    elif stage == "+assemble":
        (H, g, e), (Hj, gj, ej) = got, [np.asarray(x) for x in want]
        d = np.sqrt(np.maximum(np.abs(np.diag(Hj)), 1e-20))
        np.testing.assert_allclose(H.numpy() / d[:, None] / d[None], Hj / d[:, None] / d[None],
                                   atol=1e-4)
        np.testing.assert_allclose(g.numpy() / d, gj / d, atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(float(e), float(ej), rtol=1e-4)
    else:
        (s, stats), (sj, statj) = got, want
        np.testing.assert_allclose(s.kf_pose.numpy(), np.asarray(sj.kf_pose), atol=1e-4)
        np.testing.assert_allclose(s.ow_pose.numpy(), np.asarray(sj.ow_pose), atol=1e-4)
        np.testing.assert_allclose(s.P_lm.numpy(), np.asarray(sj.P_lm), atol=1e-2)
        np.testing.assert_allclose(s.logzm.numpy(), np.asarray(sj.logzm), atol=1e-5)
        for a, b in zip(stats, statj):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-2, atol=1e-6)


def test_profile_gn_windows_are_the_jax_windows():
    src = (ROOT / "scripts" / "profile_gn.py").read_text()
    for tag, w in profile_gn.WINDOWS:
        H, W = w["img_size"]
        assert f'("{tag}", dict(num_kf={w["num_kf"]}, num_ow={w["num_ow"]}, ' \
               f'fill={w["fill_ow"]}, hw=({H}, {W})))' in src


def test_profile_gn_window_times(monkeypatch):
    """profile_window on a small window: five finite, positive stage times."""
    r = profile_gn.profile_window("cpu", iters=1, reps=1, img_size=IMG, num_kf=4, num_ow=3,
                                  fill_kf=3, fill_ow=2, M=16)
    assert list(r["ms"]) == list(profile_gn.STAGES)
    assert all(np.isfinite(v) and v > 0 for v in r["ms"].values())
    assert (r["D"], r["ND"]) == (8 * 7 + 3 * 64, 12 * 16)


# ---- bench_runtimes and probe_pair_throughput -------------------------------------

def test_bench_runtimes_runs_both_engines():
    """Both engines on the same pre-rendered frames (small window, 18 plane
    frames): finite FPS and ATE, one record each with the JAX keys."""
    ds = JDataset(n_frames=18, img_size=IMG, seed=0, step=0.02)
    frames = [(float(ds[i][0]), np.asarray(ds[i][1])) for i in range(len(ds))]
    for kind in bench_runtimes.ENGINES:
        r = bench_runtimes.run_once(kind, frames, np.asarray(ds.poses),
                                    np.asarray(ds.intrinsics), 0, "cpu", IMG, small_config())
        assert set(r) == {"fps", "ate_cm", "frames_tracked", "seed"}
        assert r["fps"] > 0 and np.isfinite(r["ate_cm"]) and r["frames_tracked"] >= 5, kind


def test_probe_pair_throughput_bursts():
    eng, rgb = probe_pair_throughput.probe_engine(20, IMG, "cpu", small_config())
    assert eng.mapping.is_init and eng.cfg.dispatch_depth == 2
    assert probe_pair_throughput.burst_single(eng, rgb, 2) > 0
    assert probe_pair_throughput.burst_pair(eng, rgb, 2) > 0


# ---- every tool's device rule --------------------------------------------------------

@pytest.mark.parametrize("name", DEVICE_TOOLS)
def test_tool_defaults_to_cuda_and_raises_without_it(name, monkeypatch, tmp_path):
    """--device defaults to cuda; with no CUDA device and no --device cpu
    main raises before any work (no dataset, no engine, no file)."""
    mod = importlib.import_module(f"como_tpu_torch.tools.{name}")
    assert mod.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)

    def no_work(*a, **k):
        raise AssertionError("work started without a device")

    for target in ("como_tpu_torch.data.synthetic.SyntheticDataset.__init__",
                   "como_tpu_torch.runtime.seq.ComoSeq.__init__",
                   "como_tpu_torch.odom.window.make_dims"):
        monkeypatch.setattr(target, no_work)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main([])
    assert list(tmp_path.iterdir()) == []


def test_default_outs_are_not_the_jax_files():
    assert eval_matrix.build_parser().parse_args([]).out == "results/torch_eval_matrix.json"
    assert (bench_runtimes.build_parser().parse_args([]).out
            == "results/torch_runtime_bench.json")


def test_card_line_and_device(monkeypatch):
    cpu = torch.device("cpu")
    assert common.card_line(cpu) == "cpu" and common.device_name(cpu) == "cpu"
    assert common.tool_device("cpu") == cpu
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        common.tool_device("cuda")
