"""Port parity: the dataset loaders of como_tpu_torch against como_tpu's on
fabricated mini-datasets (the fixtures of tests/test_datasets.py)."""

import inspect
import os

import numpy as np
import pytest
import torch

from como_tpu.data import datasets as jds
from como_tpu_torch.data import datasets as tds
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

cv2 = pytest.importorskip("cv2", reason="the disk loaders decode with OpenCV")

IMG = (192, 256)


def make_tum(tmp_path, freiburg=2, n=3):
    seq = tmp_path / f"rgbd_dataset_freiburg{freiburg}_test"
    os.makedirs(seq / "rgb")
    lines = ["# header\n"] * 3
    rng = np.random.default_rng(freiburg)
    for i in range(n):
        cv2.imwrite(str(seq / "rgb" / f"{i}.png"),
                    rng.integers(0, 255, (480, 640, 3), dtype=np.uint8))
        lines.append(f"{i / 30.0:.4f} rgb/{i}.png\n")
    (seq / "rgb.txt").write_text("".join(lines))
    return str(seq) + "/"


def make_replica(tmp_path, n=3):
    res = tmp_path / "room0" / "results"
    os.makedirs(res)
    rng = np.random.default_rng(1)
    for i in range(n):
        cv2.imwrite(str(res / f"frame{i:06d}.jpg"),
                    rng.integers(0, 255, (680, 1200, 3), dtype=np.uint8))
    return str(tmp_path / "room0")


def make_scannet(tmp_path, n=3):
    scene = tmp_path / "scene0000_00"
    os.makedirs(scene / "color")
    rng = np.random.default_rng(2)
    for i in range(n):
        cv2.imwrite(str(scene / "color" / f"{i}.jpg"),
                    rng.integers(0, 255, (968, 1296, 3), dtype=np.uint8))
    (scene / "scene0000_00.txt").write_text(
        "colorHeight = 968\ncolorWidth = 1296\nfx_color = 1170.2\nfy_color = 1170.2\n"
        f"mx_color = 647.75\nmy_color = 483.75\nnumColorFrames = {n}\n")
    return str(scene)


def _same(j, t):
    assert len(t) == len(j) > 0
    assert t.save_traj_name == j.save_traj_name
    assert t.is_live == j.is_live is False
    assert t.intrinsics.dtype == torch.float32 and t.intrinsics.device.type == "cpu"
    np.testing.assert_allclose(t.intrinsics.numpy(), np.asarray(j.intrinsics),
                               rtol=1e-6, atol=1e-6)
    for i in range(len(j)):
        ts_j, rgb_j = j[i]
        ts_t, rgb_t = t[i]
        assert ts_t == ts_j
        assert isinstance(rgb_t, np.ndarray) and rgb_t.dtype == np.float32
        assert rgb_t.shape == (1, 3) + IMG and rgb_t.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(rgb_t, np.asarray(rgb_j))


@pytest.mark.parametrize("freiburg", [1, 2, 3])
def test_tum(tmp_path, freiburg):
    """freiburg1/2 carry plumb-bob distortion (undistort-rectify maps),
    freiburg3 does not."""
    path = make_tum(tmp_path, freiburg)
    j, t = jds.TumDataset(path, IMG), tds.TumDataset(path, IMG, device="cpu")
    _same(j, t)
    assert (t.map1 is None) == (freiburg == 3)
    if t.map1 is not None:
        np.testing.assert_array_equal(t.map1, j.map1)


def test_replica(tmp_path):
    path = make_replica(tmp_path)
    _same(jds.ReplicaDataset(path, IMG), tds.ReplicaDataset(path, IMG, device="cpu"))


@pytest.mark.parametrize("crop", [8, 0])
def test_scannet(tmp_path, crop):
    path = make_scannet(tmp_path)
    _same(jds.ScanNetDataset(path, IMG, crop_size=crop),
          tds.ScanNetDataset(path, IMG, crop_size=crop, device="cpu"))


@pytest.mark.parametrize("kind", ["tum", "replica", "scannet"])
def test_factory_disk(tmp_path, kind):
    path = {"tum": make_tum, "replica": make_replica, "scannet": make_scannet}[kind](tmp_path)
    _same(jds.get_dataset(kind, IMG, path), tds.get_dataset(kind, IMG, path, device="cpu"))


@pytest.mark.parametrize("name,scene", [("synthetic", "plane"),
                                        ("synthetic:clutter", "clutter"),
                                        ("synthetic:plane_chroma", "plane_chroma")])
def test_factory_synthetic(name, scene):
    j = jds.get_dataset(name, (48, 64), n_frames=5)
    t = tds.get_dataset(name, (48, 64), n_frames=5, device="cpu")
    assert len(t) == len(j) == 5 and t.save_traj_name == j.save_traj_name
    assert type(t.scene).__name__ == type(j.scene).__name__
    assert t.scene.chroma == ("chroma" in scene)
    ts, rgb = t[3]
    assert ts == j[3][0] and rgb.shape == (1, 3, 48, 64) and rgb.device.type == "cpu"
    np.testing.assert_allclose(rgb.numpy(), j[3][1], atol=5e-5)
    assert len(tds.get_dataset("synthetic", (48, 64), device="cpu")) == 120


def test_factory_unknown_type_raises():
    with pytest.raises(ValueError, match="unknown dataset_type"):
        tds.get_dataset("kitti", IMG, device="cpu")
    with pytest.raises(ValueError):
        tds.get_dataset("synthetic:maze", IMG, device="cpu")


def test_realsense_is_gated():
    """pyrealsense2 is an optional dependency: asking for the live camera
    without it fails with ImportError, not at import of the module."""
    try:
        import pyrealsense2  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            tds.get_dataset("realsense", IMG, device="cpu")
    assert tds.RealsenseDataset.is_live is True


@pytest.mark.parametrize("fn", [tds.get_dataset, tds.TumDataset.__init__,
                                tds.ReplicaDataset.__init__, tds.ScanNetDataset.__init__,
                                tds.RealsenseDataset.__init__],
                         ids=lambda f: f.__qualname__)
def test_loaders_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
