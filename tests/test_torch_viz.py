"""Port parity of the viewers (como_tpu_torch/viz/) against como_tpu/viz/:
the numpy scene geometry, the snapshot viewer's PNG and overlay, the Open3D
viewer against a stub module, the product path with a viewer attached, and
the splat renderer against JAX's (CPU, 48x64).  The counterpart of each
test in tests/test_viz_geometry.py."""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from como_tpu.viz import geometry as jvg
from como_tpu.viz import viewer as jviewer
from como_tpu.viz.renderer import render_map as jax_render_map
from como_tpu_torch.viz import geometry as tvg
from como_tpu_torch.viz import renderer as trenderer
from como_tpu_torch.viz import viewer as tviewer
from como_tpu_torch.viz.png import read_png, write_png
from torch_testing import render_scene

K_TEST = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
GREEN, RED = np.array([40, 230, 70]), np.array([235, 60, 60])


def _equal_tree(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_tree(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_frustum_and_trajectory():
    pts, lines = tvg.frustum_lineset(np.eye(4), K_TEST, (48, 64), scale=0.2)
    assert pts.shape == (5, 3) and lines.shape == (8, 2)
    np.testing.assert_allclose(pts[0], 0.0)
    assert np.all(pts[1:, 2] > 0)
    _equal_tree((pts, lines), jvg.frustum_lineset(np.eye(4), K_TEST, (48, 64), scale=0.2))
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, 0, 3] = np.arange(5)
    pts, lines = tvg.trajectory_lineset(poses)
    assert pts.shape == (5, 3) and lines.shape == (4, 2)
    _equal_tree((pts, lines), jvg.trajectory_lineset(poses))


def test_normals_plane():
    depth = np.full((48, 64), 2.0)   # frontoparallel plane
    n = tvg.normals_from_depth(depth, K_TEST)
    assert np.abs(np.abs(n[8:-8, 8:-8, 2]) - 1.0).max() < 1e-6
    bumpy = depth + np.random.default_rng(0).uniform(0, 0.1, depth.shape)
    np.testing.assert_array_equal(tvg.normals_from_depth(bumpy, K_TEST),
                                  jvg.normals_from_depth(bumpy, K_TEST))


@pytest.mark.parametrize("cos_thresh", [0.0, 0.5])
def test_pointcloud_and_follow(cos_thresh):
    rng = np.random.default_rng(0)
    rgbs = rng.uniform(size=(2, 3, 48, 64))
    depths = 2.0 + rng.uniform(0, 0.2, size=(2, 1, 48, 64))
    poses = np.tile(np.eye(4), (2, 1, 1))
    pts, cols = tvg.keyframe_pointcloud(rgbs, depths, poses, K_TEST, stride=4,
                                        cos_thresh=cos_thresh)
    assert pts.shape == cols.shape[:1] + (3,)
    if cos_thresh == 0.0:
        assert len(pts) == 2 * (48 // 4) * (64 // 4)
    _equal_tree((pts, cols), jvg.keyframe_pointcloud(rgbs, depths, poses, K_TEST, stride=4,
                                                     cos_thresh=cos_thresh))
    Tf = tvg.follow_camera_pose(np.eye(4))
    assert Tf[2, 3] < 0 and Tf[1, 3] < 0
    np.testing.assert_array_equal(Tf, jvg.follow_camera_pose(np.eye(4)))


def _fake_viz(n_kf=3, n_ow=2, hw=(48, 64)):
    """tests/test_viz_geometry.py::_fake_viz."""
    rng = np.random.default_rng(1)
    poses = np.tile(np.eye(4), (n_kf, 1, 1))
    poses[:, 0, 3] = 0.1 * np.arange(n_kf)
    ow = np.tile(np.eye(4), (n_ow, 1, 1))
    ow[:, 1, 3] = 0.05
    return dict(
        poses=poses, ow_poses=ow,
        rgbs=rng.uniform(size=(n_kf, 3) + hw).astype(np.float32),
        depths=np.full((n_kf, 1) + hw, 2.0, np.float32),
        P_lm=rng.uniform(-1, 1, size=(20, 3)),
        lm_valid=np.arange(20) < 12,
    )


def test_build_scene_all_elements():
    """Scene parity with the reference GUI and with the JAX package's
    build_scene, from host data and from tensors through viz_to_host."""
    scene = tviewer.build_scene(_fake_viz(), K_TEST, (48, 64))
    assert len(scene["kf_frustums"]) == 3
    assert len(scene["ow_frustums"]) == 2
    assert scene["trajectory"][0].shape == (3, 3)
    assert scene["landmarks"].shape == (12, 3)
    assert scene["pcd_points"].shape[0] == scene["pcd_colors"].shape[0] > 0
    assert scene["follow_pose"].shape == (4, 4)
    kf_span = np.ptp(scene["kf_frustums"][0][0][:, 0])
    ow_span = np.ptp(scene["ow_frustums"][0][0][:, 0])
    assert ow_span < kf_span
    want = jviewer.build_scene(_fake_viz(), K_TEST, (48, 64))
    assert scene.keys() == want.keys()
    for k in scene:
        _equal_tree(scene[k], want[k])
    as_tensors = {k: torch.from_numpy(v) for k, v in _fake_viz().items()}
    again = tviewer.build_scene(tviewer.viz_to_host(as_tensors), K_TEST, (48, 64))
    _equal_tree(again["pcd_points"], scene["pcd_points"])


class _Map:
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]], dtype=np.float32)


class _Eng:
    mapping = _Map()


def test_snapshot_viewer_overlay(tmp_path):
    """The PNG holds the trajectory overlay, projected with the renderer's
    output-canvas-scaled intrinsics (read back with PIL)."""
    from PIL import Image

    viz = _fake_viz()
    viz["poses"][:, 2, 3] = 1.5          # in front of the identity camera
    v = tviewer.SnapshotViewer(_Eng(), out_dir=str(tmp_path), period_s=0.0, follow=False)
    v(viz)
    files = list(tmp_path.glob("*.png"))
    assert len(files) == 1 and v.failures == 0
    img = np.array(Image.open(files[0]))
    assert img.shape == (384, 512, 3)
    green = np.argwhere(np.all(img == GREEN, axis=-1))
    assert len(green), "no trajectory overlay drawn"
    out_h, out_w = img.shape[:2]
    sx, sy = out_w / 64, out_h / 48
    fx, cx, fy, cy = 100.0 * sx, 32.0 * sx, 100.0 * sy, 24.0 * sy
    traj = viz["poses"][:, :3, 3]
    u_exp = fx * traj[:, 0] / traj[:, 2] + cx
    v_exp = fy * traj[:, 1] / traj[:, 2] + cy
    assert abs(green[:, 0] - v_exp[0]).min() <= 1.5
    assert green[:, 1].min() >= np.floor(u_exp.min()) - 1
    assert green[:, 1].max() <= np.ceil(u_exp.max()) + 1
    # a snapshot that fails is counted and does not raise
    v({"poses": viz["poses"]})
    assert v.failures == 1 and len(list(tmp_path.glob("*.png"))) == 1


def _o3d_stub(calls, create_window_error=None):
    """The open3d API surface the viewer calls, and nothing more (any new
    call raises AttributeError here instead of on a user's machine)."""

    class _Vec:
        def __init__(self, arr):
            arr = np.asarray(arr)
            assert arr.ndim == 2 and arr.shape[1] in (2, 3)

    class _Geom:
        def __init__(self):
            self.points = None
            self.colors = None
            self.lines = None

        def paint_uniform_color(self, c):
            assert len(c) == 3

    class _Cam:
        extrinsic = np.eye(4)

    class _ViewControl:
        def convert_to_pinhole_camera_parameters(self):
            return _Cam()

        def convert_from_pinhole_camera_parameters(self, cam, allow):
            assert cam.extrinsic.shape == (4, 4)

    class _Vis:
        def create_window(self, name, width, height):
            if create_window_error is not None:
                raise create_window_error

        def register_key_callback(self, key, cb):
            calls["keys"].append(key)

        def add_geometry(self, g):
            calls["added"] += 1

        def update_geometry(self, g):
            calls["updated"] += 1

        def poll_events(self):
            calls["polled"] += 1

        def update_renderer(self):
            pass

        def get_view_control(self):
            return _ViewControl()

    o3d = types.ModuleType("open3d")
    o3d.visualization = types.SimpleNamespace(VisualizerWithKeyCallback=_Vis)
    o3d.geometry = types.SimpleNamespace(PointCloud=_Geom, LineSet=_Geom)
    o3d.utility = types.SimpleNamespace(Vector3dVector=_Vec, Vector2iVector=_Vec)
    return o3d


def test_open3d_viewer_smoke_with_stub(monkeypatch):
    calls = {"added": 0, "updated": 0, "polled": 0, "keys": []}
    monkeypatch.setitem(sys.modules, "open3d", _o3d_stub(calls))
    engine = types.SimpleNamespace(
        mapping=types.SimpleNamespace(K=torch.from_numpy(K_TEST), img_size=(48, 64)))
    viewer = tviewer.attach_viewer(engine)
    assert isinstance(viewer, tviewer.Open3DViewer) and engine.viz_listener is viewer
    assert len(calls["keys"]) == 4           # space/N/F/S controls bound
    viz = {k: torch.from_numpy(v) for k, v in _fake_viz().items()}
    viewer(viz)                              # first update: add_geometry
    assert calls["added"] == 4 and calls["polled"] >= 1
    viewer(viz)                              # steady state: update_geometry
    assert calls["updated"] == 4


def test_attach_viewer_falls_back_only_without_open3d(monkeypatch, tmp_path):
    """No open3d: the snapshot viewer.  open3d present but failing (no
    display, say): the error reaches the caller."""
    monkeypatch.setitem(sys.modules, "open3d", None)       # import raises ImportError
    eng = types.SimpleNamespace(viz_listener=None)
    v = tviewer.attach_viewer(eng, out_dir=str(tmp_path / "viz"))
    assert isinstance(v, tviewer.SnapshotViewer) and eng.viz_listener is v
    calls = {"added": 0, "updated": 0, "polled": 0, "keys": []}
    monkeypatch.setitem(sys.modules, "open3d",
                        _o3d_stub(calls, RuntimeError("no display")))
    with pytest.raises(RuntimeError, match="no display"):
        tviewer.attach_viewer(types.SimpleNamespace(viz_listener=None))


def test_snapshot_viewer_product_path(tmp_path):
    """ComoSeq on 20 clutter frames with the SnapshotViewer as its
    viz_listener: one PNG per listener call, each 384x512x3 with overlay
    pixels, and no failed snapshot."""
    from PIL import Image

    from como_tpu_torch.config import ComoConfig
    from como_tpu_torch.data.synthetic import SyntheticDataset
    from como_tpu_torch.runtime.seq import ComoSeq

    img = (48, 64)
    cfg = ComoConfig()
    cfg.img_size = list(img)
    cfg.mapping.graph.num_keyframes = 4
    cfg.mapping.graph.num_one_way_frames = 4
    cfg.mapping.sampling.max_num_coords = 16
    cfg.mapping.sampling.border = 2
    cfg.validate()
    ds = SyntheticDataset(n_frames=20, img_size=img, seed=0, step=0.012, scene="clutter",
                          device="cpu")
    eng = ComoSeq(cfg, ds.intrinsics, img, device="cpu")
    eng.setup()
    viewer = tviewer.SnapshotViewer(eng, out_dir=str(tmp_path), period_s=0.0)
    calls = []
    eng.viz_listener = lambda viz: (calls.append(viz), viewer(viz))
    eng.run(ds)
    files = sorted(tmp_path.glob("*.png"))
    assert viewer.failures == 0 and len(files) == len(calls) > 0
    assert all(isinstance(calls[-1][k], torch.Tensor) for k in ("rgbs", "poses", "depths"))
    arr = np.array(Image.open(files[-1]))
    assert arr.shape == (384, 512, 3)
    np.testing.assert_array_equal(read_png(files[-1]), arr)
    overlay = np.all(arr == GREEN, axis=-1).sum() + np.all(arr == RED, axis=-1).sum()
    assert overlay > 0, "no overlay pixels in the product snapshot"


# ---------------------------------------------------------------------------
# the splat renderer

def _numpy_splat(u, v, z, ok, col, out_size, splat=2):
    """The port's colour rule and the JAX package's scatter-set, candidate
    by candidate in key order (splat offset, point).  Also flags the
    pixels where a losing candidate follows a winner in one pass: there
    JAX's result depends on the order of its duplicate writes."""
    oh, ow = out_size
    ui, vi = np.clip(u.astype(np.int64), 0, ow - 1), np.clip(v.astype(np.int64), 0, oh - 1)
    idx = [np.clip(vi + dy, 0, oh - 1) * ow + np.clip(ui + dx, 0, ow - 1)
           for dy in range(splat) for dx in range(splat)]
    big = np.float32(1e9)
    zq = np.where(ok, z, big).astype(np.float32)
    zbuf = np.full(oh * ow, big, np.float32)
    for ix in idx:
        np.minimum.at(zbuf, ix, zq)
    port = np.zeros((oh * ow, 3), np.float32)
    jax_img = np.zeros((oh * ow, 3), np.float32)
    stale = np.zeros(oh * ow, bool)
    for ix in idx:
        win = ok & (zq <= zbuf[ix] * np.float32(1.0 + 1e-4))
        before = jax_img.copy()
        won = np.zeros(oh * ow, bool)
        for p in range(len(ix)):
            q = ix[p]
            if win[p]:
                port[q] = col[p]
                jax_img[q] = col[p]
                won[q] = True
            else:
                jax_img[q] = before[q]
                stale[q] |= won[q]
    depth = np.where(zbuf >= big, 0.0, zbuf).reshape(oh, ow)
    return (port.reshape(oh, ow, 3), jax_img.reshape(oh, ow, 3), depth,
            stale.reshape(oh, ow))


@pytest.mark.parametrize("shaded", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_render_map_matches_jax(seed, shaded):
    """Depth: JAX's within 1e-6.  Colour: JAX's wherever JAX's result is
    well defined (no losing candidate after a winner on the pixel), bitwise
    without shading; with shading the depth gradients are convolutions
    summed in another order, so the colours agree to 1e-6 there.  Against
    the rule written out in numpy: equal everywhere, and JAX's output is
    the numpy scatter-set's (the stale writes of ROADMAP §3)."""
    args = render_scene(seed)
    out = (96, 128)        # twice the keyframes' size, as 384x512 is of 192x256
    rgb_j, depth_j = (np.asarray(a) for a in jax_render_map(
        *(jnp.asarray(a) for a in args), out_size=out, shaded=shaded))
    targs = [torch.from_numpy(np.array(a)) for a in args]
    rgb_t, depth_t = (a.numpy() for a in trenderer.render_map(*targs, out_size=out,
                                                              shaded=shaded))
    assert (depth_t > 0).sum() > 0.3 * depth_t.size
    np.testing.assert_allclose(depth_t, depth_j, rtol=1e-6, atol=0)
    proj = [a.numpy() for a in trenderer._project(*targs, out_size=out, shaded=shaded)]
    port, jax_sim, depth_np, stale = _numpy_splat(*proj, out)
    np.testing.assert_array_equal(rgb_t, port)
    np.testing.assert_array_equal(depth_t, depth_np)
    assert 0 < stale.sum() < 0.25 * stale.size
    if shaded:
        np.testing.assert_allclose(rgb_t[~stale], rgb_j[~stale], atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(rgb_t[~stale], rgb_j[~stale])
        np.testing.assert_array_equal(jax_sim, rgb_j)
        assert np.any(rgb_t[stale] != rgb_j[stale])
    rgb_2, depth_2 = trenderer.render_map(*targs, out_size=out, shaded=shaded)
    assert torch.equal(rgb_2, torch.from_numpy(rgb_t)) and torch.equal(
        depth_2, torch.from_numpy(depth_t))


def test_png_roundtrip(tmp_path):
    """write_png's files read back, through PIL and through read_png."""
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    path = tmp_path / "x.png"
    write_png(path, img)
    np.testing.assert_array_equal(np.array(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(path), img)
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "y.png", img.astype(np.float32))
    data = bytearray(path.read_bytes())
    data[40] ^= 1                             # inside the image data
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(tmp_path / "bad.png")
