"""Port parity: synthetic scenes of como_tpu_torch render the frames of
como_tpu's (same numpy-seeded parameters and trajectories), CPU."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from como_tpu.data import synthetic as jsyn
from como_tpu.data.synthetic import SyntheticDataset as JDS
from como_tpu.ops.coords import coord_grid_rc as jgrid
from como_tpu_torch.data import synthetic as tsyn
from como_tpu_torch.data.synthetic import SyntheticDataset as TDS
from como_tpu_torch.ops.coords import coord_grid_rc as tgrid
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)


@pytest.mark.parametrize("scene,atol", [("plane", 1e-5), ("clutter", 5e-5),
                                        ("plane_chroma", 1e-5), ("clutter_chroma", 1e-4)])
def test_frames_and_poses_match(scene, atol):
    """Trajectories within 1e-5 (f32 pose products chained over frames);
    plane frames within 1e-5; clutter frames within 5e-5: the f32 ray-hit
    distances of its primitives agree to ~1.5e-5 relative, and its texture
    (24 sines of arguments up to ~30 rad of the hit point) amplifies that
    (observed 2e-5 on 12 of 9216 pixels); depth within 1e-4 relative.  The
    chromatic plane is held to the gray plane's tolerance; the chromatic
    clutter to 1e-4: the same hit-distance rounding reaches three
    independently phased channels (observed 9.3e-5 on 3 of 27,648 values,
    5e-5 exceeded nowhere else)."""
    kw = dict(n_frames=12, img_size=(48, 64), seed=1, step=0.02, scene=scene)
    j, t = JDS(**kw), TDS(**kw, device="cpu")
    np.testing.assert_allclose(t.poses, np.asarray(j.poses), atol=1e-5)
    np.testing.assert_allclose(t.intrinsics.numpy(), np.asarray(j.intrinsics))
    for i in (0, 5, 11):
        ts_j, rgb_j = j[i]
        ts_t, rgb_t = t[i]
        assert ts_j == ts_t
        np.testing.assert_allclose(rgb_t.numpy(), rgb_j, atol=atol)
        np.testing.assert_allclose(t.gt_depth(i).numpy(), j.gt_depth(i), rtol=1e-4)


def test_unported_variants_raise():
    """Every variant of the JAX package exists; an unknown base or variant
    raises, as there."""
    for scene in ("clutter_sepia", "maze", "maze_photo"):
        with pytest.raises(ValueError):
            TDS(n_frames=2, img_size=(48, 64), scene=scene, device="cpu")
        with pytest.raises(ValueError):
            JDS(n_frames=2, img_size=(48, 64), scene=scene)
    assert len(TDS(n_frames=2, img_size=(48, 64), scene="clutter_photo", device="cpu")) == 2


def test_chroma_channels_differ():
    _, rgb = TDS(n_frames=2, img_size=(48, 64), scene="clutter_chroma", device="cpu")[1]
    assert float((rgb[0, 0] - rgb[0, 1]).abs().max()) > 0.05
    _, gray = TDS(n_frames=2, img_size=(48, 64), scene="clutter", device="cpu")[1]
    assert torch.equal(gray[0, 0], gray[0, 2])


@pytest.mark.parametrize("scene", ["clutter_photo", "plane_photo"])
def test_photo_variant(scene):
    """The exposure/bias walk and the vignette map equal the JAX package's;
    the sensor noise is another draw of the same distribution: the frame
    minus JAX's frame has zero mean and the std of the difference of two
    independent noise fields, sqrt(2) * noise_sigma, within 20%."""
    kw = dict(n_frames=8, img_size=(48, 64), seed=3, step=0.02, scene=scene)
    j, t = JDS(**kw), TDS(**kw, device="cpu")
    assert t.nuisance == tsyn.PHOTO_NUISANCE == tuple(jsyn.PHOTO_NUISANCE)
    np.testing.assert_array_equal(t.gt_aff, j.gt_aff)
    for i in (0, 7):
        np.testing.assert_array_equal(t.gt_affine(i), j.gt_affine(i))
    np.testing.assert_allclose(t._vmap.numpy(), np.asarray(j._vmap), rtol=1e-7)
    assert t.is_live is False and t.save_traj_name == j.save_traj_name == "synthetic"
    sigma = tsyn.PHOTO_NUISANCE.noise_sigma
    for i in (1, 6):
        ts_j, rgb_j = j[i]
        ts_t, rgb_t = t[i]
        assert ts_j == ts_t and rgb_t.shape == (1, 3, 48, 64)
        d = rgb_t.numpy() - rgb_j
        assert abs(d.mean()) < 4 * np.sqrt(2) * sigma / np.sqrt(d.size)
        assert 0.8 * np.sqrt(2) * sigma < d.std() < 1.2 * np.sqrt(2) * sigma
        assert torch.equal(t[i][1], rgb_t)              # same (seed, idx): same frame
    assert not torch.equal(t[1][1] - t.scene.render(t._poses_dev[1])[0],
                           t[2][1] - t.scene.render(t._poses_dev[2])[0])
    # without noise the nuisance is deterministic and equals JAX's
    nz = tsyn.PhotoNuisance(exposure_jitter=0.04, bias_jitter=0.01, vignette=0.15)
    j0 = JDS(**kw, nuisance=jsyn.PhotoNuisance(*nz))
    t0 = TDS(**kw, nuisance=nz, device="cpu")
    np.testing.assert_allclose(t0[5][1].numpy(), j0[5][1], atol=6e-5)
    np.testing.assert_array_equal(TDS(**{**kw, "scene": "plane"}, device="cpu").gt_affine(3),
                                  np.zeros(2, np.float32))


@pytest.mark.parametrize("scene,atol", [("PlaneScene", 1e-5), ("ClutterScene", 5e-5)])
def test_scene_classes_on_cpu(scene, atol):
    """The scene classes built with device="cpu" render the JAX scenes'
    frames (tolerances as in test_frames_and_poses_match) and keep every
    tensor on the CPU."""
    j = getattr(jsyn, scene)(img_size=(48, 64), seed=2)
    t = getattr(tsyn, scene)(img_size=(48, 64), seed=2, device="cpu")
    assert t.K.device.type == "cpu"
    T = t.trajectory(6)[5]
    np.testing.assert_allclose(T, np.asarray(j.trajectory(6))[5], atol=1e-5)
    rgb_j, z_j = j.render(jnp.asarray(T))
    rgb_t, z_t = t.render(torch.from_numpy(T))
    assert rgb_t.device.type == "cpu" and rgb_t.shape == (1, 3, 48, 64)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=atol)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-4)


def test_intrinsics_and_grid_on_cpu():
    K = tsyn.default_intrinsics((48, 64), device="cpu")
    assert K.device.type == "cpu" and K.dtype == torch.float32
    np.testing.assert_array_equal(K.numpy(), np.asarray(jsyn.default_intrinsics((48, 64))))
    g = tgrid((5, 7), device="cpu")
    assert g.device.type == "cpu" and g.dtype == torch.float32
    np.testing.assert_array_equal(g.numpy(), np.asarray(jgrid((5, 7))))


@pytest.mark.parametrize("fn", [tsyn.default_intrinsics, tsyn.PlaneScene.__init__,
                                tsyn.ClutterScene.__init__, tsyn.SyntheticDataset.__init__,
                                tgrid], ids=lambda f: f.__qualname__)
def test_helpers_default_to_cuda(fn):
    """Signature only: nothing is built on a card here."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"
