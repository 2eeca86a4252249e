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


@pytest.mark.parametrize("scene,atol", [("plane", 1e-5), ("clutter", 5e-5)])
def test_frames_and_poses_match(scene, atol):
    """Trajectories within 1e-5 (f32 pose products chained over frames);
    plane frames within 1e-5; clutter frames within 5e-5: the f32 ray-hit
    distances of its primitives agree to ~1.5e-5 relative, and its texture
    (24 sines of arguments up to ~30 rad of the hit point) amplifies that
    (observed 2e-5 on 12 of 9216 pixels); depth within 1e-4 relative."""
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
    with pytest.raises(ValueError):
        TDS(n_frames=2, img_size=(48, 64), scene="clutter_photo", device="cpu")


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
