"""Port parity: synthetic scenes of como_tpu_torch render the frames of
como_tpu's (same numpy-seeded parameters and trajectories), CPU."""

import numpy as np
import pytest

from como_tpu.data.synthetic import SyntheticDataset as JDS
from como_tpu_torch.data.synthetic import SyntheticDataset as TDS


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
