"""Port parity: the IC tracking solve and the decision stats of
como_tpu_torch against como_tpu on a 48x64 plane pair (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from como_tpu.data.synthetic import PlaneScene
from como_tpu.geometry import lie as jlie
from como_tpu.odom import tracking as jtr
from como_tpu.odom.frontend import tracking_kernels as jtk
from como_tpu.ops import image as jimg
from como_tpu_torch.odom import tracking as ttr
from como_tpu_torch.odom.frontend import tracking_kernels as ttk
from como_tpu_torch.ops import image as timg

IMG = (48, 64)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def pair():
    scene = PlaneScene(img_size=IMG, seed=0)
    rgb0, depth0 = scene.render(jnp.eye(4))
    xi = jnp.array([0.004, -0.003, 0.002, 0.03, -0.01, 0.02], jnp.float32)
    T1 = jlie.se3_exp(xi)
    rgb1, _ = scene.render(T1)
    return dict(K=np.asarray(scene.K), rgb0=np.asarray(rgb0), depth0=np.asarray(depth0),
                rgb1=np.asarray(rgb1), T1=np.asarray(T1))


def test_reference_levels_match(pair):
    pose = np.eye(4, dtype=np.float32)[None]
    lj = jtr.build_reference(jnp.asarray(pair["rgb0"]), jnp.asarray(pose),
                             jnp.asarray(pair["depth0"]), jnp.asarray(pair["K"]),
                             0, 3, "nearest_neighbor")
    lt = ttr.build_reference(_t(pair["rgb0"]), _t(pose), _t(pair["depth0"]), _t(pair["K"]),
                             0, 3, "nearest_neighbor")
    for a, b in zip(lt, lj):
        for fa, fb in zip(a, b):
            np.testing.assert_allclose(fa.numpy(), np.asarray(fb), rtol=1e-5, atol=1e-5)


def test_track_pyramid_and_frame_stats(pair):
    """Final pose/affine after the masked fixed-count loop equal the JAX
    while-loop's within 1e-4 (an iterative f32 solve of ~10 steps per
    level, each re-deriving the MAD sigma; observed ~1e-6)."""
    pose = np.eye(4, dtype=np.float32)[None]
    term = dict(max_iter=30, delta_norm=1e-3, rel_tol=1e-3, grad_norm=1.0, abs_tol=1e-6)
    lj = jtr.build_reference(jnp.asarray(pair["rgb0"]), jnp.asarray(pose),
                             jnp.asarray(pair["depth0"]), jnp.asarray(pair["K"]),
                             0, 3, "nearest_neighbor")
    lt = ttr.build_reference(_t(pair["rgb0"]), _t(pose), _t(pair["depth0"]), _t(pair["K"]),
                             0, 3, "nearest_neighbor")
    pyr_j = jimg.image_pyramid(jimg.rgb_to_gray(jnp.asarray(pair["rgb1"])), 0, 3)
    pyr_t = timg.image_pyramid(timg.rgb_to_gray(_t(pair["rgb1"])), 0, 3)
    Tj, aj, itj = jtk.track_pyramid(lj, pyr_j, jnp.eye(4), jnp.zeros(2),
                                    jtk.TermStatic(**term))
    Tt, at, itt = ttk.track_pyramid(lt, pyr_t, torch.eye(4), torch.zeros(2),
                                    ttk.TermStatic(**term))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-4)
    np.testing.assert_array_equal(itt.numpy(), np.asarray(itj))
    # tracking recovers the true relative motion (frame-from-KF)
    np.testing.assert_allclose(Tt.numpy()[:3, 3],
                               np.linalg.inv(pair["T1"])[:3, 3], atol=2e-3)

    T_w_kf = np.eye(4, dtype=np.float32)
    fin_j, fin_t = lj[-1], lt[-1]
    Twj, sj = jtr.frame_stats(fin_j.P, fin_j.mask, Tj, jnp.asarray(T_w_kf), fin_j.K, IMG)
    Twt, st = ttr.frame_stats(fin_t.P, fin_t.mask, _t(np.asarray(Tj)), _t(T_w_kf),
                              fin_t.K, IMG)
    np.testing.assert_allclose(Twt.numpy(), np.asarray(Twj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-5)
