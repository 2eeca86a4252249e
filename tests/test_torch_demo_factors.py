"""The port's demo window (utils/demo.py) and optional factors
(odom/backend/extra_factors.py) against the JAX package's on the same
inputs (numpy seeds, CPU), and the factors' Jacobians against
torch.autograd through the retraction."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from como_tpu.geometry import lie as jlie
from como_tpu.odom import window as jwin
from como_tpu.odom.backend import extra_factors as jxf
from como_tpu.utils import demo as jdemo
from como_tpu_torch.geometry import lie as tlie
from como_tpu_torch.odom import window as twin
from como_tpu_torch.odom.backend import extra_factors as txf
from como_tpu_torch.utils import demo as tdemo
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

IMG = (48, 64)
# Held to 1e-5: the fields that carry K_mm^-1 (entries up to ~4, condition
# ~1e4) through f32 sums in another order, and the analytic prior's
# covariance image (1 / (1 + 4000 * lambda) amplifies f32 rounding at strong
# edges: 2.8e-6 on 1 of 36,864 values).  Everything else is held to 2e-6.
GP_FIELDS = {"Kmm_inv": 1e-5, "Knm_full": 1e-5, "dense_knm": 1e-5, "cov_img": 1e-5}


@pytest.mark.parametrize("M", [16, 10, 64])
def test_anchor_grid_matches_jax(M):
    got = tdemo.anchor_grid(IMG, M, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (M, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdemo.anchor_grid(IMG, M)))


@pytest.mark.parametrize("channels,seed,scene_kwargs", [(1, 0, None), (3, 1, dict(chroma=True))],
                         ids=["gray", "rgb"])
def test_demo_state_matches_jax(channels, seed, scene_kwargs):
    """The two packages' demo windows, field by field (2e-6 abs on fields
    of order one; 1e-5 on the fields of GP_FIELDS)."""
    kw = dict(num_kf=4, num_ow=3, M=16, img_size=IMG, channels=channels)
    demo_kw = dict(num_kf=3, num_ow=2, seed=seed, channels=channels, scene_kwargs=scene_kwargs)
    sj, pj, Kj = jdemo.make_demo_state(jwin.make_dims(**kw), **demo_kw)
    st, pt, Kt = tdemo.make_demo_state(twin.make_dims(**kw), device="cpu", **demo_kw)
    np.testing.assert_array_equal(Kt.numpy(), np.asarray(Kj))
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert pt[0].dtype == pt[1].dtype == torch.int64 and pt[2].dtype == torch.bool
    for name, want in sj._asdict().items():
        got, want = getattr(st, name).numpy(), np.asarray(want)
        assert got.shape == want.shape, name
        if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=GP_FIELDS.get(name, 2e-6),
                                       err_msg=name)


def test_demo_state_defaults_to_cuda():
    import inspect
    for fn in (tdemo.anchor_grid, tdemo.make_demo_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def _rand_pose(rng):
    xi = rng.normal(size=6).astype(np.float32) * 0.3
    T = np.array(jlie.se3_exp(jnp.array(xi)))
    T[:3, 3] += rng.normal(size=3).astype(np.float32)
    return T


def test_pose_range_factor_matches_jax_and_autograd():
    """Residuals and Jacobians equal JAX's (1e-5) on a batch of 5 pose
    pairs, and the Jacobians equal autograd through T @ exp(xi) (1e-4, the
    bound tests/test_extra_factors.py uses against jax.jacfwd)."""
    rng = np.random.default_rng(0)
    P1 = np.stack([_rand_pose(rng) for _ in range(5)])
    P2 = np.stack([_rand_pose(rng) for _ in range(5)])
    meas = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    sigma = 0.05
    want = jxf.pose_range_factor(jnp.array(meas), jnp.array(P1), jnp.array(P2), sigma)
    T1, T2, tm = torch.from_numpy(P1), torch.from_numpy(P2), torch.from_numpy(meas)
    got = txf.pose_range_factor(tm, T1, T2, sigma)
    # whitened by 1 / sigma = 20: 1e-5 relative to the residuals' scale
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5 / sigma)
    assert np.isclose(float(got[3]), float((got[0] ** 2).sum()))

    def r_of(xi1, xi2):
        return txf.pose_range_factor(tm, T1 @ tlie.se3_exp(xi1), T2 @ tlie.se3_exp(xi2),
                                     sigma)[0]

    z = torch.zeros((5, 6))
    g1, g2 = torch.autograd.functional.jacobian(r_of, (z, z))
    idx = torch.arange(5)
    np.testing.assert_allclose(got[1].numpy(), g1[idx, idx].numpy(), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), g2[idx, idx].numpy(), atol=1e-4)


def test_dense_depth_prior_matches_jax_and_autograd():
    rng = np.random.default_rng(1)
    N, M = 40, 8
    W = (rng.normal(size=(N, M)) * 0.2).astype(np.float32)
    q = (rng.normal(size=(N, 6)) * 0.1).astype(np.float32)
    zm = rng.uniform(1.0, 3.0, M).astype(np.float32)
    dz = np.array([0.0, 0.0, 1.0], np.float32)
    target, sigma = 0.7, 0.2
    want = jxf.dense_depth_prior(jnp.array(W) @ jnp.log(jnp.array(zm)), jnp.float32(target),
                                 jnp.array(W), jnp.array(q), 1.0 / jnp.array(zm),
                                 jnp.array(dz), sigma)
    tW, tq, tz = torch.from_numpy(W), torch.from_numpy(q), torch.from_numpy(zm)
    got = txf.dense_depth_prior(tW @ torch.log(tz), target, tW, tq, 1.0 / tz,
                                torch.from_numpy(dz), sigma)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=k)

    # g_zm = -d(0.5 * info * r^2)/dz, H_zm the Gauss-Newton Hessian A^T A * info
    def cost(z):
        r = tW @ torch.log(z) - target
        return 0.5 * torch.sum(r ** 2) / sigma ** 2

    z = tz.clone().requires_grad_(True)
    (g_auto,) = torch.autograd.grad(cost(z), z)
    np.testing.assert_allclose(got["g_zm"].numpy(), -g_auto.numpy(), rtol=1e-4, atol=1e-5)
    A = torch.autograd.functional.jacobian(lambda z: tW @ torch.log(z) - target, tz)
    np.testing.assert_allclose(got["H_zm"].numpy(), (A.T @ A).numpy() / sigma ** 2,
                               rtol=1e-4, atol=1e-5)
    assert np.isfinite(float(got["err"]))
