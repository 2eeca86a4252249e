"""Port parity: keyframe insertion compute (prior, prep_keyframe,
_corr_and_prep) of como_tpu_torch against como_tpu at 48x64 (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from como_tpu.data.synthetic import PlaneScene
from como_tpu.geometry import lie as jlie
from como_tpu.net.depthcov import DepthCovPrior as JPrior
from como_tpu.odom import mapping as jmap
from como_tpu.odom.frontend import corr as jcorr
from como_tpu.utils.demo import anchor_grid as jax_anchor_grid
from como_tpu_torch.net.depthcov import DepthCovPrior as TPrior
from como_tpu_torch.odom import mapping as tmap
from como_tpu_torch.odom.frontend import corr as tcorr
from como_tpu_torch.utils.demo import anchor_grid as torch_anchor_grid
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

IMG = (48, 64)
M = 16


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def scene():
    sc = PlaneScene(img_size=IMG, seed=0)
    rgb0, depth0 = sc.render(jnp.eye(4))
    pose1 = jlie.se3_exp(jnp.array([0.003, -0.002, 0.001, 0.35, 0.05, 0.02], jnp.float32))
    rgb1, _ = sc.render(pose1)
    axy = np.asarray(jax_anchor_grid(IMG, M))
    d0 = np.asarray(depth0)[0, 0]
    logzm = np.log(d0[axy[:, 1].astype(int), axy[:, 0].astype(int)]).astype(np.float32)
    cov0 = np.asarray(JPrior().cov_params(rgb0))
    cov1 = np.asarray(JPrior().cov_params(rgb1))
    return dict(K=np.asarray(sc.K), rgb0=np.asarray(rgb0), rgb1=np.asarray(rgb1),
                pose1=np.asarray(pose1), axy=axy,
                axy_t=torch_anchor_grid(IMG, M, device="cpu"), logzm=logzm, cov0=cov0, cov1=cov1)


def test_prior_cov_params(scene):
    """The analytic prior with its 48x64 -> 192x256 -> 48x64 resizes
    (jax.image.resize antialiasing on the way down): 1e-3 relative, as
    1/(1 + 4000 * lambda) on the blurred structure tensor amplifies f32
    rounding ~1e3x at strong edges (observed 4e-4 on 6 of 9216 values)."""
    got = TPrior().cov_params(_t(scene["rgb0"]))
    np.testing.assert_allclose(got.numpy(), scene["cov0"], rtol=1e-3, atol=1e-6)


def test_prep_keyframe(scene):
    """Dense sites exactly; GP predictor rows within 1e-3 (they carry
    K_mm^-1, condition ~1e4, through an f32 Cholesky)."""
    pj = jmap.prep_keyframe(jnp.asarray(scene["rgb0"]), jnp.asarray(scene["cov0"]),
                            jnp.asarray(scene["axy"]), jnp.asarray(scene["K"]), 1.0, 4)
    pt = tmap.prep_keyframe(_t(scene["rgb0"]), _t(scene["cov0"]), scene["axy_t"],
                            _t(scene["K"]), 1.0, 4)
    np.testing.assert_array_equal(pt["dense_rc"].numpy(), np.asarray(pj["dense_rc"]))
    np.testing.assert_allclose(pt["iag"].numpy(), np.asarray(pj["iag"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pt["dense_vals"].numpy(), np.asarray(pj["dense_vals"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pt["L_mm"].numpy(), np.asarray(pj["L_mm"]), atol=1e-5)
    for k in ("Knm_full", "knm_colmean", "dense_knm"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=1e-3, err_msg=k)


def test_corr_and_prep(scene):
    """Insertion of a second keyframe: the same anchors are tracked (exact
    slot/source/pixel agreement) and their depths agree within 1e-3
    relative (distill solves through two f32 GP predictors)."""
    K = scene["K"]
    pj0 = jmap.prep_keyframe(jnp.asarray(scene["rgb0"]), jnp.asarray(scene["cov0"]),
                             jnp.asarray(scene["axy"]), jnp.asarray(K), 1.0, 4)
    ccfg = jcorr.CorrStatic(border=2)
    rj, prj, Pwj = jmap._corr_and_prep(
        jnp.eye(4), jnp.asarray(scene["pose1"]), jnp.asarray(scene["axy"]),
        jnp.asarray(scene["logzm"]), pj0["Knm_full"], jnp.asarray(scene["rgb1"]),
        jnp.asarray(scene["cov1"]), jnp.asarray(K), 1.0, M, ccfg, 4, IMG,
        jax.random.PRNGKey(0))
    rt, prt, Pwt = tmap._corr_and_prep(
        torch.eye(4), _t(scene["pose1"]), scene["axy_t"], _t(scene["logzm"]),
        _t(pj0["Knm_full"]), _t(scene["rgb1"]), _t(scene["cov1"]), _t(K), 1.0, M,
        tcorr.CorrStatic(border=2), 4, IMG)
    np.testing.assert_array_equal(rt.tracked.numpy(), np.asarray(rj.tracked))
    np.testing.assert_array_equal(rt.src_anchor.numpy(), np.asarray(rj.src_anchor))
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    assert rt.tracked.any() and (~rt.tracked).any()
    np.testing.assert_allclose(rt.coords_all.numpy(), np.asarray(rj.coords_all), atol=1e-4)
    np.testing.assert_allclose(rt.z_all.numpy(), np.asarray(rj.z_all), rtol=1e-3)
    np.testing.assert_allclose(Pwt.numpy(), np.asarray(Pwj), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(prt["Knm_full"].numpy(), np.asarray(prj["Knm_full"]), atol=1e-3)


def test_initial_anchors_clamp_unused_slots(scene):
    """More slots (200) than valid sites (border 21 leaves 6 x 22 = 132):
    every valid site is picked, and the unused slots' domain index -1 is
    clamped to site 0 (JAX clamps gathers; torch would wrap -1 to the last
    site, and CUDA would read out of range).  The order of the late picks is
    not compared: once most sites are taken the posterior variances left
    are f32 noise, and argmax among them differs between implementations."""
    args = dict(scale=1.0, M=200, border=21, dist_thresh=0.0, stdev_thresh=-1e8,
                fixed_var=0.0)
    n = 6 * 22
    rj = np.asarray(jmap.sample_initial_anchors(jnp.asarray(scene["cov0"]), **args))
    rt = tmap.sample_initial_anchors(_t(scene["cov0"]), **args).numpy()
    np.testing.assert_array_equal(rt[n:], np.zeros((200 - n, 2)))
    np.testing.assert_array_equal(rt[n:], rj[n:])
    np.testing.assert_array_equal(np.unique(rt[:n], axis=0), np.unique(rj[:n], axis=0))
    assert len(np.unique(rt[:n], axis=0)) == n
