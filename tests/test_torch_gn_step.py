"""Port parity: the mapping GN step of como_tpu_torch against como_tpu, each
on its own package's demo window (utils/demo.py::make_demo_state, CPU; the
two windows are held equal in tests/test_torch_demo_factors.py)."""

import numpy as np
import pytest
import torch

from como_tpu.odom import window as jwin
from como_tpu.odom.backend import gn_step as jgn
from como_tpu.utils.demo import make_demo_state as jax_demo_state
from como_tpu_torch.odom import window as twin
from como_tpu_torch.odom.backend import gn_step as tgn
from como_tpu_torch.utils.demo import make_demo_state as torch_demo_state
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

SIGMAS = dict(occlusion_thresh=0.1)


@pytest.fixture(scope="module")
def demo():
    dims_j = jwin.make_dims(num_kf=4, num_ow=3, M=16, img_size=(48, 64))
    st, pairs, K = jax_demo_state(dims_j, num_kf=3, num_ow=2)
    fields = {k: np.asarray(v) for k, v in st._asdict().items()}
    dims_t = twin.make_dims(num_kf=4, num_ow=3, M=16, img_size=(48, 64))
    st_t, pairs_t, K_t = torch_demo_state(dims_t, num_kf=3, num_ow=2, device="cpu")
    return dict(st=st, pairs=pairs, K=K, dims_j=dims_j, st_t=st_t, pairs_t=pairs_t,
                K_t=K_t, dims_t=dims_t, fields=fields)


def test_state_roundtrip(demo):
    """A JAX window carried over with state_from_numpy and back."""
    back = twin.state_to_numpy(twin.state_from_numpy(demo["fields"], "cpu"))
    for k, v in demo["fields"].items():
        np.testing.assert_array_equal(back[k], v.astype(back[k].dtype), err_msg=k)


def _scaled(H):
    """S H S with S = diag(H)^-1/2: H's entries span ~16 orders of
    magnitude (gauge priors at 1e12), so it is compared on the scale the
    solver sees."""
    d = np.sqrt(np.maximum(np.abs(np.diag(H)), 1e-20))
    return H / d[:, None] / d[None, :], d


def test_gn_system_matches(demo):
    Hj, gj, ej = jgn.gn_system(demo["st"], *demo["pairs"], demo["K"], demo["dims_j"],
                               jgn.SigmaStatic(**SIGMAS))
    Ht, gt, et = tgn.gn_system(demo["st_t"], *demo["pairs_t"], demo["K_t"], demo["dims_t"],
                               tgn.SigmaStatic(**SIGMAS))
    Hj, gj = np.asarray(Hj), np.asarray(gj)
    Hs_j, d = _scaled(Hj)
    Hs_t = Ht.numpy() / d[:, None] / d[None, :]
    # entries of the Jacobi-scaled system agree to 1e-4 (f32 sums of ~1e4
    # photometric terms in another order)
    np.testing.assert_allclose(Hs_t, Hs_j, atol=1e-4)
    np.testing.assert_allclose(gt.numpy() / d, gj / d, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-4)


def test_gn_step_matches(demo):
    """One full step (scaffold .. Cholesky .. retract).  The demo window's
    Jacobi-scaled system has condition ~2e6, so two f32 solves agree only
    to ~cond * eps ~ 1e-1 of the step in its weakest directions: poses
    within 1e-4, landmarks (a 0.44 m step here) within 1e-2 m, observed
    2e-5 and 4.5e-3."""
    sj, statj = jgn.gn_step(demo["st"], *demo["pairs"], demo["K"], demo["dims_j"],
                            jgn.SigmaStatic(**SIGMAS))
    st, statt = tgn._gn_step_impl(demo["st_t"], *demo["pairs_t"], demo["K_t"],
                                  demo["dims_t"], tgn.SigmaStatic(**SIGMAS))
    np.testing.assert_allclose(st.kf_pose.numpy(), np.asarray(sj.kf_pose), atol=1e-4)
    np.testing.assert_allclose(st.ow_pose.numpy(), np.asarray(sj.ow_pose), atol=1e-4)
    np.testing.assert_allclose(st.kf_aff.numpy(), np.asarray(sj.kf_aff), atol=1e-4)
    np.testing.assert_allclose(st.P_lm.numpy(), np.asarray(sj.P_lm), atol=1e-2)
    np.testing.assert_allclose(st.median_depth.numpy(), np.asarray(sj.median_depth),
                               atol=1e-2)
    np.testing.assert_allclose(st.logzm.numpy(), np.asarray(sj.logzm), atol=1e-5)
    for a, b in zip(statt, statj):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-2, atol=1e-6)
    # the input state is left untouched; unchanged fields are shared
    assert st.Knm_full is demo["st_t"].Knm_full


def test_gn_step_deterministic(demo):
    """Two steps on the same state are bitwise equal (pair blocks are
    accumulated by one-hot matmuls, not atomic scatters)."""
    a, sa = tgn._gn_step_impl(demo["st_t"], *demo["pairs_t"], demo["K_t"], demo["dims_t"],
                              tgn.SigmaStatic(**SIGMAS))
    b, sb = tgn._gn_step_impl(demo["st_t"], *demo["pairs_t"], demo["K_t"], demo["dims_t"],
                              tgn.SigmaStatic(**SIGMAS))
    for f in a.fields():
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))


def test_cholesky_failure_zeroes_step(demo):
    """An indefinite system (NaN factor) yields a zero step, as in JAX."""
    st = demo["st_t"].replace(Kmm_inv=-1e30 * torch.ones_like(demo["st_t"].Kmm_inv))
    out, stats = tgn._gn_step_impl(st, *demo["pairs_t"], demo["K_t"], demo["dims_t"],
                                   tgn.SigmaStatic(**SIGMAS))
    assert float(stats.delta_norm) == 0.0
    assert torch.equal(out.kf_pose, st.kf_pose)
