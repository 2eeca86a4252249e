"""Port parity: the GP stack (gp/) of como_tpu_torch against como_tpu (CPU).

On the CPU the port's kernel wrappers run their plain PyTorch twins; these
tests hold the twins against the JAX package, including its Pallas kernels
run in interpret mode (the pattern of tests/test_pallas.py and
tests/test_sampler.py)."""

import jax
import jax.experimental.pallas.tpu as pltpu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from como_tpu.gp import distill as jdistill
from como_tpu.gp import kernels as jkernels
from como_tpu.gp import kernels_pallas as jkp
from como_tpu.gp import predictor as jpred
from como_tpu.gp import sampler as jsampler
from como_tpu.gp import sampler_pallas as jsp
from como_tpu_torch.gp import distill as tdistill
from como_tpu_torch.gp import kernels as tkernels
from como_tpu_torch.gp import kernels_cuda, sampler_cuda
from como_tpu_torch.gp import predictor as tpred
from como_tpu_torch.gp import sampler as tsampler


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _sites(rng, n, cross=0.05):
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    e = (np.abs(rng.normal(size=(n, 3))) * 0.3 + 0.1).astype(np.float32)
    e[:, 2] = cross
    return x, e


@pytest.fixture(scope="module")
def cc_inputs():
    rng = np.random.default_rng(0)
    x_n, e_n = _sites(rng, 700)
    x_m, e_m = _sites(rng, 20, cross=0.0)
    return x_n, e_n, x_m, e_m


def test_cross_covariance_plain_vs_xla(cc_inputs):
    """rtol 1e-4 / atol 1e-5: the JAX package's own Pallas-vs-XLA bound
    (tests/test_pallas.py:32); f32 libm differences are far smaller."""
    want = np.asarray(jkernels.cross_covariance(*map(jnp.asarray, cc_inputs), 1.3))
    got = kernels_cuda.cross_covariance_plain(*map(_t, cc_inputs), 1.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the dispatching wrapper takes the plain twin for CPU tensors
    assert kernels_cuda.cross_covariance.launches == 0
    np.testing.assert_array_equal(tkernels.cross_covariance(*map(_t, cc_inputs), 1.3).numpy(),
                                  got.numpy())
    assert kernels_cuda.cross_covariance.launches == 0


def test_cross_covariance_plain_vs_pallas_interpret(cc_inputs):
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jkp.cross_covariance_pallas(*map(jnp.asarray, cc_inputs), 1.3))
    got = kernels_cuda.cross_covariance_plain(*map(_t, cc_inputs), 1.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_diag_and_interpolate(cc_inputs):
    rng = np.random.default_rng(1)
    e = cc_inputs[1]
    np.testing.assert_allclose(tkernels.diag_covariance(_t(e), 1.3).numpy(),
                               np.asarray(jkernels.diag_covariance(jnp.asarray(e), 1.3)),
                               rtol=1e-5, atol=1e-6)
    img = rng.uniform(0.1, 1.0, (3, 12, 16)).astype(np.float32)
    c = rng.uniform(-1.2, 1.2, (50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tkernels.interpolate_cov_params(_t(img), _t(c)).numpy(),
        np.asarray(jkernels.interpolate_cov_params(jnp.asarray(img), jnp.asarray(c))),
        rtol=1e-5, atol=1e-6)


def test_predictor_and_distill(cc_inputs):
    """Predictor rows and distilled depths: rtol 1e-3 / atol 1e-4 — both
    pass through an f32 Cholesky of K_mm (condition ~1e4 here), which
    amplifies ulp-level kernel differences by that much."""
    x_n, e_n, x_m, e_m = cc_inputs
    Kj = jpred.kernel_matrices(*map(jnp.asarray, (x_m, e_m, x_n, e_n)), 1.0)
    Kt = tpred.kernel_matrices(*map(_t, (x_m, e_m, x_n, e_n)), 1.0)
    for a, b in zip(Kt, Kj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    pj = jpred.build_predictor(Kj[0], Kj[1])
    pt = tpred.build_predictor(Kt[0], Kt[1])
    np.testing.assert_allclose(pt.L_mm.numpy(), np.asarray(pj.L_mm), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pt.Knm_Kmminv.numpy(), np.asarray(pj.Knm_Kmminv),
                               rtol=1e-3, atol=1e-4)
    sj = jpred.predictive_stdev_inv(Kj[1], pj.Knm_Kmminv, Kj[2])
    st = tpred.predictive_stdev_inv(Kt[1], pt.Knm_Kmminv, Kt[2])
    # posterior variance = K_nn - sum(K_nm * W) cancels O(1) terms down to
    # ~1e-3, so its relative error is ~1e3x that of the inputs
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=5e-3)

    rng = np.random.default_rng(2)
    logz = rng.normal(0.5, 0.1, x_n.shape[0]).astype(np.float32)
    mask = rng.uniform(size=x_n.shape[0]) > 0.2
    W = np.asarray(pj.Knm_Kmminv)
    for with_prior in (False, True):
        lj, rj = jdistill.distill_depth(jnp.asarray(W), jnp.asarray(logz), jnp.asarray(mask),
                                        with_prior, L_mm=pj.L_mm,
                                        stdev_inv_obs=jnp.asarray(np.asarray(sj)))
        lt, rt = tdistill.distill_depth(_t(W), _t(logz), torch.from_numpy(mask), with_prior,
                                        L_mm=_t(pj.L_mm), stdev_inv_obs=_t(sj))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-3)
    m1 = np.arange(20) < 8
    logz1 = np.where(m1, 0.4, 0.0).astype(np.float32)
    cj = jdistill.distill_conditional_depth(jnp.asarray(W), jnp.asarray(logz),
                                            jnp.asarray(mask), jnp.asarray(logz1),
                                            jnp.asarray(m1), jnp.full((700,), 3.0))
    ct = tdistill.distill_conditional_depth(_t(W), _t(logz), torch.from_numpy(mask), _t(logz1),
                                            torch.from_numpy(m1), torch.full((700,), 3.0))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-3, atol=1e-3)


def _sampler_case():
    """The fused-vs-XLA case of tests/test_sampler.py (D = 4096, S = 8)."""
    rng = np.random.default_rng(5)
    D, S = 4096, 8
    dom = rng.uniform(-1, 1, (D, 2)).astype(np.float32)
    e00 = rng.uniform(0.5, 2.0, D)
    e11 = rng.uniform(0.5, 2.0, D)
    e01 = rng.uniform(-0.3, 0.3, D) * np.sqrt(e00 * e11)
    e = np.stack([e00, e11, e01], -1).astype(np.float32)
    valid = rng.uniform(size=D) > 0.1
    return dom, e, valid, S


def _port_sample(dom, e, valid, S, **kw):
    z = torch.zeros
    return tsampler.greedy_entropy_sample(
        _t(dom), _t(e), torch.from_numpy(valid), z((S, 2)), z((S, 3)),
        z((S,), dtype=torch.bool), z((S,)), signal_var=1.0, **kw)


def test_greedy_sampler_matches_jax_xla_and_fused(monkeypatch):
    dom, e, valid, S = _sampler_case()
    kw = dict(fixed_var=0.0, max_stdev_thresh=1e-3, dist_thresh=5e-2, num_slots=S,
              terminate_early=False)
    zeros = (jnp.zeros((S, 2), jnp.float32), jnp.zeros((S, 3), jnp.float32),
             jnp.zeros((S,), bool), jnp.zeros((S,), jnp.float32))

    def run():
        return jsampler.greedy_entropy_sample(jnp.asarray(dom), jnp.asarray(e),
                                              jnp.asarray(valid), *zeros,
                                              signal_var=1.0, **kw)

    res_xla = run()
    monkeypatch.setattr(jsp, "pallas_available", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        res_fused = jax.jit(run)()
    res_t = _port_sample(dom, e, valid, S, **kw)
    np.testing.assert_array_equal(res_t.domain_inds.numpy(), np.asarray(res_xla.domain_inds))
    np.testing.assert_array_equal(res_t.domain_inds.numpy(), np.asarray(res_fused.domain_inds))
    np.testing.assert_allclose(res_t.coords_norm.numpy(), np.asarray(res_xla.coords_norm),
                               atol=1e-6)
    np.testing.assert_array_equal(res_t.valid.numpy(), np.asarray(res_xla.valid))


def test_greedy_sampler_existing_anchors_and_early_stop():
    """Pre-existing anchors as a packed prefix + terminate_early, against
    the JAX XLA path (the shape of corr.py's second sampler call)."""
    dom, e, valid, _ = _sampler_case()
    S = 12
    curr = np.zeros((S, 2), np.float32)
    curr_e = np.full((S, 3), 0.8, np.float32)
    curr_e[:, 2] = 0.0
    curr[:4] = dom[[10, 500, 900, 2000]]
    cv = np.arange(S) < 4
    kw = dict(fixed_var=0.0, max_stdev_thresh=0.3, dist_thresh=5e-2, num_slots=S,
              terminate_early=True)
    rj = jsampler.greedy_entropy_sample(
        jnp.asarray(dom), jnp.asarray(e), jnp.asarray(valid), jnp.asarray(curr),
        jnp.asarray(curr_e), jnp.asarray(cv), jnp.zeros((S,)), signal_var=1.0, **kw)
    rt = tsampler.greedy_entropy_sample(
        _t(dom), _t(e), torch.from_numpy(valid), _t(curr), _t(curr_e), torch.from_numpy(cv),
        torch.zeros((S,)), signal_var=1.0, **kw)
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_downdate_plain_matches_jax_kernel_interpret():
    """One downdate step: the port's plain twin against the TPU kernel
    (interpret mode) on identical inputs; in place on obs_info[row]."""
    rng = np.random.default_rng(3)
    S, D = 8, 4096
    xnT = rng.uniform(-1, 1, (2, D)).astype(np.float32)
    enT = np.abs(rng.normal(size=(3, D))).astype(np.float32) * 0.3 + 0.2
    enT[2] = 0.02
    obs = (rng.normal(size=(S, D)) * 0.1).astype(np.float32)
    obs[5:] = 0.0
    var = rng.uniform(0.5, 1.0, D).astype(np.float32)
    md = rng.uniform(0.0, 1.0, D).astype(np.float32)
    l_ni = (rng.normal(size=S) * 0.2).astype(np.float32)
    l_ni[5:] = 0.0
    x_i, e_i, l_ii = xnT[:, 7], enT[:, 7], np.float32(0.6)
    with pltpu.force_tpu_interpret_mode():
        on, vn, mn = jsp.downdate_step(jnp.asarray(xnT), jnp.asarray(enT), jnp.asarray(obs),
                                       jnp.asarray(var), jnp.asarray(md), jnp.asarray(x_i),
                                       jnp.asarray(e_i), jnp.asarray(l_ni), jnp.asarray(l_ii),
                                       jnp.asarray(True), 1.0)
    o, v, m = _t(obs), _t(var), _t(md)
    sc = torch.cat([_t(x_i), _t(e_i), torch.tensor([1.0 / 0.6, 1.0, 1.0])])
    sampler_cuda.downdate_step(_t(xnT), _t(enT), o, v, m, sc, _t(l_ni), 5)
    assert sampler_cuda.downdate_step.launches == 0
    np.testing.assert_allclose(o[5].numpy(), np.asarray(on), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(vn), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(mn), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(o[:5].numpy(), obs[:5])


def test_wrappers_refuse_other_devices():
    """No quiet fallback: a tensor on a device other than CPU/CUDA raises."""
    x = torch.zeros((4, 2), device="meta")
    e = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        kernels_cuda.cross_covariance(x, e, x, e, 1.0)
