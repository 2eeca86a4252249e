"""The hand-written CUDA kernels of como_tpu_torch against their plain
PyTorch versions on the card (marker `cuda`; they skip without a GPU).

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py   # on the GPU machine

(`--noconftest` skips tests/conftest.py's JAX set-up, which these tests do
not need.)

Tolerance 1e-5 abs / 1e-4 rel, the JAX package's Pallas-vs-XLA bound:
the kernels use plain sqrtf/expf/division (no fast math) and differ from
the plain version only in operation order and FMA contraction."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _sites(g, n, dev):
    x = torch.rand((n, 2), generator=g) * 2 - 1
    e = torch.rand((n, 3), generator=g) * 0.3 + 0.1
    e[:, 2] = (torch.rand(n, generator=g) - 0.5) * 0.1
    return x.to(dev), e.to(dev)


@pytest.mark.parametrize("N,M", [(49152, 64), (700, 20), (1, 64), (64, 64), (37, 33)])
def test_cross_covariance_kernel(cuda, N, M):
    from como_tpu_torch.gp import kernels_cuda

    g = torch.Generator().manual_seed(N + M)
    x_n, e_n = _sites(g, N, cuda)
    x_m, e_m = _sites(g, M, cuda)
    n0 = kernels_cuda.cross_covariance.launches
    got = kernels_cuda.cross_covariance(x_n, e_n, x_m, e_m, 1.3)
    torch.cuda.synchronize()
    assert kernels_cuda.cross_covariance.launches == n0 + 1
    want = kernels_cuda.cross_covariance_plain(x_n, e_n, x_m, e_m, 1.3)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_sampler_kernel_vs_plain(cuda):
    """A 64-step sampler call over a 192x256 domain: identical selections,
    obs_info / var within tolerance."""
    from como_tpu_torch.gp import sampler, sampler_cuda

    g = torch.Generator().manual_seed(0)
    D, S = 192 * 256, 64
    dom, e = _sites(g, D, cuda)
    valid = torch.ones(D, dtype=torch.bool, device=cuda)
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=cuda)  # noqa: E731
    args = (dom, e, valid, z(S, 2), z(S, 3), z(S, dt=torch.bool), z(S), 1.0, 0.0,
            1e-2, 0.1, S, False)
    rk, ok, vk, mk = sampler.greedy_entropy_loop(*args)
    rp, op, vp, mp = sampler.greedy_entropy_loop(*args,
                                                 downdate=sampler_cuda.downdate_step_plain)
    assert torch.equal(rk.domain_inds, rp.domain_inds)
    torch.testing.assert_close(ok, op, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(vk, vp, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mk, mp)


def test_kernel_wrappers_reject_bad_inputs(cuda):
    from como_tpu_torch.gp import kernels_cuda

    x = torch.zeros((4, 2), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):
        kernels_cuda.cross_covariance(x, x, x, x, 1.0)
    with pytest.raises(TypeError):
        xf = x.float()
        kernels_cuda.cross_covariance(xf, torch.zeros((4, 3), device=cuda), xf,
                                      torch.zeros((4, 3), device=cuda),
                                      torch.tensor(1.0, device=cuda))


def test_gn_step_bitwise_repeatable(cuda):
    from como_tpu_torch.odom import window as win
    from como_tpu_torch.odom.backend import gn_step

    dims = win.make_dims(num_kf=4, num_ow=3, M=16, img_size=(48, 64))
    st = win.empty_state(dims, device=cuda)
    g = torch.Generator().manual_seed(0)
    st.kf_valid[:3] = True
    st.lm_valid[:48] = True
    st.P_lm.copy_((torch.rand((dims.L, 3), generator=g) + torch.tensor([0, 0, 1.5])).to(cuda))
    st.anchor_lm[:3] = torch.arange(48, device=cuda).reshape(3, 16)
    st.kf_img.copy_(torch.rand(st.kf_img.shape, generator=g).to(cuda))
    st.dense_knm.copy_(torch.rand(st.dense_knm.shape, generator=g).to(cuda) / 16)
    K = torch.tensor([[57.6, 0, 31.5], [0, 57.6, 23.5], [0, 0, 1]], device=cuda)
    ref = torch.tensor(np.r_[[0, 1, 1, 2], np.zeros(10)], dtype=torch.int64, device=cuda)
    tgt = torch.tensor(np.r_[[1, 0, 2, 1], np.zeros(10)], dtype=torch.int64, device=cuda)
    val = torch.arange(14, device=cuda) < 4
    a, sa = gn_step._gn_step_impl(st, ref, tgt, val, K, dims, gn_step.SigmaStatic())
    b, sb = gn_step._gn_step_impl(st, ref, tgt, val, K, dims, gn_step.SigmaStatic())
    for f in a.fields():
        assert torch.equal(getattr(a, f), getattr(b, f)), f
