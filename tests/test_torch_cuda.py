"""The hand-written CUDA kernels of como_tpu_torch against their plain
PyTorch versions on the card (marker `cuda`; they skip without a GPU).

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py   # on the GPU machine

(`--noconftest` skips tests/conftest.py's JAX set-up, which these tests do
not need.)

Tolerance 1e-5 abs / 1e-4 rel, the JAX package's Pallas-vs-XLA bound.
The downdate kernel uses plain sqrtf/expf/division and differs from its
plain version only in operation order and FMA contraction; the
cross-covariance kernel also splits the fourth root and uses the
rcp/sqrt/ex2 approximations (a few ulp each, ~1e-6 abs on K <= ~1)."""

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


def _offset_view(t):
    """The same values at an address 4 bytes past a 16-byte boundary
    (contiguous, but not aligned for vector loads)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


@pytest.mark.parametrize("N,M,offset", [
    (49152, 64, False), (700, 20, False), (1, 64, False), (64, 64, False), (37, 33, False),
    (49152, 62, False), (5, 4, False), (3, 1, False), (0, 64, False),
    (130, 64, True), (130, 63, True)])
def test_cross_covariance_kernel(cuda, N, M, offset):
    """Full tiles, ragged tiles, rows that are not 16-byte aligned
    (M % 4 != 0), inputs that are not 16-byte aligned, and the empty case."""
    from como_tpu_torch.gp import kernels_cuda

    g = torch.Generator().manual_seed(N + M)
    x_n, e_n = _sites(g, N, cuda)
    x_m, e_m = _sites(g, M, cuda)
    if offset:
        x_n, e_n, x_m, e_m = map(_offset_view, (x_n, e_n, x_m, e_m))
        assert x_n.data_ptr() % 16 == 4 and x_n.is_contiguous()
    n0 = kernels_cuda.cross_covariance.launches
    got = kernels_cuda.cross_covariance(x_n, e_n, x_m, e_m, 1.3)
    torch.cuda.synchronize()
    assert kernels_cuda.cross_covariance.launches == n0 + (1 if N * M else 0)
    assert got.shape == (N, M)
    want = kernels_cuda.cross_covariance_plain(x_n, e_n, x_m, e_m, 1.3)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("N,M", [(49152, 64), (37, 33)])
def test_cross_covariance_kernel_bitwise_repeatable(cuda, N, M):
    from como_tpu_torch.gp import kernels_cuda

    g = torch.Generator().manual_seed(1)
    args = (*_sites(g, N, cuda), *_sites(g, M, cuda), 0.7)
    a = kernels_cuda.cross_covariance(*args)
    b = kernels_cuda.cross_covariance(*args)
    assert torch.equal(a, b)


def test_cross_covariance_singular_and_unselected_anchors(cuda):
    """det(E_n + E_m) = 0 gives NaN as in the plain version; an all-zero
    (unselected) anchor against a proper site gives exactly 0."""
    from como_tpu_torch.gp import kernels_cuda

    z2, z3 = torch.zeros((1, 2), device=cuda), torch.zeros((1, 3), device=cuda)
    assert torch.isnan(kernels_cuda.cross_covariance(z2, z3, z2, z3, 1.0)).all()
    g = torch.Generator().manual_seed(2)
    x_n, e_n = _sites(g, 9, cuda)
    k = kernels_cuda.cross_covariance(x_n, e_n, z2.expand(5, 2), z3.expand(5, 3), 1.0)
    assert torch.equal(k, torch.zeros((9, 5), device=cuda))


def test_launches_by_shape_records_the_shape(cuda):
    from como_tpu_torch.gp import kernels_cuda

    g = torch.Generator().manual_seed(3)
    args = (*_sites(g, 11, cuda), *_sites(g, 6, cuda), 1.0)
    before = kernels_cuda.cross_covariance.launches_by_shape.get((11, 6), 0)
    total = kernels_cuda.cross_covariance.launches
    kernels_cuda.cross_covariance(*args)
    kernels_cuda.cross_covariance(*args)
    assert kernels_cuda.cross_covariance.launches_by_shape[(11, 6)] == before + 2
    assert kernels_cuda.cross_covariance.launches == total + 2
    assert sum(kernels_cuda.cross_covariance.launches_by_shape.values()) \
        == kernels_cuda.cross_covariance.launches


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
