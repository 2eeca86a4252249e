"""Port parity: the small public helpers of como_tpu that the port's own
paths do not call (ops/linalg, ops/coords, ops/interp, odom/backend/robust,
geometry/lie, gp/kernels, gp/sampler, gp/predictor) against their
como_tpu counterparts on the same numpy inputs made from a seed (CPU).

Tolerances, each stated where it is used:
- exact (array_equal) where both sides do the same integer or selection
  work, or the same few f32 operations in the same order;
- 1e-5 abs and rel for elementwise f32 formulas (a few ulp of libm and
  operation-order differences, far below any algorithmic one);
- 1e-4 abs and rel for Cholesky solves and inverses (LAPACK and XLA take
  the factorization in other orders; condition numbers here are < 1e3).
The checks of the JAX package's own tests of these functions
(tests/test_linalg.py, test_interp.py, test_utils.py, test_net.py,
test_sampler.py, test_gp_kernels.py) are repeated on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from como_tpu.geometry import lie as jlie
from como_tpu.gp import kernels as jkernels
from como_tpu.gp import predictor as jpred
from como_tpu.gp import sampler as jsampler
from como_tpu.odom.backend import robust as jrobust
from como_tpu.ops import coords as jcoords
from como_tpu.ops import interp as jinterp
from como_tpu.ops import linalg as jlinalg
from como_tpu_torch.geometry import lie as tlie
from como_tpu_torch.gp import kernels as tkernels
from como_tpu_torch.gp import predictor as tpred
from como_tpu_torch.gp import sampler as tsampler
from como_tpu_torch.odom.backend import robust as trobust
from como_tpu_torch.ops import coords as tcoords
from como_tpu_torch.ops import interp as tinterp
from como_tpu_torch.ops import linalg as tlinalg
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

TOL = dict(rtol=1e-5, atol=1e-5)
SOLVE_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _spd(rng, shape, n, ridge):
    A = rng.normal(size=(*shape, n, n)).astype(np.float32)
    return A @ A.swapaxes(-1, -2) + ridge * np.eye(n, dtype=np.float32)


# --- ops/linalg ------------------------------------------------------------------------------

@pytest.mark.parametrize("n_valid", [1, 2, 7, 100, 101])
def test_masked_mad_sigma(n_valid):
    """Exact: the same lower-middle element of the same sorted values,
    times the same constant; and it is 1.4826 * torch.median(|r[mask]|)."""
    rng = np.random.default_rng(n_valid)
    r = rng.normal(size=(8, 16)).astype(np.float32)
    mask = np.zeros(128, bool)
    mask[rng.choice(128, n_valid, replace=False)] = True
    mask = mask.reshape(8, 16)
    got = tlinalg.masked_mad_sigma(_t(r), _t(mask))
    assert float(got) == float(jlinalg.masked_mad_sigma(jnp.array(r), jnp.array(mask)))
    assert float(got) == float(1.4826 * torch.median(torch.from_numpy(np.abs(r[mask]))))


@pytest.mark.parametrize("damping", [0.0, 1e-2])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_solve_chol(damping, batch):
    rng = np.random.default_rng(1)
    H = _spd(rng, batch, 10, 10.0)
    g = rng.normal(size=(*batch, 10)).astype(np.float32)
    x = tlinalg.solve_chol(_t(H), _t(g), damping)
    _close(x, jlinalg.solve_chol(jnp.array(H), jnp.array(g), damping), **SOLVE_TOL)
    Hd = H + damping * np.eye(10, dtype=np.float32)
    np.testing.assert_allclose(np.einsum("...ij,...j->...i", Hd, x.numpy()), g,
                               rtol=1e-3, atol=1e-3)       # test_linalg.py's check


def test_solve_chol_failure_is_nan():
    """An indefinite H gives NaNs, as jnp.linalg.cholesky does."""
    H = np.diag([1.0, -1.0, 2.0]).astype(np.float32)
    g = np.ones(3, np.float32)
    assert torch.isnan(tlinalg.solve_chol(_t(H), _t(g))).all()
    assert np.isnan(np.array(jlinalg.solve_chol(jnp.array(H), jnp.array(g)))).all()


def test_lstsq_chol():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(1, 50, 8)).astype(np.float32)
    x_true = rng.normal(size=(1, 8, 1)).astype(np.float32)
    b = A @ x_true + 1e-3 * rng.normal(size=(1, 50, 1)).astype(np.float32)
    x = tlinalg.lstsq_chol(_t(A), _t(b))
    _close(x, jlinalg.lstsq_chol(jnp.array(A), jnp.array(b)), **SOLVE_TOL)
    np.testing.assert_allclose(x.numpy(), x_true, rtol=1e-2, atol=1e-2)


def test_det2x2_inv2x2():
    rng = np.random.default_rng(4)
    M = _spd(rng, (5,), 2, 2.0)
    inv, dets = tlinalg.inv2x2(_t(M))
    jinv, jdets = jlinalg.inv2x2(jnp.array(M))
    _close(inv, jinv)
    _close(dets, jdets)
    _close(tlinalg.det2x2(_t(M)), jlinalg.det2x2(jnp.array(M)))
    np.testing.assert_allclose(inv.numpy(), np.linalg.inv(M), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dets.numpy(), np.linalg.det(M), rtol=1e-4)


# --- ops/coords, ops/interp -------------------------------------------------------------------

def test_swap_xy():
    """Exact: a permutation of the last axis, at any leading shape."""
    c = np.random.default_rng(5).normal(size=(4, 3, 2)).astype(np.float32)
    np.testing.assert_array_equal(tcoords.swap_xy(_t(c)).numpy(),
                                  np.array(jcoords.swap_xy(jnp.array(c))))
    np.testing.assert_array_equal(tcoords.swap_xy(tcoords.swap_xy(_t(c))).numpy(), c)


@pytest.mark.parametrize("hw", [(3, 5), (48, 64)])
def test_coord_img_rc(hw):
    """Exact: integer-valued floats; pixel (r, c) holds (r, c)."""
    got = tcoords.coord_img_rc(hw, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.array(jcoords.coord_img_rc(hw)))
    assert got.shape == (*hw, 2) and got.dtype == torch.float32
    assert tuple(got[2, 4].tolist()) == (2.0, 4.0)


def test_img_interp_valid_mask():
    """test_interp.py's case: the strict interior 1 <= x < W-1, 1 <= y < H-1."""
    xy = np.array([[0.5, 5.0], [1.0, 1.0], [10.9, 5.0], [11.2, 5.0], [5.0, 8.9], [5.0, 9.1]],
                  np.float32)
    _, valid = tinterp.img_interp(torch.ones((1, 10, 12)), _t(xy))
    np.testing.assert_array_equal(valid.numpy(), [False, True, True, False, True, False])


def test_img_interp_and_batched():
    """Values within 1e-5 of como_tpu's (the same four taps, summed in the
    same order); validity masks equal; the batched forms equal a loop over
    the unbatched ones bit for bit."""
    rng = np.random.default_rng(6)
    imgs = rng.normal(size=(3, 2, 10, 12)).astype(np.float32)
    xy = rng.uniform(-1.5, 13.0, size=(3, 40, 2)).astype(np.float32)
    vals, valid = tinterp.batched_img_interp(_t(imgs), _t(xy))
    jvals, jvalid = jinterp.batched_img_interp(jnp.array(imgs), jnp.array(xy))
    _close(vals, jvals)
    np.testing.assert_array_equal(valid.numpy(), np.array(jvalid))
    for b in range(3):
        v, m = tinterp.img_interp(_t(imgs[b]), _t(xy[b]))
        assert torch.equal(v, vals[b]) and torch.equal(m, valid[b])
    for padding in ("zeros", "border"):
        got = tinterp.batched_bilinear_sample(_t(imgs), _t(xy), padding)
        _close(got, jinterp.batched_bilinear_sample(jnp.array(imgs), jnp.array(xy), padding))


@pytest.mark.parametrize("out", [(5, 6), (20, 24)])
def test_resize_bilinear_takes_align_corners(out):
    """align_corners is accepted and not read, in both packages: either
    value gives the same image, within 1e-5 of como_tpu's."""
    img = np.random.default_rng(7).normal(size=(3, 10, 12)).astype(np.float32)
    a = tinterp.resize_bilinear(_t(img), out, align_corners=True)
    assert torch.equal(a, tinterp.resize_bilinear(_t(img), out))
    _close(a, jinterp.resize_bilinear(jnp.array(img), out, align_corners=True))


# --- odom/backend/robust -----------------------------------------------------------------------

def test_robust_weights():
    """test_net.py's checks, and 1e-5 of como_tpu on a spread of residuals."""
    r = torch.tensor([0.0, 1.0, 2.0, 10.0])
    assert torch.equal(trobust.squared(r), torch.ones(4))
    wt = trobust.tukey(r)
    assert wt[0] == 1.0 and wt[3] == 0.0 and 0 < wt[2] < 1
    assert trobust.TUKEY_T == jrobust.TUKEY_T
    x = np.random.default_rng(8).normal(scale=4.0, size=200).astype(np.float32)
    for name in ("squared", "huber", "tukey"):
        _close(getattr(trobust, name)(_t(x)), getattr(jrobust, name)(jnp.array(x)))
    _close(trobust.tukey(_t(x), 2.0), jrobust.tukey(jnp.array(x), 2.0))


# --- geometry/lie ------------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-5, 0.3, 2.0])
def test_so3_exp(scale):
    """Within 1e-5 of como_tpu at small (Taylor branch) and large angles;
    the rotation block of se3_exp; orthonormal with det +1."""
    w = (np.random.default_rng(9).normal(size=(6, 3)) * scale).astype(np.float32)
    R = tlie.so3_exp(_t(w))
    _close(R, jlie.so3_exp(jnp.array(w)))
    xi = torch.cat([_t(w), torch.zeros(6, 3)], -1)
    torch.testing.assert_close(R, tlie.se3_exp(xi)[..., :3, :3], rtol=0, atol=1e-6)
    torch.testing.assert_close(R @ R.transpose(-1, -2), torch.eye(3).expand(6, 3, 3),
                               rtol=0, atol=1e-5)


def test_invert_se3_jac():
    xi = np.random.default_rng(10).normal(scale=0.5, size=(4, 6)).astype(np.float32)
    T = tlie.se3_exp(_t(xi))
    inv, J = tlie.invert_se3_jac(T)
    jinv, jJ = jlie.invert_se3_jac(jlie.se3_exp(jnp.array(xi)))
    _close(inv, jinv)
    _close(J, jJ)
    torch.testing.assert_close(inv @ T, torch.eye(4).expand(4, 4, 4), rtol=0, atol=1e-5)
    assert torch.equal(J, -tlie.adjoint(T))


# --- gp/kernels, gp/sampler, gp/predictor -------------------------------------------------------

def test_pack_unpack_cov():
    """Exact: pure re-arrangement; unpack(pack(E)) = E for symmetric E."""
    rng = np.random.default_rng(11)
    E = _spd(rng, (7,), 2, 0.1)
    e = tkernels.pack_cov(_t(E))
    np.testing.assert_array_equal(e.numpy(), np.array(jkernels.pack_cov(jnp.array(E))))
    np.testing.assert_array_equal(tkernels.unpack_cov(e).numpy(),
                                  np.array(jkernels.unpack_cov(jnp.array(e.numpy()))))
    np.testing.assert_array_equal(tkernels.unpack_cov(e).numpy(), E)


@pytest.mark.parametrize("n_extras", [0, 2])
def test_pack_prefix(n_extras):
    """Exact: the same stable permutation (test_sampler.py's case first)."""
    coords = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    pc, pm = tsampler.pack_prefix(coords, torch.tensor([False, True, False, True, False]))
    assert pm.tolist() == [True, True, False, False, False]
    assert pc[:2].tolist() == [[2, 3], [6, 7]]
    rng = np.random.default_rng(12 + n_extras)
    c = rng.normal(size=(30, 2)).astype(np.float32)
    m = rng.random(30) < 0.4
    extras = [rng.normal(size=(30, 3)).astype(np.float32) for _ in range(n_extras)]
    got = tsampler.pack_prefix(_t(c), _t(m), *map(_t, extras))
    want = jsampler.pack_prefix(jnp.array(c), jnp.array(m), *map(jnp.array, extras))
    assert len(got) == len(want) == 2 + n_extras
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.array(b))


@pytest.mark.parametrize("given_e_n", [False, True])
def test_predictor_from_cov_img(given_e_n):
    """K blocks and e_m within 1e-5 of como_tpu (the kernel's twin on the
    CPU on both sides); the predictor within 1e-4 (a 16 x 16 Cholesky
    inverse, condition < 1e3 with the jitter)."""
    rng = np.random.default_rng(13 + given_e_n)
    H, W = 12, 16
    cov = np.stack([rng.uniform(0.02, 0.05, (H, W)), rng.uniform(0.02, 0.05, (H, W)),
                    rng.uniform(-0.005, 0.005, (H, W))]).astype(np.float32)
    x_m = rng.uniform(-0.9, 0.9, (16, 2)).astype(np.float32)
    x_n = rng.uniform(-1.0, 1.0, (40, 2)).astype(np.float32)
    e_n = (np.abs(rng.normal(size=(40, 3))) * [0.03, 0.03, 0.0]).astype(np.float32) + [0.01,
                                                                                     0.01, 0.0]
    e_n = e_n.astype(np.float32) if given_e_n else None
    pred, Ks, e_m = tpred.predictor_from_cov_img(_t(cov), _t(x_m), _t(x_n),
                                                 None if e_n is None else _t(e_n), 0.8)
    jp, jKs, je_m = jpred.predictor_from_cov_img(jnp.array(cov), jnp.array(x_m),
                                                 jnp.array(x_n),
                                                 None if e_n is None else jnp.array(e_n), 0.8)
    _close(e_m, je_m)
    for a, b in zip(Ks, jKs):
        _close(a, b)
    for f in ("Kmm_inv", "L_mm", "Knm_Kmminv"):
        _close(getattr(pred, f), getattr(jp, f), **SOLVE_TOL)
