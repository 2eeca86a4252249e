"""Port parity: geometry/ and ops/ of como_tpu_torch against como_tpu on the
same numpy inputs (CPU).

Tolerance 1e-5 (abs and rel) throughout: both sides run f32 with different
libm / summation order, which moves results by a few ulp; 1e-5 is far
above that and far below any algorithmic difference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from como_tpu.geometry import camera as jcam
from como_tpu.geometry import depth as jdepth
from como_tpu.geometry import lie as jlie
from como_tpu.ops import image as jimg
from como_tpu.ops import interp as jinterp
from como_tpu.ops import linalg as jlinalg
from como_tpu.ops import reduce as jreduce
from como_tpu.ops.coords import fill_image as jfill
from como_tpu_torch.geometry import camera as tcam
from como_tpu_torch.geometry import depth as tdepth
from como_tpu_torch.geometry import lie as tlie
from como_tpu_torch.ops import image as timg
from como_tpu_torch.ops import interp as tinterp
from como_tpu_torch.ops import linalg as tlinalg
from como_tpu_torch.ops import reduce as treduce
from como_tpu_torch.ops.coords import fill_image as tfill
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


def test_lie_exp_log_normalize(rng):
    xi = rng.normal(size=(64, 6)).astype(np.float32) * 0.5
    xi[:8, :3] *= 1e-5                         # Taylor branches
    T_j = jlie.se3_exp(jnp.asarray(xi))
    T_t = tlie.se3_exp(_t(xi))
    _close(T_t, T_j)
    _close(tlie.se3_log(T_t), jlie.se3_log(T_j), rtol=1e-4, atol=1e-5)
    _close(tlie.invert_se3(T_t), jlie.invert_se3(T_j))
    _close(tlie.adjoint(T_t), jlie.adjoint(T_j))
    noisy = np.asarray(T_j) + rng.normal(size=(64, 4, 4)).astype(np.float32) * 1e-3
    _close(tlie.normalize_rotation(_t(noisy)), jlie.normalize_rotation(jnp.asarray(noisy)))


def test_pose_tq_roundtrip(rng):
    T = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(size=(16, 6)).astype(np.float32))))
    got, want = tlie.pose_to_tq(T), jlie.pose_to_tq(T)
    _close(got[:, :3], want[:, :3], atol=1e-6)
    # q and -q are one rotation: the port returns w >= 0
    _close(got[:, 3:], want[:, 3:] * np.sign(want[:, 6:7]), atol=1e-6)
    _close(tlie.tq_to_pose(tlie.pose_to_tq(T)), T, atol=1e-6)


def test_project_backproject(rng):
    K = np.array([[60.0, 0, 31.5], [0, 60.0, 23.5], [0, 0, 1]], np.float32)
    P = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    P[:, 2] = rng.uniform(1, 3, 100)
    for a, b in zip(tcam.project(_t(K), _t(P)), jcam.project(jnp.asarray(K), jnp.asarray(P))):
        _close(a, b)
    p = rng.uniform(0, 60, (100, 2)).astype(np.float32)
    z = rng.uniform(1, 3, (100, 1)).astype(np.float32)
    for a, b in zip(tcam.backproject(_t(K), _t(p), _t(z)),
                    jcam.backproject(jnp.asarray(K), jnp.asarray(p), jnp.asarray(z))):
        _close(a, b)



def test_depth_helpers(rng):
    z = rng.uniform(0.5, 5.0, size=(2, 1, 12, 16)).astype(np.float32)
    for tf, jf, a in ((tdepth.log_depth_to_depth, jdepth.log_depth_to_depth, np.log(z)),
                      (tdepth.depth_to_log_depth, jdepth.depth_to_log_depth, z)):
        for got, want in zip(tf(_t(a)), jf(jnp.asarray(a))):
            _close(got, want)
    logz_m = rng.normal(size=(2, 8, 1)).astype(np.float32)
    A = rng.normal(size=(2, 30, 8)).astype(np.float32)
    for got, want in zip(tdepth.predict_log_depth(_t(logz_m), _t(A)),
                         jdepth.predict_log_depth(jnp.asarray(logz_m), jnp.asarray(A))):
        _close(got, want)
    K = np.array([[20.0, 0, 7.5], [0, 20.0, 5.5], [0, 0, 1]], np.float32)
    _close(tdepth.backproject_depth_img(_t(z), _t(K)),
           jdepth.backproject_depth_img(jnp.asarray(z), jnp.asarray(K)))

@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_bilinear_sample(rng, padding):
    img = rng.uniform(size=(3, 12, 17)).astype(np.float32)
    xy = rng.uniform(-2, 19, (200, 2)).astype(np.float32)
    _close(tinterp.bilinear_sample(_t(img), _t(xy), padding),
           jinterp.bilinear_sample(jnp.asarray(img), jnp.asarray(xy), padding))


def test_bilinear_sample_frames(rng):
    imgs = rng.uniform(size=(5, 3, 12, 17)).astype(np.float32)
    j = rng.integers(0, 5, 7)
    xy = rng.uniform(-2, 19, (7, 50, 2)).astype(np.float32)
    _close(tinterp.bilinear_sample_frames(_t(imgs), torch.from_numpy(j), _t(xy)),
           jinterp.bilinear_sample_frames(jnp.asarray(imgs), jnp.asarray(j), jnp.asarray(xy)))


def test_pyramid_and_grads(rng):
    x = rng.uniform(size=(1, 1, 48, 64)).astype(np.float32)
    for a, b in zip(timg.image_pyramid(_t(x), 0, 3), jimg.image_pyramid(jnp.asarray(x), 0, 3)):
        _close(a, b)
    _close(timg.img_and_grads(_t(x)), jimg.img_and_grads(jnp.asarray(x)))
    rgb = rng.uniform(size=(1, 3, 48, 64)).astype(np.float32)
    _close(timg.rgb_to_gray(_t(rgb)), jimg.rgb_to_gray(jnp.asarray(rgb)))


def test_histogram_median_and_mad(rng):
    x = rng.normal(size=5000).astype(np.float32)
    m = rng.uniform(size=5000) > 0.3
    _close(treduce.histogram_median(_t(x), torch.from_numpy(m)),
           jreduce.histogram_median(jnp.asarray(x), jnp.asarray(m)))
    _close(treduce.fast_mad_sigma(_t(x), torch.from_numpy(m)),
           jreduce.fast_mad_sigma(jnp.asarray(x), jnp.asarray(m)))
    rows = rng.uniform(1, 3, (4, 300)).astype(np.float32)
    mr = rng.uniform(size=(4, 300)) > 0.2
    want = [jreduce.histogram_median(jnp.asarray(r), jnp.asarray(k)) for r, k in zip(rows, mr)]
    _close(treduce.histogram_median_rows(_t(rows), torch.from_numpy(mr)), want)


def test_medians(rng):
    x = rng.normal(size=101).astype(np.float32)
    m = rng.uniform(size=101) > 0.5
    _close(tlinalg.masked_median(_t(x), torch.from_numpy(m)),
           jlinalg.masked_median(jnp.asarray(x), jnp.asarray(m)))
    for n in (100, 101):   # jnp.median averages the two middle values
        _close(tlinalg.median(_t(x[:n])), jnp.median(jnp.asarray(x[:n])))


def test_cholesky_inverse_and_failure(rng):
    A = rng.normal(size=(3, 8, 8)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 8 * np.eye(8, dtype=np.float32)
    L = tlinalg.cholesky(_t(A))
    _close(tlinalg.cholesky_inverse(L),
           jlinalg.cholesky_inverse(jnp.linalg.cholesky(jnp.asarray(A))), rtol=1e-4, atol=1e-5)
    # a failed factorization is NaN (as jnp.linalg.cholesky), not an exception
    bad = -torch.eye(4)
    assert torch.isnan(tlinalg.cholesky(bad)).all()
    assert np.isnan(np.asarray(jnp.linalg.cholesky(-jnp.eye(4)))).any()


@pytest.mark.parametrize("shapes", [((48, 64), (192, 256)), ((192, 256), (48, 64)),
                                    ((40, 60), (30, 90))])
def test_resize_bilinear(rng, shapes):
    """jax.image.resize("linear") antialiases when downsampling; the port
    reproduces that (triangle kernel widened by the scale)."""
    src, dst = shapes
    img = rng.uniform(size=(3,) + src).astype(np.float32)
    _close(tinterp.resize_bilinear(_t(img), dst),
           jinterp.resize_bilinear(jnp.asarray(img), dst))


def test_fill_image_semantics(rng):
    """Negative coords wrap once, out-of-range drops, duplicates: last wins."""
    rc = np.array([[-1, -1], [1, 2], [1, 2], [1.2, 2.7], [5, 0], [-9, 0], [0, 3]],
                  np.float32)
    v = np.arange(7, dtype=np.float32) + 1
    _close(tfill(_t(rc), _t(v), (3, 4)), jfill(jnp.asarray(rc), jnp.asarray(v), (3, 4)),
           equal_nan=True)
