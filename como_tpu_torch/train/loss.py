"""The DepthCov training objective (port of make_loss,
scripts/train_depthcov.py:161-206).

For random sparse anchor sets the GP conditional mean of dense log-depth,
through the per-pixel kernels the UNet predicts, must regress the true
log-depth: mse of the extrapolation at random test sites, plus
`nll_weight` times the Gaussian negative log-likelihood that calibrates the
posterior variance.  The random sites are explicit inputs; `draw_sites`
draws them from an explicit torch.Generator (JAX draws them from a key
inside the loss, so the tests hand both the same numbers).

The GP blocks go through gp/predictor.kernel_matrices, whose
cross-covariances are the hand-written kernel and its backward kernel on
CUDA (gp/kernels_cuda.py), autograd of the plain version on the CPU.
"""

from __future__ import annotations

import torch

from como_tpu_torch.gp import kernels, predictor
from como_tpu_torch.ops.coords import normalize_coords
from como_tpu_torch.ops.interp import bilinear_sample

M_ANCHORS = 64
N_TEST = 1024
NLL_WEIGHT = 0.1


def draw_sites(generator: torch.Generator, M: int, n_test: int, size_hw):
    """(rc_m (M, 2), rc_n (n_test, 2)) uniform (row, col) sites in the
    network's (ch, cw) grid, on the generator's device."""
    ch, cw = size_hw
    dev = generator.device
    span = torch.tensor([ch - 1, cw - 1], dtype=torch.float32, device=dev)
    rc_m = torch.rand((M, 2), generator=generator, device=dev) * span
    rc_n = torch.rand((n_test, 2), generator=generator, device=dev) * span
    return rc_m, rc_n


def gp_loss(cov: torch.Tensor, depth: torch.Tensor, rc_m: torch.Tensor, rc_n: torch.Tensor,
            nll_weight: float = NLL_WEIGHT) -> torch.Tensor:
    """The loss of one image: cov (3, ch, cw) the finest packed covariance
    map, depth (1, 1, H, W) metric depth (<= 1e-3 where invalid), rc_m /
    rc_n sites in the (ch, cw) grid."""
    H, W = depth.shape[-2:]
    ch, cw = cov.shape[-2:]
    f32 = dict(dtype=torch.float32, device=cov.device)
    valid = depth[0, 0] > 1e-3       # RGB-D sensors emit 0 where invalid
    logz = torch.log(torch.where(valid, depth[0, 0], torch.ones((), **f32)))
    dims = [ch, cw]
    m_norm = normalize_coords(rc_m, dims)
    n_norm = normalize_coords(rc_n, dims)
    e_m = kernels.interpolate_cov_params(cov, m_norm)
    e_n = kernels.interpolate_cov_params(cov, n_norm)
    K_mm, K_nm, K_nn = predictor.kernel_matrices(m_norm, e_m, n_norm, e_n, 1.0)
    pred = predictor.build_predictor(K_mm, K_nm, jitter=1e-5)

    # gt log-depth at the sites (bilinear, full-res -> network-res grid)
    scale_rc = torch.tensor([(H - 1) / (ch - 1), (W - 1) / (cw - 1)], **f32)

    def sample_rc(img, rc):
        xy = torch.stack([rc[:, 1] * scale_rc[1], rc[:, 0] * scale_rc[0]], -1)
        return bilinear_sample(img[None], xy, "border")[0]

    lz_m = sample_rc(logz, rc_m)
    lz_n = sample_rc(logz, rc_n)
    vmask_n = sample_rc(valid.float(), rc_n) > 0.999
    vmask_m = sample_rc(valid.float(), rc_m) > 0.999
    # invalid anchors take the mean of the valid ones; invalid test sites
    # carry no weight
    wn = vmask_n.float()
    vm = vmask_m.float()
    lz_m = torch.where(vmask_m, lz_m, torch.sum(lz_m * vm) / torch.clamp(torch.sum(vm), min=1.0))

    pred_n = pred.Knm_Kmminv @ lz_m
    denom = torch.clamp(torch.sum(wn), min=1.0)
    sq = torch.square(pred_n - lz_n)
    mse = torch.sum(wn * sq) / denom
    # variance calibration: the posterior variance should track the error
    var = torch.clamp(K_nn - torch.sum(K_nm * pred.Knm_Kmminv, -1), min=1e-6)
    nll = torch.sum(wn * (sq / var + torch.log(var))) / denom
    return mse + nll_weight * nll


def depthcov_loss(model, rgb: torch.Tensor, depth: torch.Tensor, rc_m: torch.Tensor,
                  rc_n: torch.Tensor, nll_weight: float = NLL_WEIGHT) -> torch.Tensor:
    """make_loss's loss_fn: the UNet on rgb (1, 3, H, W), its finest level,
    then gp_loss."""
    return gp_loss(model(rgb)[-1][0], depth, rc_m, rc_n, nll_weight)
