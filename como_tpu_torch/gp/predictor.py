"""GP depth predictor (port of como_tpu/gp/predictor.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from como_tpu_torch.gp import kernels
from como_tpu_torch.ops import linalg


class GPPredictor(NamedTuple):
    Kmm_inv: torch.Tensor      # (M, M)
    L_mm: torch.Tensor         # (M, M) lower Cholesky of K_mm (+jitter)
    Knm_Kmminv: torch.Tensor   # (N, M)


def kernel_matrices(x_m_norm, e_m, x_n_norm, e_n, scale):
    """K_mm (M, M), K_nm (N, M), K_nn_diag (N,).  Both blocks go through
    the cross-covariance wrapper (the kernel on CUDA at any size)."""
    K_mm = kernels.cross_covariance(x_m_norm, e_m, x_m_norm, e_m, scale)
    K_nm = kernels.cross_covariance(x_n_norm, e_n, x_m_norm, e_m, scale)
    K_nn_diag = kernels.diag_covariance(e_n, scale)
    return K_mm, K_nm, K_nn_diag


def build_predictor(K_mm: torch.Tensor, K_nm: torch.Tensor,
                    jitter: float = 1e-6) -> GPPredictor:
    m = K_mm.shape[-1]
    K_mm = K_mm + jitter * torch.eye(m, dtype=K_mm.dtype, device=K_mm.device)
    L_mm = linalg.cholesky(K_mm)
    Kmm_inv = linalg.cholesky_inverse(L_mm)
    return GPPredictor(Kmm_inv=Kmm_inv, L_mm=L_mm, Knm_Kmminv=K_nm @ Kmm_inv)


def predictive_stdev_inv(K_nm, Knm_Kmminv, K_nn_diag):
    """1/sqrt(var) with the positivity fixup var += min(var) + 1e-8."""
    var = K_nn_diag - torch.sum(K_nm * Knm_Kmminv, -1)
    var = var + torch.min(var) + 1e-8
    return 1.0 / torch.sqrt(var)

