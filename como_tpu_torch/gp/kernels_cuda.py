"""GP cross-covariance: hand-written CUDA kernel + plain PyTorch twin.

Replaces the TPU kernel como_tpu/gp/kernels_pallas.py::_cross_cov_kernel
(cross_covariance_pallas, pallas_call at :95).  Kernel source:
como_tpu_torch/csrc/gp_kernels.cu; its header states what bounds it on the
H100 (the (N, M) f32 output write) and how the design meets that (one
thread per output, anchors staged in shared memory, coalesced row stores).

`cross_covariance` dispatches on the tensors' device: CPU tensors go to
`cross_covariance_plain` (the port of the XLA twin
como_tpu/gp/kernels.py::cross_covariance / _pair_terms); CUDA tensors
launch the kernel, or raise.  There is no fallback between the two.
`cross_covariance.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

SQRT3 = math.sqrt(3.0)
_EPS = 1e-8


def matern32(Q: torch.Tensor) -> torch.Tensor:
    t = SQRT3 * torch.sqrt(Q + _EPS)
    return (1.0 + t) * torch.exp(-t)


def _pair_terms(x1, e1, x2, e2):
    """Q, C of shape (..., N, M) for x1 (..., N, 2), e1 (..., N, 3) vs
    x2 (..., M, 2), e2 (..., M, 3)."""
    d0 = x1[..., :, None, 0] - x2[..., None, :, 0]
    d1 = x1[..., :, None, 1] - x2[..., None, :, 1]
    s00 = e1[..., :, None, 0] + e2[..., None, :, 0]
    s11 = e1[..., :, None, 1] + e2[..., None, :, 1]
    s01 = e1[..., :, None, 2] + e2[..., None, :, 2]
    det_s = s00 * s11 - s01 * s01
    inv_det = 1.0 / det_s
    Q = 0.5 * inv_det * (s11 * d0 * d0 - 2.0 * s01 * d0 * d1 + s00 * d1 * d1)
    det1 = e1[..., 0] * e1[..., 1] - e1[..., 2] * e1[..., 2]
    det2 = e2[..., 0] * e2[..., 1] - e2[..., 2] * e2[..., 2]
    C = (2.0 * torch.pow(det1[..., :, None] * det2[..., None, :], 0.25)
         * torch.sqrt(torch.clamp(inv_det, min=0.0) + _EPS))
    return Q, C


def cross_covariance_plain(x_n, e_n, x_m, e_m, scale) -> torch.Tensor:
    """K (..., N, M) in plain PyTorch (the kernel's reference)."""
    Q, C = _pair_terms(x_n, e_n, x_m, e_m)
    return scale * C * matern32(Q)


def _launch(x_n, e_n, x_m, e_m, scale: float) -> torch.Tensor:
    from como_tpu_torch import cuda_lib

    N, M = x_n.shape[0], x_m.shape[0]
    if (x_n.shape != (N, 2) or e_n.shape != (N, 3) or x_m.shape != (M, 2)
            or e_m.shape != (M, 3)):
        raise ValueError("cross_covariance kernel takes (N,2),(N,3),(M,2),(M,3): "
                         f"got {tuple(x_n.shape)}, {tuple(e_n.shape)}, "
                         f"{tuple(x_m.shape)}, {tuple(e_m.shape)}")
    ts = [t.contiguous() for t in (x_n, e_n, x_m, e_m)]
    for t in ts:
        if t.dtype != torch.float32 or t.device != x_n.device:
            raise ValueError("cross_covariance kernel takes f32 tensors on one device")
    out = torch.empty((N, M), dtype=torch.float32, device=x_n.device)
    fn = cuda_lib.lib("gp_kernels").como_cross_covariance_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*[cuda_lib.ptr(t) for t in ts], ctypes.c_float(scale),
             cuda_lib.ptr(out), N, M, cuda_lib.stream_ptr(x_n.device))
    cuda_lib.check(err, "como_cross_covariance_f32")
    cross_covariance.launches += 1
    return out


def cross_covariance(x_n, e_n, x_m, e_m, scale) -> torch.Tensor:
    """K (N, M) between site sets (packed covs).  CUDA tensors launch the
    hand-written kernel; CPU tensors use the plain twin."""
    if x_n.device.type == "cpu":
        return cross_covariance_plain(x_n, e_n, x_m, e_m, scale)
    if x_n.device.type != "cuda":
        raise ValueError(f"cross_covariance: unsupported device {x_n.device}")
    if isinstance(scale, torch.Tensor):
        raise TypeError("cross_covariance kernel takes scale as a Python float "
                        "(a device scalar would need a host sync)")
    return _launch(x_n, e_n, x_m, e_m, float(scale))


cross_covariance.launches = 0
