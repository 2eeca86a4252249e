"""GP cross-covariance: hand-written CUDA kernel + plain PyTorch twin.

Replaces the TPU kernel como_tpu/gp/kernels_pallas.py::_cross_cov_kernel
(cross_covariance_pallas, pallas_call at :95).  Kernel source:
como_tpu_torch/csrc/gp_kernels.cu; its header states what bounds it on the
H100 (by bytes the (N, M) f32 output write, in practice the issue rate
and the special-function unit) and what the design does about that (a
thread owns 4 anchors and walks several rows with float4 stores; per-site
and per-anchor terms computed once per block; four approximate
special-function operations per output).

`cross_covariance` dispatches on the tensors' device: CPU tensors go to
`cross_covariance_plain` (the port of the XLA twin
como_tpu/gp/kernels.py::cross_covariance / _pair_terms); CUDA tensors
launch the kernel, or raise.  There is no fallback between the two.
Each launch counts in the recorder's counter "kernels.cross_covariance",
keyed by (N, M) (utils/profiling.py).
`cross_covariance_reassociated` repeats the kernel's reordered arithmetic
in plain PyTorch, for the CPU tests only.

The gradient.  On CUDA, when grad mode is on and an input requires grad,
`cross_covariance` goes through `CrossCovariance` (torch.autograd.Function):
its forward is the same kernel launch, its backward the hand-written
kernel `como_cross_covariance_bwd_f32` (same source): one launch that
recomputes the pair terms with IEEE arithmetic and sums the grads over
anchors and over sites in a fixed order (two passes bitwise equal), the
sum over blocks included (through distributed shared memory within a
thread-block cluster, and a ticket counter across clusters, kept here per
stream and zero between launches).  No TPU kernel corresponds: como_tpu
differentiates the XLA twin.  The backward's launches count in
"kernels.cross_covariance_bwd", apart from the forward's.  Without grad
the direct launch stays, so inference launches exactly as before.  On the
CPU, autograd of `cross_covariance_plain` is the gradient and the
backward's plain twin (`cross_covariance_vjp_plain`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from como_tpu_torch.utils.profiling import RECORDER

SQRT3 = math.sqrt(3.0)
_EPS = 1e-8
_LOG2E = 1.4426950408889634


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


def cross_covariance_reassociated(x_n, e_n, x_m, e_m, scale) -> torch.Tensor:
    """K (N, M) by the CUDA kernel's arithmetic, step by step in f32 (tests
    only).  Against `cross_covariance_plain`: the fourth root of
    det_n * det_m is split into one root per site (with 2 * scale folded
    in) and one per anchor; sqrt(3) moves under the root of t; one
    reciprocal of det(E_n + E_m) serves Q and C; exp(-t) is 2^(-t log2 e).
    The kernel's rcp/sqrt/ex2 approximations stand here as their exact
    counterparts."""
    scale = torch.as_tensor(scale, dtype=x_n.dtype, device=x_n.device)
    an = 2.0 * scale * torch.sqrt(torch.sqrt(e_n[:, 0] * e_n[:, 1] - e_n[:, 2] * e_n[:, 2]))
    rm = torch.sqrt(torch.sqrt(e_m[:, 0] * e_m[:, 1] - e_m[:, 2] * e_m[:, 2]))
    d0 = x_n[:, None, 0] - x_m[None, :, 0]
    d1 = x_n[:, None, 1] - x_m[None, :, 1]
    s00 = e_n[:, None, 0] + e_m[None, :, 0]
    s11 = e_n[:, None, 1] + e_m[None, :, 1]
    s01 = e_n[:, None, 2] + e_m[None, :, 2]
    inv_det = 1.0 / (s00 * s11 - s01 * s01)
    quad = s11 * d0 * d0 - 2.0 * s01 * d0 * d1 + s00 * d1 * d1
    t = torch.sqrt(1.5 * inv_det * quad + 3.0 * _EPS)
    # fmaxf: a NaN inv_det becomes 0 here and reaches the output through t
    pos = torch.where(inv_det > 0.0, inv_det, torch.zeros_like(inv_det))
    w = an[:, None] * rm[None, :] * torch.sqrt(pos + _EPS)
    return (w + w * t) * torch.exp2(t * -_LOG2E)


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
    if N == 0 or M == 0:
        return out              # nothing to launch, nothing counted
    fn = cuda_lib.lib("gp_kernels").como_cross_covariance_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x_n.device):    # the launch goes to the current device
        err = fn(*[cuda_lib.ptr(t) for t in ts], ctypes.c_float(scale),
                 cuda_lib.ptr(out), N, M, cuda_lib.stream_ptr(x_n.device))
    cuda_lib.check(err, "como_cross_covariance_f32")
    RECORDER.count("kernels.cross_covariance", key=(N, M))
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_n, e_n, x_m, e_m)):
        return CrossCovariance.apply(x_n, e_n, x_m, e_m, float(scale))
    return _launch(x_n, e_n, x_m, e_m, float(scale))


class CrossCovariance(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (CUDA)."""

    @staticmethod
    def forward(ctx, x_n, e_n, x_m, e_m, scale: float):
        ctx.save_for_backward(x_n, e_n, x_m, e_m)
        ctx.scale = scale
        return _launch(x_n, e_n, x_m, e_m, scale)

    @staticmethod
    def backward(ctx, grad):
        return (*cross_covariance_bwd(grad, *ctx.saved_tensors, ctx.scale), None)


def cross_covariance_vjp_plain(grad, x_n, e_n, x_m, e_m, scale):
    """(dL/dx_n, dL/de_n, dL/dx_m, dL/de_m) for dL/dK = grad: autograd of
    the plain version (the backward kernel's reference)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x_n, e_n, x_m, e_m)]
        K = cross_covariance_plain(*ins, scale)
        return torch.autograd.grad(K, ins, grad)


_BWD_COUNTERS = {}   # {(device index, stream): the int32 ticket counter, zero between launches}


def _bwd_counter(device) -> torch.Tensor:
    """The backward's ticket counter for launches on the current stream of
    the current device (the caller has set it to the tensors' device):
    zeroed once here (torch.zeros), and left zero by every launch (the
    kernel resets it when the last ticket is drawn).  One per stream, since
    launches on one stream never overlap."""
    key = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    if key not in _BWD_COUNTERS:
        _BWD_COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _BWD_COUNTERS[key]


def _launch_bwd(grad, x_n, e_n, x_m, e_m, scale: float):
    from como_tpu_torch import cuda_lib

    N, M = x_n.shape[0], x_m.shape[0]
    ts = [t.contiguous() for t in (grad, x_n, e_n, x_m, e_m)]
    if tuple(ts[0].shape) != (N, M):
        raise ValueError(f"cross_covariance_bwd: grad {tuple(grad.shape)} is not ({N}, {M})")
    for t in ts:
        if t.dtype != torch.float32 or t.device != x_n.device:
            raise ValueError("cross_covariance_bwd kernel takes f32 tensors on one device")
    if N == 0 or M == 0:        # nothing to launch, nothing counted
        return tuple(torch.zeros(t.shape, dtype=torch.float32, device=x_n.device)
                     for t in ts[1:])
    # the kernel writes every site's and every anchor's grads
    outs = [torch.empty(t.shape, dtype=torch.float32, device=x_n.device) for t in ts[1:]]
    lib = cuda_lib.lib("gp_kernels")
    lib.como_cross_covariance_bwd_scratch.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.como_cross_covariance_bwd_scratch.restype = ctypes.c_longlong
    fn = lib.como_cross_covariance_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    with torch.cuda.device(x_n.device):    # the launch goes to the current device
        scratch = torch.empty(lib.como_cross_covariance_bwd_scratch(N, M),
                              dtype=torch.float32, device=x_n.device)
        err = fn(*[cuda_lib.ptr(t) for t in ts], ctypes.c_float(scale), N, M,
                 *[cuda_lib.ptr(t) for t in outs], cuda_lib.ptr(scratch),
                 cuda_lib.ptr(_bwd_counter(x_n.device)), cuda_lib.stream_ptr(x_n.device))
    cuda_lib.check(err, "como_cross_covariance_bwd_f32")
    RECORDER.count("kernels.cross_covariance_bwd", key=(N, M))
    return tuple(outs)


def cross_covariance_bwd(grad, x_n, e_n, x_m, e_m, scale):
    """(dL/dx_n, dL/de_n, dL/dx_m, dL/de_m) for dL/dK = grad.  CUDA tensors
    launch the backward kernel; CPU tensors use autograd of the plain
    version."""
    if x_n.device.type == "cpu":
        return cross_covariance_vjp_plain(grad, x_n, e_n, x_m, e_m, scale)
    if x_n.device.type != "cuda":
        raise ValueError(f"cross_covariance_bwd: unsupported device {x_n.device}")
    return _launch_bwd(grad, x_n, e_n, x_m, e_m, float(scale))
