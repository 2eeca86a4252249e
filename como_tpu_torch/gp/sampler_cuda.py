"""Greedy-sampler downdate step: hand-written CUDA kernel + plain twin.

Replaces the TPU kernel como_tpu/gp/sampler_pallas.py::_downdate_kernel
(downdate_step, pallas_call at :96).  Kernel source:
como_tpu_torch/csrc/sampler_kernels.cu; its header states what bounds it
on the H100 (reading the (S, D) obs_info rows) and how the design meets
that (one thread per site, column-wise coalesced row walk, scalars read
from device memory so the 64-step loop never syncs).

Both versions update in place: obs_info[row], var and min_dist_sq.  The
per-iteration scalars travel as one device tensor
sc = [x_i0, x_i1, e_i00, e_i11, e_i01, 1/l_ii, select, scale].
`downdate_step` dispatches on device: CPU tensors go to
`downdate_step_plain` (the XLA branch, como_tpu/gp/sampler.py:162-171);
CUDA tensors launch the kernel or raise.  Each launch counts in the
recorder's counter "kernels.downdate", keyed by (S, D)
(utils/profiling.py).
"""

from __future__ import annotations

import ctypes

import torch

from como_tpu_torch.gp.kernels_cuda import cross_covariance_plain
from como_tpu_torch.utils.profiling import RECORDER


def downdate_step_plain(xnT, enT, obs_info, var, min_dist_sq, sc, l_ni,
                        row: int) -> None:
    x_i, e_i = sc[0:2], sc[2:5]
    inv_lii, sel, scale = sc[5], sc[6], sc[7]
    k_id = cross_covariance_plain(x_i[None], e_i[None], xnT.T, enT.T, scale)[0]
    obs_new = (k_id - (l_ni[None, :] @ obs_info)[0]) * (inv_lii * sel)
    obs_info[row] = obs_new
    var.sub_(obs_new * obs_new)
    d2 = torch.sum(torch.square(xnT.T - x_i[None]), -1)
    min_dist_sq.copy_(torch.where(sel > 0, torch.minimum(min_dist_sq, d2),
                                  min_dist_sq))


def _launch(xnT, enT, obs_info, var, min_dist_sq, sc, l_ni, row: int) -> None:
    from como_tpu_torch import cuda_lib

    S, D = obs_info.shape
    shapes = {"xnT": (xnT, (2, D)), "enT": (enT, (3, D)),
              "obs_info": (obs_info, (S, D)), "var": (var, (D,)),
              "min_dist_sq": (min_dist_sq, (D,)), "sc": (sc, (8,)),
              "l_ni": (l_ni, (S,))}
    for name, (t, shape) in shapes.items():
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != obs_info.device):
            raise ValueError(f"downdate_step kernel: {name} must be a contiguous "
                             f"f32 {shape} tensor on {obs_info.device}")
    if not 0 <= row < S:
        raise ValueError(f"downdate_step kernel: row {row} outside [0, {S})")
    fn = cuda_lib.lib("sampler_kernels").como_downdate_step_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(obs_info.device):    # the launch goes to the current device
        err = fn(*[cuda_lib.ptr(t) for t in (xnT, enT, obs_info, var, min_dist_sq,
                                             sc, l_ni)],
                 S, D, row, cuda_lib.stream_ptr(obs_info.device))
    cuda_lib.check(err, "como_downdate_step_f32")
    RECORDER.count("kernels.downdate", key=(S, D))


def downdate_step(xnT, enT, obs_info, var, min_dist_sq, sc, l_ni, row: int) -> None:
    """One greedy-entropy iteration's domain pass, in place."""
    if obs_info.device.type == "cpu":
        return downdate_step_plain(xnT, enT, obs_info, var, min_dist_sq, sc,
                                   l_ni, row)
    if obs_info.device.type != "cuda":
        raise ValueError(f"downdate_step: unsupported device {obs_info.device}")
    return _launch(xnT, enT, obs_info, var, min_dist_sq, sc, l_ni, row)
