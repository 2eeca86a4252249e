"""The DepthCov UNet prior in plain PyTorch: the frozen copy of the UNet
(net/unet.py) with its weights read from the checkpoint file by the frozen
msgpack reader, run in the configuration's precision (bf16 convolutions,
f32 elsewhere) or, for the control, with every convolution's input and
weights quantized to fp8 (e4m3, one scale per tensor)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference.net import unet
from benchmark.reference.ops.interp import resize_bilinear
from benchmark.reference.utils import flax_msgpack

FP8_MAX = 448.0
NETWORK_SIZE = (192, 256)   # the UNet runs here; other sizes are resized to it and back


def load(path: str, device) -> unet.UNet:
    net = unet.UNet(compute_dtype=torch.bfloat16)
    net.load_state_dict(unet.unet_state_dict_from_flax(flax_msgpack.load(path)), strict=True)
    return net.to(device).eval().requires_grad_(False)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(t.abs().amax().float(), min=1e-12) / FP8_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(torch.bfloat16)


def _conv_fp8(conv, x, dtype):
    return F.conv2d(_fp8(x), _fp8(conv.weight), conv.bias.to(torch.bfloat16),
                    padding=conv.padding)


@contextlib.contextmanager
def fp8_convolutions():
    orig = unet._conv
    unet._conv = _conv_fp8
    try:
        yield
    finally:
        unet._conv = orig


@torch.no_grad()
def cov_params(net: unet.UNet, rgb: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """(1, 3, H, W) rgb -> (3, H, W) packed covariance image."""
    size = tuple(rgb.shape[-2:])
    if size != NETWORK_SIZE:
        rgb = resize_bilinear(rgb, NETWORK_SIZE)
    with fp8_convolutions() if fp8 else contextlib.nullcontext():
        cov = unet.cov_params_from_rgb_unet(net, rgb)
    return cov if size == NETWORK_SIZE else resize_bilinear(cov, size)
