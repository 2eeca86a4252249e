"""Image filtering + pyramids (port of como_tpu/ops/image.py).

Scharr/32 gradients and the 3x3 binomial blur with reflect padding, as
nine shifted multiply-adds (elementwise, so the result is the same on
every run and needs no cuDNN).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SCHARR_X = [[-3.0 / 32, 0.0, 3.0 / 32], [-10.0 / 32, 0.0, 10.0 / 32],
            [-3.0 / 32, 0.0, 3.0 / 32]]
SCHARR_Y = [list(r) for r in zip(*SCHARR_X)]
GAUSS_3 = [[1.0 / 16, 2.0 / 16, 1.0 / 16], [2.0 / 16, 4.0 / 16, 2.0 / 16],
           [1.0 / 16, 2.0 / 16, 1.0 / 16]]


def _depthwise_conv3(x: torch.Tensor, kernel) -> torch.Tensor:
    """3x3 depthwise correlation of (B, C, H, W) with reflect padding."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
    out = None
    for i in range(3):
        for j in range(3):
            k = kernel[i][j]
            if k == 0.0:
                continue
            term = k * xp[..., i:i + h, j:j + w]
            out = term if out is None else out + term
    return out


def image_gradients(x: torch.Tensor):
    return _depthwise_conv3(x, SCHARR_X), _depthwise_conv3(x, SCHARR_Y)


def gaussian_blur(x: torch.Tensor) -> torch.Tensor:
    return _depthwise_conv3(x, GAUSS_3)


def image_pyramid(x: torch.Tensor, start_level: int, end_level: int):
    """Blur + stride-2 decimate pyramid, coarsest level first."""
    pyr = []
    x_level = x
    for i in range(end_level - 1):
        if i >= start_level:
            pyr.insert(0, x_level)
        x_level = gaussian_blur(x_level)[:, :, 0::2, 0::2]
    pyr.insert(0, x_level)
    return pyr


def pyr_depth(depth: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "nearest_neighbor":
        return depth[..., 0::2, 0::2]
    a, b = depth[..., 0::2, 0::2], depth[..., 0::2, 1::2]
    c, d = depth[..., 1::2, 0::2], depth[..., 1::2, 1::2]
    if mode == "bilinear":
        return 0.25 * (a + b + c + d)
    if mode == "max":
        return torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    if mode == "min":
        return torch.minimum(torch.minimum(a, b), torch.minimum(c, d))
    raise ValueError(f"pyr_depth mode {mode} not implemented")


def depth_pyramid(depth: torch.Tensor, start_level: int, end_level: int, mode: str):
    pyr = []
    x_level = depth
    for i in range(end_level - 1):
        if i >= start_level:
            pyr.insert(0, x_level)
        x_level = pyr_depth(x_level, mode)
    pyr.insert(0, x_level)
    return pyr


def intrinsics_pyramid(K: torch.Tensor, start_level: int, end_level: int):
    from benchmark.reference.geometry.camera import resize_intrinsics

    pyr = []
    for i in range(start_level, end_level):
        s = 2.0 ** (-i)
        pyr.insert(0, resize_intrinsics(K, [s, s]))
    return pyr


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 1, H, W), ITU-R 601-2 weights."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=rgb.dtype, device=rgb.device)
    return torch.einsum("bchw,c->bhw", rgb, w)[:, None]


def img_and_grads(img: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 3C, H, W) stacked (img, gx, gy)."""
    gx, gy = image_gradients(img)
    return torch.cat([img, gx, gy], 1)
