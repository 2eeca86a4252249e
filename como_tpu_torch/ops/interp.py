"""Bilinear sparse sampling + image resize (port of como_tpu/ops/interp.py).

Sampling is at *pixel* coordinates with grid_sample(align_corners=False)
semantics; all functions are gathers over flattened H*W.
"""

from __future__ import annotations

import torch


def _taps(x: torch.Tensor, y: torch.Tensor):
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = x - x0f
    wy = y - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    return x0, y0, x0 + 1, y0 + 1, wx, wy


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor,
                    padding: str = "zeros") -> torch.Tensor:
    """Sample img (C, H, W) at pixel coords xy (N, 2) -> (C, N)."""
    C, H, W = img.shape
    x0, y0, x1, y1, wx, wy = _taps(xy[..., 0], xy[..., 1])
    if padding == "border":
        one = torch.ones((), dtype=img.dtype, device=img.device)
        m00 = m01 = m10 = m11 = one
    elif padding == "zeros":
        def inb(xi, yi):
            return ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).to(img.dtype)
        m00, m01, m10, m11 = inb(x0, y0), inb(x1, y0), inb(x0, y1), inb(x1, y1)
    else:
        raise ValueError(f"unknown padding {padding}")
    x0c, x1c = x0.clamp(0, W - 1), x1.clamp(0, W - 1)
    y0c, y1c = y0.clamp(0, H - 1), y1.clamp(0, H - 1)
    flat = img.reshape(C, H * W)

    def tap(yc, xc):
        return flat[:, yc * W + xc]

    w00 = (1 - wx) * (1 - wy) * m00
    w01 = wx * (1 - wy) * m01
    w10 = (1 - wx) * wy * m10
    w11 = wx * wy * m11
    return (tap(y0c, x0c) * w00 + tap(y0c, x1c) * w01
            + tap(y1c, x0c) * w10 + tap(y1c, x1c) * w11)


def img_interp(img: torch.Tensor, xy: torch.Tensor):
    """Sample (C, H, W) at xy (N, 2) with zeros padding -> vals (C, N) and
    valid (N,): 1 <= x < W-1 and 1 <= y < H-1 (the strict interior, where
    image gradients are clean)."""
    _, H, W = img.shape
    x, y = xy[..., 0], xy[..., 1]
    valid = (x >= 1) & (x < W - 1) & (y >= 1) & (y < H - 1)
    return bilinear_sample(img, xy, padding="zeros"), valid


def batched_bilinear_sample(imgs: torch.Tensor, xy: torch.Tensor,
                            padding: str = "zeros") -> torch.Tensor:
    """bilinear_sample over a leading batch: (B, C, H, W) at (B, N, 2) ->
    (B, C, N)."""
    return torch.stack([bilinear_sample(i, p, padding) for i, p in zip(imgs, xy)])


def batched_img_interp(imgs: torch.Tensor, xy: torch.Tensor):
    """img_interp over a leading batch: vals (B, C, N), valid (B, N)."""
    vals, valid = zip(*(img_interp(i, p) for i, p in zip(imgs, xy)))
    return torch.stack(vals), torch.stack(valid)


def bilinear_sample_frames(imgs: torch.Tensor, j: torch.Tensor,
                           xy: torch.Tensor) -> torch.Tensor:
    """Sample imgs (F, C, H, W) at xy (P, N, 2) from frame j[p] -> (P, C, N).

    Zeros padding; ONE stacked-index gather over the flattened (C, F*H*W)
    buffer (no per-pair image copies)."""
    F, C, H, W = imgs.shape
    x0, y0, x1, y1, wx, wy = _taps(xy[..., 0], xy[..., 1])

    def inb(xi, yi):
        return ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).to(imgs.dtype)

    ms = torch.stack([inb(x0, y0), inb(x1, y0), inb(x0, y1), inb(x1, y1)])
    x0c, x1c = x0.clamp(0, W - 1), x1.clamp(0, W - 1)
    y0c, y1c = y0.clamp(0, H - 1), y1.clamp(0, H - 1)
    idx = torch.stack([y0c * W + x0c, y0c * W + x1c,
                       y1c * W + x0c, y1c * W + x1c])          # (4, P, N)
    ws = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy),
                      (1 - wx) * wy, wx * wy]) * ms
    gidx = j.to(torch.int64)[None, :, None] * (H * W) + idx
    flat = imgs.transpose(0, 1).reshape(C, F * H * W)
    taps = flat[:, gidx]                                         # (C, 4, P, N)
    # the taps are summed by elementwise multiply-adds in order, so that a
    # pair's samples do not depend on how many pairs the call has (a batched
    # contraction's rounding does on CUDA; see odom/backend/gn_step.py)
    out = taps[:, 0] * ws[0]
    for t in range(1, 4):
        out = torch.addcmul(out, taps[:, t], ws[t])
    return out.transpose(0, 1)


def _resize_weights(in_size: int, out_size: int, dtype, device) -> torch.Tensor:
    """(in, out) triangle-kernel weights of jax.image.resize("linear"),
    antialiased when downsampling (kernel widened by in/out)."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=dtype, device=device) + 0.5)
                * inv_scale - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=dtype,
                                                   device=device)[:, None]) / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(weights, 0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    weights = torch.where(torch.abs(total) > eps,
                          weights / torch.where(total != 0, total,
                                                torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_bilinear(img: torch.Tensor, out_size, align_corners: bool = False) -> torch.Tensor:
    """Resize (..., H, W) to out_size=(H2, W2) exactly as
    jax.image.resize(method="linear"): a separable triangle-kernel
    scale-and-translate that antialiases when downsampling.  Axes whose
    size does not change are left untouched.  `align_corners` is accepted
    and not read, as in como_tpu: the sampling is always half-pixel
    centred."""
    H, W = img.shape[-2:]
    H2, W2 = int(out_size[0]), int(out_size[1])
    out = img
    if H2 != H:
        wy = _resize_weights(H, H2, img.dtype, img.device)
        out = torch.einsum("...hw,hk->...kw", out, wy)
    if W2 != W:
        wx = _resize_weights(W, W2, img.dtype, img.device)
        out = torch.einsum("...hw,wk->...hk", out, wx)
    return out
