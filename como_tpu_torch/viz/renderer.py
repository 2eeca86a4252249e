"""Headless map renderer: z-buffered point splatting (port of
como_tpu/viz/renderer.py), in PyTorch on the device of its inputs.

Each keyframe pixel becomes a splat of splat x splat output pixels; depth
conflicts resolve by a scatter-min z-buffer; optional Lambert shading from
depth-gradient normals.  Used by the snapshot viewer.

Colour rule.  A candidate (splat offset, point) wins its pixel when it is
valid and within 1e-4 relative of the pixel's z-buffer depth; the pixel
takes the colour of the winner with the largest key (splat offset, point
index).  Both steps are deterministic reductions (`scatter_reduce_` "amin"
of the depth, "amax" of the winners' keys, then a gather), so the image is
the same on every run and device.  The JAX package writes the colours with
a scatter-set in which a losing candidate writes back the pixel's old
value; on its CPU the last duplicate write wins, so a loser that follows the
winner in the same splat pass erases the winner's colour (ROADMAP §3).
Elsewhere the two agree.
"""

from __future__ import annotations

import torch

from como_tpu_torch.geometry.lie import invert_se3
from como_tpu_torch.ops import image as img_ops


def render_map(kf_rgb, kf_depth, kf_pose, kf_valid, K, T_view,
               out_size=(384, 512), splat: int = 2, shaded: bool = True):
    """Render keyframe clouds from T_view (world-from-camera).

    kf_rgb (K, 3, H, W), kf_depth (K, 1, H, W), kf_pose (K, 4, 4).
    Returns rgb (out_h, out_w, 3) in [0, 1] and depth (out_h, out_w).
    """
    u, v, z, ok, col = _project(kf_rgb, kf_depth, kf_pose, kf_valid, K, T_view, out_size,
                                shaded)
    return _splat(u, v, z, ok, col, out_size, splat)


def _project(kf_rgb, kf_depth, kf_pose, kf_valid, K, T_view, out_size, shaded: bool):
    """Every keyframe pixel's view-image coordinates u, v, depth z, validity
    and (shaded) colour, flattened in (keyframe, row, column) order."""
    Kn, _, H, W = kf_rgb.shape
    oh, ow = out_size
    dtype, dev = kf_rgb.dtype, kf_rgb.device
    sy, sx = oh / H, ow / W
    fx_o, cx_o = K[0, 0] * sx, K[0, 2] * sx
    fy_o, cy_o = K[1, 1] * sy, K[1, 2] * sy

    # backproject all KF pixels to world
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dtype, device=dev),
                            torch.arange(W, dtype=dtype, device=dev), indexing="ij")
    rx = (xs - K[0, 2]) / K[0, 0]
    ry = (ys - K[1, 2]) / K[1, 1]
    ray = torch.stack([rx, ry, torch.ones_like(rx)], 0)[None]     # (1,3,H,W)
    Pc = kf_depth * ray                                             # (K,3,H,W)
    R = kf_pose[:, :3, :3]
    t = kf_pose[:, :3, 3]
    Pw = torch.einsum("kij,kjhw->kihw", R, Pc) + t[:, :, None, None]

    shade = torch.ones((Kn, 1, H, W), dtype=dtype, device=dev)
    if shaded:
        # normals from depth gradients: cross of the backprojected-surface
        # tangent vectors
        gx_d, gy_d = img_ops.image_gradients(kf_depth)
        tx = torch.stack([kf_depth[:, 0] / K[0, 0] + rx * gx_d[:, 0],
                          ry * gx_d[:, 0], gx_d[:, 0]], 1)
        ty = torch.stack([rx * gy_d[:, 0],
                          kf_depth[:, 0] / K[1, 1] + ry * gy_d[:, 0], gy_d[:, 0]], 1)
        n = torch.linalg.cross(tx.permute(0, 2, 3, 1), ty.permute(0, 2, 3, 1))
        n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-9)
        lambert = torch.abs(n[..., 2])                             # headlight
        shade = (0.35 + 0.65 * lambert)[:, None]

    # transform into the view camera, project
    Tcw = invert_se3(T_view)
    Pv = torch.einsum("ij,kjhw->kihw", Tcw[:3, :3], Pw) + Tcw[:3, 3][None, :, None, None]
    z = Pv[:, 2]
    zs = torch.where(z > 1e-6, z, torch.ones_like(z))
    u = (fx_o * Pv[:, 0] / zs + cx_o).reshape(-1)
    v = (fy_o * Pv[:, 1] / zs + cy_o).reshape(-1)
    z = z.reshape(-1)
    col = (kf_rgb * shade).permute(0, 2, 3, 1).reshape(-1, 3)
    ok = ((z > 1e-6) & kf_valid.repeat_interleave(H * W)
          & (u >= 0) & (u < ow - 1) & (v >= 0) & (v < oh - 1))
    return u, v, z, ok, col


def _splat(u, v, z, ok, col, out_size, splat: int):
    """z-buffer and colour rule (module doc) of the projected points."""
    oh, ow = out_size
    dtype, dev = col.dtype, col.device
    # candidate (splat offset s, point p) -> output pixel, key s * N + p
    N = u.shape[0]
    ui = torch.clamp(u.to(torch.int64), 0, ow - 1)
    vi = torch.clamp(v.to(torch.int64), 0, oh - 1)
    idx = torch.cat([torch.clamp(vi + dy, 0, oh - 1) * ow + torch.clamp(ui + dx, 0, ow - 1)
                     for dy in range(splat) for dx in range(splat)])
    big = 1e9
    zq = torch.where(ok, z, torch.full_like(z, big)).repeat(splat * splat)
    zbuf = torch.full((oh * ow,), big, dtype=dtype, device=dev).scatter_reduce_(
        0, idx, zq, "amin")
    win = ok.repeat(splat * splat) & (zq <= zbuf[idx] * (1.0 + 1e-4))
    key = torch.arange(splat * splat * N, device=dev)
    best = torch.full((oh * ow,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, idx, torch.where(win, key, torch.full_like(key, -1)), "amax")
    img = torch.where((best >= 0)[:, None], col[best.clamp(min=0) % N],
                      torch.zeros((), dtype=dtype, device=dev))
    depth_out = torch.where(zbuf >= big, torch.zeros_like(zbuf), zbuf).reshape(oh, ow)
    return img.reshape(oh, ow, 3), depth_out
