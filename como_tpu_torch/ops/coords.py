"""Coordinate conventions + grids (port of como_tpu/ops/coords.py).

"rc" coords are (row, col); "xy" pixels are (x, y) = (col, row).
Normalized coords follow grid_sample(align_corners=False):
x_norm = 2*x/dim + 1/dim - 1.
"""

from __future__ import annotations

import torch


def swap_xy(coords: torch.Tensor) -> torch.Tensor:
    """(row, col) <-> (x, y) on the last axis."""
    return torch.stack([coords[..., 1], coords[..., 0]], -1)


def normalize_coords(x_pixel: torch.Tensor, dims) -> torch.Tensor:
    A = 1.0 / torch.as_tensor(dims, dtype=x_pixel.dtype, device=x_pixel.device)
    return 2.0 * A * x_pixel + A - 1.0


def unnormalize_coords(x_norm: torch.Tensor, dims) -> torch.Tensor:
    A = torch.as_tensor(dims, dtype=x_norm.dtype, device=x_norm.device) / 2.0
    return A * x_norm + A - 0.5


def coord_grid_rc(img_size, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """(H*W, 2) full grid of (row, col) coords, row-major."""
    h, w = img_size
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([ys.reshape(-1), xs.reshape(-1)], -1)


def coord_img_rc(img_size, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """(H, W, 2) image of (row, col) coords."""
    h, w = img_size
    return coord_grid_rc(img_size, dtype, device).reshape(h, w, 2)


def fill_image(coords_rc: torch.Tensor, vals: torch.Tensor, img_size,
               default_val=float("nan")) -> torch.Tensor:
    """Scatter vals at integer rc coords (N, 2) into an (H, W) image.

    Same semantics as the JAX `.at[r, c].set(v, mode="drop")`: coords are
    truncated toward zero, negative indices wrap once (NumPy style), what
    is still out of range is dropped, and where several points land on
    one pixel the LAST one (highest point index) wins.  The winner is
    found with a deterministic scatter-max of point indices, so the result
    does not depend on the order of a parallel scatter.
    """
    h, w = img_size
    r = coords_rc[..., 0].to(torch.int64).reshape(-1)
    c = coords_rc[..., 1].to(torch.int64).reshape(-1)
    v = vals.reshape(-1)
    r = torch.where(r < 0, r + h, r)
    c = torch.where(c < 0, c + w, c)
    ok = (r >= 0) & (r < h) & (c >= 0) & (c < w)
    flat = torch.where(ok, r * w + c, torch.full_like(r, h * w))  # dump slot
    order = torch.arange(v.shape[0], device=v.device)
    winner = torch.full((h * w + 1,), -1, dtype=torch.int64, device=v.device)
    winner = winner.scatter_reduce(0, flat, order, reduce="amax")[: h * w]
    img = torch.where(winner >= 0, v[winner.clamp(min=0)],
                      torch.full_like(winner, 0, dtype=v.dtype) + default_val)
    return img.reshape(h, w)
