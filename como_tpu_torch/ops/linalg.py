"""Linear-algebra helpers (port of como_tpu/ops/linalg.py).

Cholesky goes through torch.linalg.cholesky_ex, which reports failure in
`info` instead of raising; `cholesky` below turns a failed factor into
NaNs, as jnp.linalg.cholesky does, so the callers' finiteness guards
behave as in the JAX package and nothing syncs to the host.
"""

from __future__ import annotations

import torch


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; all-NaN where the factorization failed."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def tri_solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, B, upper=False)


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = (L L^T)^-1 b for b (..., n, k)."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def cholesky_inverse(L: torch.Tensor) -> torch.Tensor:
    """A^-1 from its lower Cholesky factor."""
    m = L.shape[-1]
    I = torch.eye(m, dtype=L.dtype, device=L.device).expand(L.shape)
    return chol_solve(L, I)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower-middle median of x[mask] with static shapes:
    sorted[(n-1)//2] where masked-out entries sort to the end."""
    x_flat = x.reshape(-1)
    m_flat = mask.reshape(-1)
    big = torch.finfo(x_flat.dtype).max
    xs = torch.sort(torch.where(m_flat, x_flat, torch.full_like(x_flat, big))).values
    n = m_flat.sum()
    return xs[torch.clamp(n - 1, min=0) // 2]


def masked_mad_sigma(r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1.4826 * median(|r[mask]|), the robust sigma."""
    return 1.4826 * masked_median(torch.abs(r), mask)


def solve_chol(H: torch.Tensor, g: torch.Tensor, damping: float = 0.0) -> torch.Tensor:
    """x with H x = g by Cholesky, with optional damping on the diagonal;
    NaN where the factorization failed."""
    if damping:
        H = H + damping * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return chol_solve(cholesky(H), g[..., None])[..., 0]


def lstsq_chol(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """argmin ||A x - b|| by the normal equations and Cholesky."""
    At = A.transpose(-1, -2)
    return chol_solve(cholesky(At @ A), At @ b)


def det2x2(mats: torch.Tensor) -> torch.Tensor:
    return mats[..., 0, 0] * mats[..., 1, 1] - mats[..., 0, 1] * mats[..., 1, 0]


def inv2x2(mats: torch.Tensor):
    """(inverse, determinant) of (..., 2, 2) matrices."""
    dets = det2x2(mats)
    inv = torch.stack([torch.stack([mats[..., 1, 1], -mats[..., 0, 1]], -1),
                       torch.stack([-mats[..., 1, 0], mats[..., 0, 0]], -1)], -2)
    return inv / dets[..., None, None], dets


def median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median: mean of the two middle values of x (flattened); NaN if
    any entry is NaN.  (torch.median would return the lower middle.)"""
    xs = torch.sort(x.reshape(-1)).values
    n = xs.shape[0]
    mid = 0.5 * (xs[(n - 1) // 2] + xs[n // 2])
    return torch.where(torch.isnan(x).any(), torch.full_like(mid, float("nan")), mid)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x + 1e-8)
