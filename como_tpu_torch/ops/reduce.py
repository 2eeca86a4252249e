"""Fast masked reductions (port of como_tpu/ops/reduce.py).

`histogram_median` is the same two-pass, 512-bin histogram median as the
JAX package (not torch.median): the median bin is refined once, giving a
resolution of (max - min) / bins^2.  Bin counts are scatter-added 0/1
weights, i.e. exact integer sums in f32, so the result is the same
whatever order the parallel scatter adds them in.
"""

from __future__ import annotations

import torch


def histogram_median(x: torch.Tensor, mask: torch.Tensor, bins: int = 512,
                     passes: int = 2) -> torch.Tensor:
    """Approximate median of x[mask] (flattened): a scalar."""
    return histogram_median_rows(x.reshape(1, -1), mask.reshape(1, -1),
                                 bins, passes)[0]


def histogram_median_rows(x: torch.Tensor, mask: torch.Tensor, bins: int = 512,
                          passes: int = 2) -> torch.Tensor:
    """histogram_median of each row of x (B, N) under mask (B, N): (B,).
    All rows share one scatter-add per pass."""
    xb, mb = x, mask
    B, N = xb.shape
    dtype, dev = xb.dtype, xb.device
    w = mb.to(dtype)
    n = w.sum(1)
    big = torch.finfo(dtype).max
    lo = torch.where(mb, xb, torch.full_like(xb, big)).amin(1)
    hi = torch.where(mb, xb, torch.full_like(xb, -big)).amax(1)
    target = torch.floor(torch.clamp(n - 1.0, min=0.0) / 2.0) + 1.0
    offs = (torch.arange(B, device=dev) * bins)[:, None]
    for _ in range(passes):
        span = torch.clamp(hi - lo, min=1e-20)
        t = (xb - lo[:, None]) / span[:, None]
        # a NaN sample lands in no bin (as with the JAX one-hot)
        tb = torch.floor(t * bins)
        finite = ~torch.isnan(t)
        idx = torch.clamp(torch.where(finite, tb, torch.zeros_like(tb)),
                          0, bins - 1).to(torch.int64)
        # scatter_add_, not bincount: bincount reads the max index back to
        # the host on CUDA, a sync inside every solver iteration
        hist = torch.zeros(B * bins, dtype=dtype, device=dev).scatter_add_(
            0, (idx + offs).reshape(-1), (w * finite).reshape(-1)).reshape(B, bins)
        cum = torch.cumsum(hist, 1)
        b = (cum >= target[:, None]).to(torch.int32).argmax(1)   # first bin
        width = span / bins
        new_lo = lo + b.to(dtype) * width
        hi = new_lo + width
        prev = torch.where(b > 0, cum.gather(1, (b - 1).clamp(min=0)[:, None])[:, 0],
                           torch.zeros_like(lo))
        target = target - prev
        inside = (xb >= new_lo[:, None]) & (xb <= hi[:, None])
        w = w * inside
        lo = new_lo
    return 0.5 * (lo + hi)


def fast_mad_sigma(r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1.4826 * median(|r[mask]|) via the histogram median (scalar)."""
    return 1.4826 * histogram_median(torch.abs(r).reshape(-1), mask.reshape(-1))
