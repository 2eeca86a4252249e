"""Fast masked reductions (port of como_tpu/ops/reduce.py).

`histogram_median` is the same two-pass, 512-bin histogram median as the
JAX package (not torch.median): the median bin is refined once, giving a
resolution of (max - min) / bins^2.  Bin counts are scatter-added 0/1
weights, i.e. exact integer sums in f32, so the result is the same
whatever order the parallel scatter adds them in.

The same holds across shards (`histogram_median_shards`, the counterpart
of the JAX package's `axis_name=` psum): the count is a sum, the range a
min / max and each pass's histogram a sum of per-shard histograms, all
exact, so the median of data split over shards is bitwise the median of
their concatenation.
"""

from __future__ import annotations

from typing import Sequence

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
    return histogram_median_shards([x], [mask], x.device, bins, passes)


def reduce_in_order(op, parts, device):
    """parts[0] op parts[1] op ... on `device`, in list order."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = op(out, p.to(device))
    return out


def histogram_median_shards(xs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                            device, bins: int = 512, passes: int = 2) -> torch.Tensor:
    """histogram_median_rows of the concatenation along dim 1 of the shards
    xs[s] (B, N_s) under masks[s], each on its own device: (B,) on `device`.
    Per pass, each shard bins its own samples; the histograms are summed on
    `device` and the refined range is sent back to the shards."""
    dtype = xs[0].dtype
    big = torch.finfo(dtype).max
    ws = [mb.to(dtype) for mb in masks]
    n = reduce_in_order(torch.add, [w.sum(1) for w in ws], device)
    lo = reduce_in_order(torch.minimum, [torch.where(mb, xb, torch.full_like(xb, big)).amin(1)
                                         for xb, mb in zip(xs, masks)], device)
    hi = reduce_in_order(torch.maximum, [torch.where(mb, xb, torch.full_like(xb, -big)).amax(1)
                                         for xb, mb in zip(xs, masks)], device)
    B = lo.shape[0]
    target = torch.floor(torch.clamp(n - 1.0, min=0.0) / 2.0) + 1.0
    for _ in range(passes):
        span = torch.clamp(hi - lo, min=1e-20)
        hists = []
        for xb, w in zip(xs, ws):
            lo_s, span_s = lo.to(xb.device), span.to(xb.device)
            t = (xb - lo_s[:, None]) / span_s[:, None]
            # a NaN sample lands in no bin (as with the JAX one-hot)
            tb = torch.floor(t * bins)
            finite = ~torch.isnan(t)
            idx = torch.clamp(torch.where(finite, tb, torch.zeros_like(tb)),
                              0, bins - 1).to(torch.int64)
            offs = (torch.arange(B, device=xb.device) * bins)[:, None]
            # scatter_add_, not bincount: bincount reads the max index back
            # to the host on CUDA, a sync inside every solver iteration
            hists.append(torch.zeros(B * bins, dtype=dtype, device=xb.device).scatter_add_(
                0, (idx + offs).reshape(-1), (w * finite).reshape(-1)).reshape(B, bins))
        hist = reduce_in_order(torch.add, hists, device)
        cum = torch.cumsum(hist, 1)
        b = (cum >= target[:, None]).to(torch.int32).argmax(1)   # first bin
        width = span / bins
        new_lo = lo + b.to(dtype) * width
        hi = new_lo + width
        prev = torch.where(b > 0, cum.gather(1, (b - 1).clamp(min=0)[:, None])[:, 0],
                           torch.zeros_like(lo))
        target = target - prev
        for s, xb in enumerate(xs):
            lo_s, hi_s = new_lo.to(xb.device), hi.to(xb.device)
            inside = (xb >= lo_s[:, None]) & (xb <= hi_s[:, None])
            ws[s] = ws[s] * inside
        lo = new_lo
    return 0.5 * (lo + hi)


def fast_mad_sigma(r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1.4826 * median(|r[mask]|) via the histogram median (scalar)."""
    return fast_mad_sigma_shards([r], [mask], r.device)


def fast_mad_sigma_shards(rs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                          device) -> torch.Tensor:
    """fast_mad_sigma of the concatenation of the shards rs[s] under
    masks[s] (any shapes, each on its own device): a scalar on `device`,
    bitwise equal to fast_mad_sigma of the concatenated data."""
    return 1.4826 * histogram_median_shards(
        [torch.abs(r).reshape(1, -1) for r in rs], [m.reshape(1, -1) for m in masks],
        device)[0]
