"""Robust IRLS weight functions (port of como_tpu/odom/backend/robust.py)."""

from __future__ import annotations

import torch

HUBER_K = 1.345
TUKEY_T = 4.6851


def squared(r: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(r)


def huber(r: torch.Tensor, k: float = HUBER_K) -> torch.Tensor:
    ra = torch.abs(r)
    return torch.where(ra < k, torch.ones_like(ra), k / torch.clamp(ra, min=1e-20))



def tukey(r: torch.Tensor, t: float = TUKEY_T) -> torch.Tensor:
    ra = torch.abs(r)
    tmp = 1.0 - torch.square(ra / t)
    return torch.where(ra < t, tmp * tmp, torch.zeros_like(tmp))
