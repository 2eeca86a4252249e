"""Robust IRLS weight functions (port of como_tpu/odom/backend/robust.py)."""

from __future__ import annotations

import torch

HUBER_K = 1.345


def huber(r: torch.Tensor, k: float = HUBER_K) -> torch.Tensor:
    ra = torch.abs(r)
    return torch.where(ra < k, torch.ones_like(ra), k / torch.clamp(ra, min=1e-20))

