"""Affine brightness composition (port of como_tpu/geometry/affine.py).

aff arrays are (B, 2, 1): row 0 = a (log scale), row 1 = b (bias).
"""

from __future__ import annotations

import torch


def get_aff_w_curr(aff_w_ref: torch.Tensor, aff_curr_ref: torch.Tensor) -> torch.Tensor:
    a = aff_w_ref[:, 0, :] + aff_curr_ref[:, 0, :]
    b = aff_w_ref[:, 1, :] + aff_curr_ref[:, 1, :] * torch.exp(aff_curr_ref[:, 0, :])
    return torch.stack([a, b], 1)


def get_rel_aff(aff1: torch.Tensor, aff2: torch.Tensor) -> torch.Tensor:
    a = aff1[:, 0, :] - aff2[:, 0, :]
    b = torch.exp(-a) * (aff1[:, 1, :] - aff2[:, 1, :])
    return torch.stack([a, b], 1)
