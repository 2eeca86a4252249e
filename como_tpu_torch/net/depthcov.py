"""DepthCov prior interface (port of como_tpu/net/depthcov.py, analytic mode).

The prior runs at network size (192 x 256) and the covariance image is
resized back to the working resolution; both resizes are skipped when the
image already has that size.
"""

from __future__ import annotations

import torch

from como_tpu_torch.net import analytic_prior
from como_tpu_torch.ops.interp import resize_bilinear

NETWORK_SIZE = (192, 256)


class DepthCovPrior:
    def __init__(self, mode: str = "analytic", model_path: str = "",
                 network_size=NETWORK_SIZE, scale: float = 1.0):
        if mode == "unet":
            raise NotImplementedError(
                "prior 'unet' is not ported yet (ROADMAP: port queue, "
                "'Learned prior': torch UNet + msgpack -> state_dict converter)")
        if mode != "analytic":
            raise ValueError(f"unknown prior mode '{mode}'")
        self.mode = mode
        self.network_size = tuple(network_size)
        self.scale = scale  # signal variance k(x, x)

    def cov_params(self, rgb: torch.Tensor) -> torch.Tensor:
        """(1, 3, H, W) rgb in [0, 1] -> (3, H, W) packed covariance image
        at the input resolution."""
        out_size = tuple(rgb.shape[-2:])
        net_rgb = rgb
        if out_size != self.network_size:
            net_rgb = resize_bilinear(rgb, self.network_size)
        cov = analytic_prior.cov_params_from_rgb(net_rgb)
        if out_size != self.network_size:
            cov = resize_bilinear(cov, out_size)
        return cov
