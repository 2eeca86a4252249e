"""DepthCov prior interface (port of como_tpu/net/depthcov.py).

The prior runs at network size (192 x 256) and the covariance image is
resized back to the working resolution; both resizes are skipped when the
image already has that size.  Two backends:
  * "analytic": structure-tensor prior, no parameters;
  * "unet": the UNet of net/unet.py with the weights of a flax msgpack
    checkpoint (models/depthcov.msgpack), read by utils/flax_msgpack.py.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from como_tpu_torch.net import analytic_prior
from como_tpu_torch.net import unet as unet_mod
from como_tpu_torch.ops.interp import resize_bilinear
from como_tpu_torch.utils import flax_msgpack

NETWORK_SIZE = (192, 256)
_REPO_ROOT = Path(__file__).resolve().parents[2]


def resolve_model_path(path: str) -> str:
    """A relative checkpoint path that does not exist under the working
    directory is looked up beside the package (the repository root), so
    `model_path: models/depthcov.msgpack` works from any directory."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    beside = _REPO_ROOT / path
    return str(beside) if beside.exists() else path


def load_params(path: str, device="cuda") -> dict:
    """state_dict for unet.UNet, on `device`, from a flax msgpack checkpoint."""
    tree = flax_msgpack.load(resolve_model_path(path))
    return {k: v.to(device) for k, v in unet_mod.unet_state_dict_from_flax(tree).items()}


def save_params(model_or_state_dict, path: str) -> None:
    """Write a UNet's parameters (the module or its state_dict) as a flax
    msgpack checkpoint that either package's load_params reads."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    flax_msgpack.save(path, unet_mod.flax_tree_from_unet_state_dict(sd))


class DepthCovPrior:
    def __init__(self, mode: str = "analytic", model_path: str = "",
                 network_size=NETWORK_SIZE, scale: float = 1.0, device="cuda",
                 compute_dtype: torch.dtype = torch.bfloat16, seed: int = 0):
        """mode "unet": weights from `model_path`, or, when it is empty,
        random ones drawn from torch.Generator().manual_seed(seed) (not the
        draws of flax's initialiser).  `compute_dtype` is the UNet's
        convolution type (see net/unet.py); the analytic prior ignores it."""
        if mode not in ("analytic", "unet"):
            raise ValueError(f"unknown prior mode '{mode}'")
        self.mode = mode
        self.network_size = tuple(network_size)
        self.scale = scale  # signal variance k(x, x)
        self.device = torch.device(device)
        self.unet = None
        if mode == "unet":
            net = unet_mod.UNet(compute_dtype=compute_dtype)
            div = 2 ** net.num_levels
            if self.network_size[0] % div or self.network_size[1] % div:
                raise ValueError(f"UNet needs image sides divisible by {div}, "
                                 f"got {self.network_size}")
            if model_path:
                net.load_state_dict(load_params(model_path, "cpu"), strict=True)
            else:
                unet_mod.init_unet_(net, torch.Generator().manual_seed(seed))
            self.unet = net.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def cov_params(self, rgb: torch.Tensor) -> torch.Tensor:
        """(1, 3, H, W) rgb in [0, 1] -> (3, H, W) packed covariance image
        at the input resolution."""
        out_size = tuple(rgb.shape[-2:])
        net_rgb = rgb
        if out_size != self.network_size:
            net_rgb = resize_bilinear(rgb, self.network_size)
        if self.unet is None:
            cov = analytic_prior.cov_params_from_rgb(net_rgb)
        else:
            cov = unet_mod.cov_params_from_rgb_unet(self.unet, net_rgb)
        if out_size != self.network_size:
            cov = resize_bilinear(cov, out_size)
        return cov
