"""DepthCov UNet, the learned covariance prior (port of como_tpu/net/unet.py).

ImageNet normalization, residual conv blocks with GroupNorm(16) +
LeakyReLU, maxpool-2 encoder, bilinear-upsample decoder with skip concat,
per-level 1x1 heads and the covariance activation.  Layout is NCHW with
OIHW weights; submodules carry the flax names (`base`, `down{i}`,
`up{i}_conv`, `up{i}_block`, `head{i}`); unet_state_dict_from_flax
carries a flax parameter tree across and flax_tree_from_unet_state_dict
carries it back.

Precision follows the flax module step by step, by explicit casts at each
call (not torch.autocast, whose op lists would also move the skip sum and
the upsampling): parameters stay f32; every 3x3 / 1x1 block convolution
casts its input and its weights to `compute_dtype` (bf16 by default) and
returns that type; GroupNorm computes and returns f32; the residual sum,
the activations, pooling, upsampling, the heads and the covariance
activation are f32.  GroupNorm's eps is flax's 1e-6, not PyTorch's 1e-5.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_LOG_LO, _LOG_HI = float(np.log(1e-3)), float(np.log(1e4))


def cov_activation(params: torch.Tensor, det_eps: float = 1e-8, corr_max: float = 0.99,
                   dim: int = -1) -> torch.Tensor:
    """Raw (.., 3, ..) -> packed SPD covariance components (e00, e11, e01)
    along `dim`: exp-clamped diagonal, tanh-bounded correlation, determinant
    guard."""
    a, b, c = params.unbind(dim)
    x = torch.exp(torch.clamp(a, _LOG_LO, _LOG_HI))
    z = torch.exp(torch.clamp(b, _LOG_LO, _LOG_HI))
    corr = corr_max * torch.tanh(c)
    off = torch.sqrt(torch.clamp(x * z - det_eps, min=0.0)) * corr
    return torch.stack([x, z, off], dim)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """conv with input, weight and bias cast to `dtype` at the call."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    padding=conv.padding)


class ResidualConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv3 = nn.Conv2d(in_channels, out_channels, 1)
        # one GroupNorm (one pair of parameters) serves both convolutions
        self.norm = nn.GroupNorm(16, out_channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.leaky_relu(self.norm(_conv(self.conv1, x, dt).float()), 0.01)
        y = self.norm(_conv(self.conv2, y, dt).float())
        xs = _conv(self.conv3, x, dt)
        return F.leaky_relu(xs.float() + y, 0.01)


class UNet(nn.Module):
    """forward(rgb (B, 3, H, W) in [0, 1]) -> per-level packed covariance
    maps (B, 3, h, w), coarse -> fine; the last is at the input size."""

    def __init__(self, num_levels: int = 5, base_channels: int = 16, out_channels: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_levels = num_levels
        self.compute_dtype = compute_dtype
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)
        self.base = ResidualConv(3, base_channels, compute_dtype)
        c = base_channels
        for i in range(num_levels):
            setattr(self, f"down{i}", ResidualConv(c, 2 * c, compute_dtype))
            c *= 2
        for i in range(num_levels - 1, -1, -1):
            setattr(self, f"up{i}_conv", nn.Conv2d(c, c // 2, 3, padding=1))
            # input: [upsampled (c/2), encoder level i (c/2)]
            setattr(self, f"up{i}_block", ResidualConv(c, c // 2, compute_dtype))
            setattr(self, f"head{i}", nn.Conv2d(c // 2, out_channels, 1))
            c //= 2

    def forward(self, rgb: torch.Tensor):
        div = 2 ** self.num_levels
        if rgb.shape[-2] % div or rgb.shape[-1] % div:
            raise ValueError(f"UNet needs image sides divisible by {div}, "
                             f"got {tuple(rgb.shape[-2:])}")
        x = (rgb.float() - self.mean) / self.std
        enc = [self.base(x)]
        for i in range(self.num_levels):
            enc.append(getattr(self, f"down{i}")(F.max_pool2d(enc[-1], 2, 2)))
        outs = []
        y = enc[-1]
        for i in range(self.num_levels - 1, -1, -1):
            y = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=False)
            y = _conv(getattr(self, f"up{i}_conv"), y, self.compute_dtype)
            y = getattr(self, f"up{i}_block")(torch.cat([y.float(), enc[i]], 1))
            head = getattr(self, f"head{i}")
            outs.append(cov_activation(_conv(head, y, torch.float32), dim=1))
        return outs


def cov_params_from_rgb_unet(model: UNet, rgb: torch.Tensor) -> torch.Tensor:
    """(1, 3, H, W) -> (3, H, W) packed covariance at the finest level."""
    return model(rgb)[-1][0]


def unet_state_dict_from_flax(tree: dict) -> dict:
    """A flax UNet parameter tree of numpy arrays ({"params": {...}} or the
    inner dict) as a state_dict for `UNet`: conv kernels HWIO -> OIHW,
    GroupNorm `scale` -> `weight`.  Every leaf must be one it knows."""
    params = tree.get("params", tree)
    out = {}

    def conv(prefix, leaf):
        if sorted(leaf) != ["bias", "kernel"]:
            raise ValueError(f"{prefix}: expected kernel and bias, got {sorted(leaf)}")
        out[prefix + ".weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(leaf["kernel"], (3, 2, 0, 1))))
        out[prefix + ".bias"] = torch.from_numpy(np.array(leaf["bias"]))

    for name, sub in params.items():
        if sorted(sub) == ["bias", "kernel"]:
            conv(name, sub)
            continue
        if sorted(sub) != ["conv1", "conv2", "conv3", "norm"]:
            raise ValueError(f"{name}: not a conv or a residual block: {sorted(sub)}")
        for k in ("conv1", "conv2", "conv3"):
            conv(f"{name}.{k}", sub[k])
        if sorted(sub["norm"]) != ["bias", "scale"]:
            raise ValueError(f"{name}.norm: expected scale and bias")
        out[f"{name}.norm.weight"] = torch.from_numpy(np.array(sub["norm"]["scale"]))
        out[f"{name}.norm.bias"] = torch.from_numpy(np.array(sub["norm"]["bias"]))
    return out


def flax_tree_from_unet_state_dict(state_dict: dict) -> dict:
    """The inverse of unet_state_dict_from_flax: a `UNet` state_dict as a
    flax parameter tree {"params": {...}} of f32 numpy arrays (OIHW -> HWIO,
    GroupNorm `weight` -> `scale`), keys sorted as flax writes them."""
    params: dict = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", np.transpose(arr, (2, 3, 1, 0))
        elif leaf == "weight" and path[-1] == "norm":
            leaf = "scale"
        elif leaf != "bias":
            raise ValueError(f"{key}: not a UNet parameter")
        node = params
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(arr)

    def ordered(tree):
        return {k: ordered(tree[k]) if isinstance(tree[k], dict) else tree[k]
                for k in sorted(tree)}

    return {"params": ordered(params)}


def init_unet_(model: UNet, generator: torch.Generator) -> None:
    """Seeded random weights in place (fan-in scaled normal kernels, zero
    biases, unit norm scales).  The scheme is flax's default, the draws are
    not: a randomly initialised port UNet does not equal a flax one."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator) * fan_in ** -0.5
            m.weight.data.copy_(w)
            m.bias.data.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.data.fill_(1.0)
            m.bias.data.zero_()
