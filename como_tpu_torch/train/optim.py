"""The trainer's optimizer: optax.chain(clip_by_global_norm(1.0),
adam(cosine_decay_schedule(lr, steps, alpha=0.03))) and the EMA of the
parameters (scripts/train_depthcov.py:233-236, :251-255), on
torch.optim.Adam.

  * clipping: g <- g * min(1, max_norm / ||g||) with ||g|| the global L2
    norm over every gradient (optax's rule; not clip_grad_norm_'s
    max_norm / (||g|| + 1e-6)), on the device, without a host sync;
  * Adam: b1 0.9, b2 0.999, eps 1e-8 outside the root (optax's eps_root 0);
  * the learning rate of update k (k = 0 for the first) is
    cosine_decay_schedule(lr, steps, alpha)(k), optax's count;
  * EMA: ema <- decay * ema + (1 - decay) * params in f32, after each
    update.
Parameters without a gradient (the UNet's unused coarse heads) get a zero
gradient, as JAX's tree has, so Adam's state and count advance for every
leaf alike.
"""

from __future__ import annotations

import math

import torch

CLIP_NORM = 1.0
COSINE_ALPHA = 0.03
EMA_DECAY = 0.999


def cosine_decay(lr: float, steps: int, alpha: float = COSINE_ALPHA):
    """optax.cosine_decay_schedule(lr, steps, alpha): count -> rate."""
    if not steps > 0:
        raise ValueError(f"cosine decay needs positive steps, got {steps}")

    def schedule(count: int) -> float:
        c = min(count, steps)
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / steps)) + alpha)

    return schedule


def clip_by_global_norm_(grads, max_norm: float = CLIP_NORM) -> torch.Tensor:
    """Scale the gradients in place by min(1, max_norm / ||g||); returns
    ||g|| (a device scalar, before clipping)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))
    return norm


class Trainer:
    """clip -> Adam at the cosine rate -> EMA over `params` (a list of f32
    tensors that require grad).  `ema`: tensors of the same shapes to keep
    the EMA in (another model's parameters, say), set to the parameters
    here; by default clones."""

    def __init__(self, params, lr: float, steps: int, ema=None, ema_decay: float = EMA_DECAY,
                 max_norm: float = CLIP_NORM, alpha: float = COSINE_ALPHA):
        self.params = list(params)
        self.schedule = cosine_decay(lr, steps, alpha)
        self.opt = torch.optim.Adam(self.params, lr=self.schedule(0), betas=(0.9, 0.999),
                                    eps=1e-8)
        with torch.no_grad():
            if ema is None:
                self.ema = [p.detach().clone() for p in self.params]
            else:
                self.ema = [e.detach() for e in ema]
                torch._foreach_copy_(self.ema, [p.detach() for p in self.params])
        self.ema_decay, self.max_norm = ema_decay, max_norm
        self.count = 0

    def step(self) -> torch.Tensor:
        """One update from the parameters' .grad; returns the gradient's
        global norm before clipping (a device scalar)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = clip_by_global_norm_(grads, self.max_norm)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
        with torch.no_grad():
            torch._foreach_mul_(self.ema, self.ema_decay)
            torch._foreach_add_(self.ema, self.params, alpha=1.0 - self.ema_decay)
        return norm
