"""Stage -> device placement for the two-stage SLAM pipeline (port of
como_tpu/runtime/placement.py).

The reference runs tracking and mapping on different CUDA devices
(config/como.yml "device: cuda:0 / cuda:1") with explicit tensor transfers
at the stage boundary.  Here each stage's tensors live on its own torch
device and stage-boundary messages cross through `tree_device_put`.

The engine's `device` argument fixes the device *type* ("cuda" unless the
caller asks for "cpu").  The config's per-stage specs
(`tracking.device`, `mapping.device`: "platform:index") give the *index*
on that type, whatever platform they name: "tpu:1", "gpu:1" and "cuda:1"
all mean index 1, so the configs of the JAX package and of the reference
load unchanged.  An index beyond the number of CUDA devices shares device
0 with a warning (a one-GPU host runs a cuda:0 / cuda:1 config unchanged;
the two stages then share the card but keep their separate dispatches).
Nothing here resolves a CUDA engine to the CPU: without a CUDA device it
raises.  A `device` that carries an index itself ("cuda:1") is refused:
the index is the stage specs' to give.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Optional

import torch

log = logging.getLogger(__name__)

_PLATFORMS = ("tpu", "gpu", "cuda", "cpu")


def spec_index(spec: Optional[str]) -> int:
    """The device index a stage spec names ("" / "default" / None -> 0)."""
    if not spec or spec == "default":
        return 0
    platform, _, idx_s = spec.partition(":")
    if platform not in _PLATFORMS:
        raise ValueError(f"device spec '{spec}': unknown platform '{platform}'")
    idx = int(idx_s) if idx_s else 0
    if idx < 0:
        raise ValueError(f"device spec '{spec}': negative index")
    return idx


def resolve_device(spec: Optional[str], device="cuda") -> torch.device:
    """Stage spec -> torch.device of the engine's device type."""
    base = torch.device(device)
    idx = spec_index(spec)
    if base.type == "cpu":
        return torch.device("cpu")
    if base.type != "cuda" or base.index is not None:
        raise ValueError(f"unsupported engine device '{device}': 'cuda' or 'cpu' "
                         "(the stage specs give the index)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    n = torch.cuda.device_count()
    if idx >= n:
        log.warning("device '%s' out of range (%d available); using cuda:0", spec, n)
        idx = 0
    return torch.device("cuda", idx)


def resolve_stage_devices(track_spec: Optional[str], map_spec: Optional[str],
                          device="cuda"):
    """(tracking device, mapping device).  The same index gives the same
    device: one device, the fused per-frame dispatch."""
    return resolve_device(track_spec, device), resolve_device(map_spec, device)


def tree_device_put(tree: Any, device: torch.device) -> Any:
    """Move every tensor leaf of a (nested) tuple / list to `device`.

    A tensor already there is returned as it is (no copy).  Host-side
    leaves (floats, strings, lists of timestamps, numpy arrays) pass
    through untouched: queue messages mix tensors with metadata.
    """
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple):
        return tuple(tree_device_put(x, device) for x in tree)
    if isinstance(tree, list):
        return [tree_device_put(x, device) for x in tree]
    return tree


def device_scope(device: torch.device):
    """Context manager making `device` the current CUDA device of this
    thread (a no-op for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
