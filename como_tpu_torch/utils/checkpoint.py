"""SLAM-state snapshot / resume (port of como_tpu/utils/checkpoint.py).

The whole sliding-window state plus the host bookkeeping goes into one
file, so a run can be stopped and resumed mid-sequence.  The layout is
the JAX package's: an 8-byte little-endian length, a JSON header with the
bookkeeping, then the window's fields as a flax-style msgpack map
(utils/flax_msgpack.py), integer fields as int32.  A snapshot written by
either package loads in the other.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from como_tpu_torch.odom import window as win
from como_tpu_torch.utils import flax_msgpack


def save_mapping_state(mapping, path: str) -> None:
    """Snapshot a Mapping object's device state + host bookkeeping."""
    fields = win.state_to_numpy(mapping.state)
    for k, a in fields.items():
        if np.issubdtype(a.dtype, np.integer):
            fields[k] = a.astype(np.int32)
    meta = dict(
        kf_ts=mapping.kf_ts, ow_ts=mapping.ow_ts,
        num_kf=mapping.num_kf, num_ow=mapping.num_ow,
        anchor_lm=mapping.anchor_lm_host.tolist(),
        alloc_valid=mapping.alloc.valid.tolist(),
        alloc_free=mapping.alloc.free,
        is_init=mapping.is_init,
    )
    header = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(flax_msgpack.packb(fields))


def load_mapping_state(mapping, path: str, device="cuda") -> None:
    """Restore a snapshot into a set-up Mapping object (same config).  The
    state goes to the mapping's own device, and `device` must be of its
    kind: a snapshot is not quietly restored onto the CPU."""
    if torch.device(device).type != mapping.device.type:
        raise ValueError(f"load_mapping_state(device={device!r}) into a Mapping on "
                         f"{mapping.device}")
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        fields = flax_msgpack.unpackb(f.read())
    want = set(mapping.state.fields())
    if set(fields) != want:
        raise ValueError("snapshot fields differ from the window state's: "
                         f"{sorted(set(fields) ^ want)}")
    for name in want:
        if tuple(fields[name].shape) != tuple(getattr(mapping.state, name).shape):
            raise ValueError(f"snapshot field '{name}' has shape {fields[name].shape}, "
                             f"the window {tuple(getattr(mapping.state, name).shape)}: "
                             "the snapshot was taken with another config")
    mapping.state = win.state_from_numpy(fields, mapping.device)
    mapping.kf_ts = list(meta["kf_ts"])
    mapping.ow_ts = list(meta["ow_ts"])
    mapping.num_kf = int(meta["num_kf"])
    mapping.num_ow = int(meta["num_ow"])
    mapping.anchor_lm_host = np.array(meta["anchor_lm"], np.int64)
    mapping.alloc.valid = np.array(meta["alloc_valid"], bool)
    mapping.alloc.free = list(meta["alloc_free"])
    mapping.is_init = bool(meta["is_init"])
    if mapping.is_init:
        mapping._rebuild_pairs()
