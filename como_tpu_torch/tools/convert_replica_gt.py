"""Convert Replica ground-truth poses (traj.txt: 16 floats per row) to a TUM
trajectory for ATE evaluation (port of scripts/convert_replica_gt.py).

    python -m como_tpu_torch.tools.convert_replica_gt --dataset_dir DIR [--out FILE]

numpy only; needs no device.  The default --out is DIR/gt_traj_tum.txt.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from como_tpu_torch.utils.io import save_traj


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    traj = np.loadtxt(os.path.join(args.dataset_dir, "traj.txt"))
    poses = traj.reshape(-1, 4, 4)
    ts = np.arange(len(poses)) / 30.0
    out = args.out or os.path.join(args.dataset_dir, "gt_traj_tum.txt")
    save_traj(out, ts, poses)
    print(f"{len(poses)} poses -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
