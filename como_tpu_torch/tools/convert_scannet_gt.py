"""Convert ScanNet per-frame pose files (pose/N.txt, 4x4 camera-to-world) to
a TUM trajectory (port of scripts/convert_scannet_gt.py).  Frames whose
pose holds a non-finite value are skipped; a frame keeps its timestamp
index / 30.

    python -m como_tpu_torch.tools.convert_scannet_gt --dataset_dir DIR [--out FILE]

numpy only; needs no device.  The default --out is DIR/gt_traj_tum.txt.
"""

from __future__ import annotations

import argparse
import glob
import os
import re

import numpy as np

from como_tpu_torch.utils.io import save_traj


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    files = sorted(glob.glob(os.path.join(args.dataset_dir, "pose", "*.txt")),
                   key=lambda x: int(re.findall(r"\d+", os.path.basename(x))[0]))
    poses, ts = [], []
    for i, f in enumerate(files):
        T = np.loadtxt(f)
        if not np.all(np.isfinite(T)):
            continue
        poses.append(T)
        ts.append(i / 30.0)
    out = args.out or os.path.join(args.dataset_dir, "gt_traj_tum.txt")
    save_traj(out, np.array(ts), np.stack(poses))
    print(f"{len(poses)} poses -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
