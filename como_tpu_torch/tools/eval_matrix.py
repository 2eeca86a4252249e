"""Accuracy matrix of the port at full size: scene x seed x prior (port of
scripts/eval_matrix.py).

Every cell runs ComoSeq on a synthetic sequence (192x256, the default 9 KF /
24 OW window, 64 anchors, step 0.012) end to end and reports the
scale-aligned ATE RMSE, frames tracked and keyframes.  No timing columns, as
in the JAX script: throughput is python -m como_tpu_torch.bench's.  One JSON
row per cell goes to stdout, then the summary table; the rows, each with the
card line under "device", land in --out (default
results/torch_eval_matrix.json; results/eval_matrix.json is the JAX
package's and is never written here).

    python -m como_tpu_torch.tools.eval_matrix --frames 120 --seeds 0 1 2

`prior: unet` reads models/depthcov.msgpack with the port's own msgpack
reader.  Runs on the card unless --device cpu is given (full size takes
minutes per frame on the CPU); without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import os

from como_tpu_torch.tools.common import card_line, engine_ate, path_length, tool_device


def run_cell(scene: str, seed: int, prior: str, model: str, frames: int, img,
             device="cuda") -> dict:
    """One cell: ComoConfig() at `img` with `prior`, on `frames` frames of
    the synthetic `scene`."""
    from como_tpu_torch.config import ComoConfig
    from como_tpu_torch.data.synthetic import SyntheticDataset
    from como_tpu_torch.runtime.seq import ComoSeq

    img = tuple(img)
    cfg = ComoConfig()
    cfg.img_size = list(img)
    cfg.mapping.prior = prior
    cfg.mapping.model_path = model if prior == "unet" else ""
    cfg.validate()
    ds = SyntheticDataset(n_frames=frames, img_size=img, seed=seed, step=0.012, scene=scene,
                          device=device)
    eng = ComoSeq(cfg, ds.intrinsics, img, device=device)
    eng.setup()
    for i in range(len(ds)):
        ts, rgb = ds[i]
        eng.step(float(ts), rgb)
    eng.finish()
    return dict(scene=scene, seed=seed, prior=prior, ate_cm=100.0 * engine_ate(eng, ds.poses),
                frames_tracked=len(eng.timestamps), num_kf=eng.mapping.num_kf,
                path_len_m=path_length(ds.poses))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--img", type=int, nargs=2, default=[192, 256])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--scenes", nargs="+", default=["plane", "clutter"])
    p.add_argument("--priors", nargs="+", default=["analytic", "unet"])
    p.add_argument("--model", default="models/depthcov.msgpack")
    p.add_argument("--out", default="results/torch_eval_matrix.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = tool_device(args.device)
    card = card_line(dev)
    img = tuple(args.img)
    rows = []
    for scene in args.scenes:
        for prior in args.priors:
            for seed in args.seeds:
                r = run_cell(scene, seed, prior, args.model, args.frames, img, dev)
                r["device"] = card
                rows.append(r)
                print(json.dumps(r), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)

    # summary table: scene x prior -> mean ATE over seeds
    print("\nscene      prior     mean_ate_cm  per-seed")
    for scene in args.scenes:
        for prior in args.priors:
            ates = [r["ate_cm"] for r in rows if r["scene"] == scene and r["prior"] == prior]
            per = " / ".join(f"{a:.1f}" for a in ates)
            print(f"{scene:<10} {prior:<9} {sum(ates) / len(ates):>8.2f}    {per}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
