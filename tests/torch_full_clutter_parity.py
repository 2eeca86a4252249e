"""Full-size parity and accuracy runs, by hand (not collected by pytest:
each engine run takes minutes).

    JAX_PLATFORMS=cpu python tests/torch_full_clutter_parity.py [--frames 120]
    python tests/torch_full_clutter_parity.py --engines torch \
        --seeds 0 1 2 [--plain-kernels]
    python tests/torch_full_clutter_parity.py --engines torch --scene plane \
        --frames 25 --step 0.012 --seeds 0 1 [--plain-kernels]

Runs como_tpu's ComoSeq (CPU) and/or como_tpu_torch's ComoSeq on the same
SyntheticDataset frames (clutter unless --scene says plane) at the default
config (configs/como.yml, 192x256) and prints one JSON line per seed with
each engine's tracked-frame count, scale-aligned ATE, its keyframe / one-way
insertion sequence and, with both engines, the first insertion where the two
differ.

With only the port (`--engines torch`) the frames come from the port's own
renderer and JAX is never imported, so the script runs on a machine without
JAX; it then runs on the card unless --device cpu is given (with the JAX
engine everything runs on the CPU).  `--plain-kernels` makes the two CUDA
kernels' wrappers compute their plain PyTorch versions on the card instead
(a diagnostic: it tells a kernel's effect on the trajectory from f32
rounding elsewhere).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _inserts(eng):
    return [(e["frame_kind"], round(e["ts"], 4)) for e in eng.log.ring
            if e["kind"] == "insert"]


def _use_plain_kernels():
    from como_tpu_torch.gp import kernels_cuda, sampler_cuda

    kernels_cuda._launch = kernels_cuda.cross_covariance_plain
    sampler_cuda._launch = sampler_cuda.downdate_step_plain


def _engines(names, device, cfg_path, intrinsics):
    for name in names:
        if name == "jax":
            from como_tpu.config import load_config
            from como_tpu.runtime.seq import ComoSeq

            yield name, ComoSeq(load_config(cfg_path), intrinsics, (192, 256))
        else:
            from como_tpu_torch.config import load_config
            from como_tpu_torch.runtime.seq import ComoSeq

            yield name, ComoSeq(load_config(cfg_path), np.asarray(intrinsics),
                                (192, 256), device=device)


def run_seed(seed: int, args) -> dict:
    import torch

    from como_tpu_torch.utils.io import ate_rmse

    names = args.engines.split(",")
    if "jax" in names:
        from como_tpu.data.synthetic import SyntheticDataset
        ds = SyntheticDataset(n_frames=args.frames, img_size=(192, 256), seed=seed,
                              scene=args.scene, step=args.step)
    else:
        from como_tpu_torch.data.synthetic import SyntheticDataset
        ds = SyntheticDataset(n_frames=args.frames, img_size=(192, 256), seed=seed,
                              scene=args.scene, step=args.step, device=args.device)
    frames = [ds[i] for i in range(len(ds))]
    gt = np.asarray(ds.poses)
    intrinsics = ds.intrinsics if "jax" in names else ds.intrinsics.cpu().numpy()
    out = {"scene": args.scene, "frames": args.frames, "step": args.step, "seed": seed,
           "device": args.device, "plain_kernels": args.plain_kernels}
    for name, eng in _engines(names, args.device, str(ROOT / "configs" / "como.yml"),
                              intrinsics):
        eng.setup()
        t = time.perf_counter()
        for ts, rgb in frames:
            eng.step(float(ts), rgb)
        eng.finish()
        if name == "torch" and args.device != "cpu":
            torch.cuda.synchronize()
        ts = np.asarray(eng.timestamps)
        est = [np.asarray(p.detach().cpu() if hasattr(p, "detach") else p)
               for p in eng.est_poses]
        idx = (ts * ds.fps).round().astype(int)
        ate = ate_rmse(np.stack(est), gt[idx], with_scale=True) if est else None
        out[name] = dict(seconds=time.perf_counter() - t, frames_tracked=len(ts),
                         ate_m=ate, num_kf=int(eng.mapping.num_kf),
                         num_ow=int(eng.mapping.num_ow), inserts=_inserts(eng))
    if len(names) == 2:
        a, b = out["jax"]["inserts"], out["torch"]["inserts"]
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        out["first_divergent_insert"] = None if first is None else {
            "index": first, "jax": a[first], "torch": b[first]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--engines", default="jax,torch", choices=["jax,torch", "torch"])
    ap.add_argument("--device", default=None,
                    help="cpu with the JAX engine; cuda with --engines torch")
    ap.add_argument("--scene", default="clutter", choices=["clutter", "plane"])
    ap.add_argument("--step", type=float, default=0.02, help="camera step per frame")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--plain-kernels", action="store_true")
    args = ap.parse_args()
    if args.device is None:
        args.device = "cuda" if args.engines == "torch" else "cpu"
    if args.engines != "torch" and args.device != "cpu":
        ap.error("the JAX engine runs on the CPU: compare with --device cpu")
    if args.engines != "torch":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(args.threads)
    if args.plain_kernels:
        _use_plain_kernels()
    for seed in args.seeds:
        print(json.dumps(run_seed(seed, args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
