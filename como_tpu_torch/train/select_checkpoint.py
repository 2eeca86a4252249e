"""End-to-end checkpoint selection for the DepthCov prior (port of
scripts/select_checkpoint.py).

Neither proxy score (extrapolation mse, mse + nll) predicts the end-to-end
ATE, so the selector runs the product: short SLAM sequences with the
candidate prior, scored by the WORST ratio of per-world mean ATE against
the analytic prior over held-out worlds (lower is better; <= 1.0 means the
candidate wins or ties every world).  Ratios, so the easy world (plane)
and the hard one (clutter) weigh alike.

    python -m como_tpu_torch.train.select_checkpoint models/*.msgpack [--device cuda]

One candidate costs len(EVAL_WORLDS) x 2 runs of `frames` frames (about
4 x 60 frames at about 1 s per frame on an H100 with the eager engine).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

# held-out worlds: every seed lies above the training pool's scene seeds
# 0-11 (train/data.py), two per world, scored as a ratio of per-world means
EVAL_WORLDS = (("clutter", (13, 16)), ("plane", (14, 17)))
# scored at the product resolution: smaller evaluations cannot see the
# full-size plane failure of a prior trained at one scale
DEFAULT_IMG = (192, 256)


def run_slam(prior: str, model_path: str, scene: str, seed: int, frames: int = 60,
             img=DEFAULT_IMG, device="cuda", config=None) -> float:
    """One short deterministic SLAM run (ComoSeq); the scale-aligned ATE
    (m).  `config`: a function that edits the ComoConfig before it is
    validated (the tests shrink the window with it)."""
    from como_tpu_torch.config import ComoConfig
    from como_tpu_torch.data.synthetic import SyntheticDataset
    from como_tpu_torch.runtime.seq import ComoSeq
    from como_tpu_torch.utils.io import ate_rmse

    cfg = ComoConfig()
    cfg.img_size = list(img)
    cfg.mapping.prior = prior
    cfg.mapping.model_path = model_path or ""
    if config is not None:
        config(cfg)
    cfg.validate()
    ds = SyntheticDataset(n_frames=frames, img_size=tuple(img), seed=seed, step=0.012,
                          scene=scene, device=device)
    eng = ComoSeq(cfg, ds.intrinsics, tuple(img), device=device)
    eng.setup()
    ts, est = eng.run(ds)
    idx = (np.asarray(ts) * ds.fps).round().astype(int)
    return float(ate_rmse(est, np.asarray(ds.poses)[idx], with_scale=True))


class E2EScorer:
    """Scores candidate UNet parameters by short SLAM runs against the
    analytic baseline (run once).  `worlds`: ((scene, seeds), ...)."""

    def __init__(self, frames: int = 60, img=DEFAULT_IMG, verbose: bool = True,
                 device="cuda", config=None, worlds=EVAL_WORLDS):
        self.frames, self.img, self.verbose = frames, tuple(img), verbose
        self.device, self.config, self.worlds = device, config, worlds
        self.baselines = None

    def _run(self, prior, path, scene, seed):
        return run_slam(prior, path, scene, seed, self.frames, self.img, self.device,
                        self.config)

    def _ensure_baselines(self):
        if self.baselines is None:
            self.baselines = {s: sum(self._run("analytic", "", s, sd) for sd in seeds)
                              / len(seeds) for s, seeds in self.worlds}
            if self.verbose:
                base = " ".join(f"{s}={a * 100:.2f}cm" for s, a in self.baselines.items())
                print(f"[e2e-select] analytic baselines (per-world mean): {base}", flush=True)

    def score_path(self, model_path: str):
        """-> (worst_ratio, {world: (mean_ate_m, ratio)})"""
        self._ensure_baselines()
        detail = {}
        for s, seeds in self.worlds:
            ate = sum(self._run("unet", model_path, s, sd) for sd in seeds) / len(seeds)
            detail[s] = (ate, ate / self.baselines[s])
        worst = max(r for _, r in detail.values())
        if self.verbose:
            tag = " ".join(f"{k}={a * 100:.2f}cm({r:.2f}x)" for k, (a, r) in detail.items())
            print(f"[e2e-select] {os.path.basename(model_path)}: worst {worst:.2f}x  {tag}",
                  flush=True)
        return worst, detail

    def score_state_dict(self, state_dict):
        """Score in-memory UNet parameters (the training loop) through a
        temporary msgpack, so the scored file is the one that would ship."""
        from como_tpu_torch.net.depthcov import save_params

        fd, tmp = tempfile.mkstemp(suffix=".msgpack")
        os.close(fd)
        try:
            save_params(state_dict, tmp)
            return self.score_path(tmp)
        finally:
            os.unlink(tmp)


def main(argv=None):
    p = argparse.ArgumentParser(description="Rank DepthCov checkpoints by e2e SLAM ATE.")
    p.add_argument("checkpoints", nargs="+", help="msgpack files to score")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--img", type=int, nargs=2, default=list(DEFAULT_IMG))
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to score on the CPU")
    scorer = E2EScorer(frames=args.frames, img=tuple(args.img), device=args.device)
    rows = sorted(((ck,) + scorer.score_path(ck) for ck in args.checkpoints),
                  key=lambda r: r[1])
    print("\nranked (best first):")
    for ck, worst, _ in rows:
        print(f"  {worst:.3f}x  {ck}")
    return rows


if __name__ == "__main__":
    main()
