"""Train the DepthCov UNet, the learned covariance prior (port of
scripts/train_depthcov.py).

    python -m como_tpu_torch.train.train_depthcov --data synthetic --steps 2000 \
        --out models/depthcov.msgpack [--device cuda]

The JAX script's flags, plus `--device` (default cuda; without a GPU it
raises unless `--device cpu` is given) and `--val_every` (steps between
held-out validations, 250 as in the JAX script).  What one run does:

  * the shipped UNet (5 levels, base 16 channels, bf16 block convolutions
    over f32 parameters), seeded random initialisation
    (torch.Generator().manual_seed(0): flax's scheme, not its draws);
  * per step a batch of one image: a synthetic view (train/data.py) or an
    RGB-D folder sample, at `--img` (96x128) and, with --multires, every
    third step at the product's 192x256;
  * the loss mse + 0.1 nll of train/loss.py, M = 64 anchors and 1024 test
    sites drawn from a torch.Generator on the device seeded by --seed;
  * clip by global norm 1.0, Adam on a cosine decay (alpha 0.03), EMA
    0.999 (train/optim.py);
  * selection: with synthetic data, every --val_every steps the EMA's
    extrapolation mse (nll weight 0) on held-out scenes (plane 101,
    clutter 102, homogeneous plane 103, at both sizes, 2 views each, fixed
    site draws), the mean over world families; the best EMA is saved.
    --select e2e scores the EMA every --select_every steps by short SLAM
    runs against the analytic prior (train/select_checkpoint.py).  Without
    a validation set the final EMA is saved, never the raw parameters;
  * save_params (net/depthcov.py): a flax msgpack checkpoint that either
    package's load_params reads.
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import torch

from como_tpu_torch.net import unet as unet_mod
from como_tpu_torch.net.depthcov import NETWORK_SIZE, save_params
from como_tpu_torch.train.data import RgbdFolder, synthetic_batch
from como_tpu_torch.train.loss import M_ANCHORS, N_TEST, depthcov_loss, draw_sites
from como_tpu_torch.train.optim import Trainer

VAL_SEED = 9999   # the validation's site draws: fixed, so scores compare


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the DepthCov UNet (PyTorch).")
    p.add_argument("--data", default="synthetic", choices=["synthetic", "rgbd"])
    p.add_argument("--dataset_dir", default=None)
    p.add_argument("--depth_scale", type=float, default=None)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--img", type=int, nargs=2, default=[96, 128])
    p.add_argument("--multires", action=argparse.BooleanOptionalAction, default=True,
                   help="every 3rd step at the 192x256 product resolution")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default="models/depthcov.msgpack")
    p.add_argument("--select", default="mse", choices=["mse", "e2e"],
                   help="checkpoint selection: held-out extrapolation MSE or e2e SLAM "
                        "ATE against the analytic prior (train/select_checkpoint.py)")
    p.add_argument("--select_every", type=int, default=500,
                   help="steps between e2e selection evals")
    p.add_argument("--val_every", type=int, default=250,
                   help="steps between held-out validations (--select mse)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    return p


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the trainer runs on the GPU; pass --device cpu "
                           "to train on the CPU")
    return dev


def make_model(device, compute_dtype=torch.bfloat16, seed: int = 0) -> unet_mod.UNet:
    net = unet_mod.UNet(compute_dtype=compute_dtype)
    unet_mod.init_unet_(net, torch.Generator().manual_seed(seed))
    return net.to(device)


def train_step(model, trainer: Trainer, rgb, depth, rc_m, rc_n):
    """One update: loss, backward, clip, Adam, EMA.  Returns (loss,
    gradient norm before clipping), device scalars."""
    trainer.opt.zero_grad(set_to_none=True)
    loss = depthcov_loss(model, rgb, depth, rc_m, rc_n)
    loss.backward()
    return loss.detach(), trainer.step()


def make_val_set(img, device) -> list:
    """Held-out scene instances (seeds outside the training pool), one per
    world family, at the training and the product size, 2 views each:
    [(family, rgb, depth)]."""
    from como_tpu_torch.data.synthetic import ClutterScene, PlaneScene

    out = []
    for size in (tuple(img), NETWORK_SIZE):
        for name, scene in (
                ("plane", PlaneScene(img_size=size, seed=101, device=device)),
                ("clutter", ClutterScene(img_size=size, seed=102, device=device)),
                ("plane_hom", PlaneScene(img_size=size, seed=103, num_waves=6, max_freq=2.0,
                                         device=device))):
            views = np.array(scene.trajectory(4, step=0.04, seed=7))
            for v in views[:2]:
                out.append((name, *scene.render(torch.as_tensor(v, device=device))))
    return out


@torch.no_grad()
def validate(model, val_set, sites: dict):
    """Mean extrapolation mse (nll weight 0) per world family, equally
    weighted: (score, {family: [losses]}).  `sites` maps an image size to
    its fixed (rc_m, rc_n)."""
    per: dict = {}
    for name, rgb, depth in val_set:
        rc_m, rc_n = sites[tuple(rgb.shape[-2:])]
        per.setdefault(name, []).append(
            float(depthcov_loss(model, rgb, depth, rc_m, rc_n, nll_weight=0.0)))
    return sum(np.mean(v) for v in per.values()) / len(per), per


def main(argv=None) -> dict:
    """Train; returns a summary: per-step losses and gradient norms, the
    validations, the selected score and the saved path."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    model = make_model(dev)
    ema_model = copy.deepcopy(model).requires_grad_(False)
    trainer = Trainer(model.parameters(), args.lr, args.steps, ema=ema_model.parameters())

    folder = None
    if args.data == "rgbd":
        if not args.dataset_dir:
            raise ValueError("--data rgbd needs --dataset_dir")
        folder = RgbdFolder(args.dataset_dir, tuple(args.img), depth_scale=args.depth_scale,
                            device=dev)
        print(f"rgbd folder: {len(folder.pairs)} associated pairs")

    # every 3rd step at the product resolution (the UNet is fully
    # convolutional but does not absorb the feature-scale shift by itself)
    sizes = [tuple(args.img)] * 2 + [NETWORK_SIZE if args.multires else tuple(args.img)]
    host_rng = np.random.default_rng(args.seed)
    site_gen = torch.Generator(device=dev).manual_seed(args.seed)
    val_set = make_val_set(args.img, dev) if args.data == "synthetic" else []
    val_gen = torch.Generator(device=dev).manual_seed(VAL_SEED)
    val_sites = {s: draw_sites(val_gen, M_ANCHORS, N_TEST, s)
                 for s in sorted({tuple(args.img), NETWORK_SIZE})}
    scorer = None
    if args.select == "e2e":
        from como_tpu_torch.train.select_checkpoint import E2EScorer
        scorer = E2EScorer(device=dev)
    best_score, best_state = float("inf"), None
    losses, norms, vals = [], [], []
    t0 = time.perf_counter()
    for step in range(args.steps):
        size = sizes[step % len(sizes)]
        if folder is None:
            rgb, depth = synthetic_batch(host_rng, size, device=dev)
        else:
            rgb, depth = folder.sample(host_rng)
        rc_m, rc_n = draw_sites(site_gen, M_ANCHORS, N_TEST, size)
        loss, norm = train_step(model, trainer, rgb, depth, rc_m, rc_n)
        losses.append(loss)
        norms.append(norm)
        if step % 50 == 0:
            print(f"step {step}: loss {float(loss):.4f}", flush=True)
        if scorer is not None and (step + 1) % args.select_every == 0:
            score, _ = scorer.score_state_dict(ema_model.state_dict())
            if score < best_score:
                best_score = score
                best_state = {k: v.clone() for k, v in ema_model.state_dict().items()}
                print(f"  new best (e2e worst-ratio {score:.3f}x)", flush=True)
        elif val_set and scorer is None and (step + 1) % args.val_every == 0:
            score, per = validate(ema_model, val_set, val_sites)
            vals.append(dict(step=step, score=score, per={k: float(np.mean(v))
                                                          for k, v in per.items()}))
            tag = " ".join(f"{k}={np.mean(v):.3f}" for k, v in per.items())
            print(f"step {step}: val {score:.4f} ({tag})", flush=True)
            if score < best_score:
                best_score = score
                best_state = {k: v.clone() for k, v in ema_model.state_dict().items()}
                print(f"  new best (val {score:.4f})", flush=True)
    seconds = time.perf_counter() - t0

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if best_state is not None:
        save_params(best_state, args.out)
        selected = args.select
        print(f"saved -> {args.out} ({args.select}-selected EMA, score {best_score:.4f})")
    else:
        # no validation: the spiky GP loss makes the raw last-step
        # parameters a known-bad checkpoint, so the EMA it is
        save_params(ema_model, args.out)
        selected = "final_ema"
        print(f"saved -> {args.out} (no val set: final EMA params, NOT val-selected)")
    return dict(device=str(dev), steps=args.steps, sizes=[list(s) for s in sizes],
                losses=[float(v) for v in losses], grad_norms=[float(v) for v in norms],
                validations=vals, best_score=best_score if best_state is not None else None,
                selected=selected, out=args.out, seconds=seconds)


if __name__ == "__main__":
    main()
