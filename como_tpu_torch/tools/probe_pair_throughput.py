"""One two-frame dispatch against two single-frame dispatches (port of
scripts/probe_pair_throughput.py): does ComoSeq._dispatch_pair (fused_pair:
two frames tracked + two GN iterations) serve frames faster than
_dispatch_fused (fused_frame: one frame + one GN iteration)?

An engine (dispatch_depth 2) first runs --frames clutter frames to build a
real window; then bursts of --n dispatches of each kind run back to back
with one synchronize at the end of each burst, and the frames per second of
each of --reps bursts are reported with the best of each kind.  The text
lines are the JAX script's; a last line holds the same numbers as one JSON
object.

    python -m como_tpu_torch.tools.probe_pair_throughput --n 30 --reps 5

Runs on the card unless --device cpu is given; without a CUDA device it
raises.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

from como_tpu_torch.tools.common import card_line, synchronize, tool_device

IMG = (192, 256)


def probe_engine(frames: int, img, device, base_cfg=None):
    """(engine, last frame on its tracking device): ComoSeq (dispatch_depth 2)
    after `frames` frames of the clutter world (seed 0, step 0.012)."""
    from como_tpu_torch.config import ComoConfig
    from como_tpu_torch.data.synthetic import SyntheticDataset
    from como_tpu_torch.runtime.seq import ComoSeq, frame_tensor

    cfg = copy.deepcopy(base_cfg) if base_cfg is not None else ComoConfig()
    cfg.img_size = list(img)
    cfg.dispatch_depth = 2
    cfg.validate()
    ds = SyntheticDataset(n_frames=frames, img_size=tuple(img), seed=0, step=0.012,
                          scene="clutter", device=device)
    eng = ComoSeq(cfg, ds.intrinsics, tuple(img), device=device)
    eng.setup()
    for i in range(frames):
        ts, rgb = ds[i]
        eng.step(float(ts), rgb)
    eng.finish()
    if not eng.mapping.is_init:
        raise RuntimeError(f"the probe engine did not bootstrap in {frames} frames")
    return eng, frame_tensor(ds[frames - 1][1], eng.track_dev)


def burst_single(eng, rgb, n: int) -> float:
    """Frames per second of n back-to-back _dispatch_fused calls."""
    synchronize(eng.track_dev)
    t0 = time.perf_counter()
    for k in range(n):
        eng._dispatch_fused(float(1000 + k), rgb)
    synchronize(eng.track_dev)
    return n / (time.perf_counter() - t0)


def burst_pair(eng, rgb, n: int) -> float:
    """Frames per second of n back-to-back _dispatch_pair calls (2 frames each)."""
    synchronize(eng.track_dev)
    t0 = time.perf_counter()
    for k in range(n):
        eng._dispatch_pair(float(2000 + 2 * k), rgb, float(2001 + 2 * k), rgb)
    synchronize(eng.track_dev)
    return 2 * n / (time.perf_counter() - t0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=30, help="dispatches per burst")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--frames", type=int, default=40,
                   help="frames the engine runs before the bursts")
    p.add_argument("--img", type=int, nargs=2, default=list(IMG))
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = tool_device(args.device)
    eng, rgb = probe_engine(args.frames, tuple(args.img), dev)
    burst_single(eng, rgb, 4)     # first calls
    burst_pair(eng, rgb, 4)
    singles = [burst_single(eng, rgb, args.n) for _ in range(args.reps)]
    pairs = [burst_pair(eng, rgb, args.n) for _ in range(args.reps)]

    def fmt(xs):
        return " ".join(f"{x:6.1f}" for x in xs)

    print(f"single-frame programs: {fmt(singles)}  best {max(singles):.1f} frames/s")
    print(f"two-frame programs:    {fmt(pairs)}  best {max(pairs):.1f} frames/s")
    print(f"pair/single best ratio: {max(pairs) / max(singles):.2f}x")
    print(json.dumps(dict(single_fps=singles, pair_fps=pairs, best_single_fps=max(singles),
                          best_pair_fps=max(pairs), pair_over_single=max(pairs) / max(singles),
                          n=args.n, reps=args.reps, frames=args.frames,
                          card=card_line(dev))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
