"""Per-phase breakdown of the sequential engine (port of
scripts/profile_e2e.py): reads eleven of ComoSeq's internal phases from
the spans the engine records (utils/profiling.py's RECORDER) and reports
count / total / median / p90 / max per phase over a full-size run, after
--warmup frames, beside the frame wall times.

    python -m como_tpu_torch.tools.profile_e2e --frames 120

As in the JAX script's timers, every span reads host wall time.  In eager
PyTorch that is the time the phase takes to launch its kernels plus any
read-back to the host inside the call (a decision's stats, a keyframe
insertion's counts), not the device time of its work, which may run
later.  The text lines are the JAX script's; a last line holds the same
numbers as one JSON object.  Runs on the card unless --device cpu is
given; without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from como_tpu_torch.tools.common import (card_line, device_name, end_run, render_frames,
                                         tool_device)

# (engine attribute or "" for the engine itself, method, label): the phases
# the JAX script wraps, under its labels
PHASES = (
    ("", "_dispatch_fused", "_dispatch_fused"),
    ("", "_dispatch_pair", "_dispatch_pair"),
    ("", "_resolve_one", "_resolve_one"),
    ("", "_refresh_reference", "_refresh_reference"),
    ("tracking", "dispatch_frame", "tracking.dispatch_frame"),
    ("tracking", "decide", "tracking.decide"),
    ("tracking", "update_kf_reference", "tracking.update_kf_ref"),
    ("mapping", "handle_tracking_data", "mapping.insert"),
    ("mapping", "add_keyframe", "mapping.add_keyframe"),
    ("mapping", "add_one_way_frame", "mapping.add_one_way"),
    ("mapping", "get_kf_ref_data", "mapping.get_kf_ref_data"),
)


# {label: the span that method records}
SPANS = {"_dispatch_fused": "runtime.dispatch_fused", "_dispatch_pair": "runtime.dispatch_pair",
         "_resolve_one": "runtime.resolve", "_refresh_reference": "runtime.refresh_reference",
         "tracking.dispatch_frame": "runtime.dispatch_frame",
         "tracking.decide": "tracking.decide",
         "tracking.update_kf_ref": "tracking.update_kf_reference",
         "mapping.insert": "mapping.handle_tracking_data",
         "mapping.add_keyframe": "mapping.add_keyframe",
         "mapping.add_one_way": "mapping.add_one_way_frame",
         "mapping.get_kf_ref_data": "mapping.get_kf_ref_data"}


def profile_run(cfg, ds, device, warmup: int, lag=None, prerender: bool = False):
    """ComoSeq on `ds`, its phases read from the spans it records from the
    step after frame `warmup` on.  Returns ({label: [seconds]}, [frame wall
    seconds])."""
    from como_tpu_torch.runtime.seq import ComoSeq
    from como_tpu_torch.utils.profiling import RECORDER

    eng = ComoSeq(cfg, ds.intrinsics, tuple(cfg.img_size), device=device)
    eng.setup()
    if lag is not None:
        eng.decision_lag = lag
    frames = render_frames(ds, device) if prerender else None
    mark = None
    lat = []
    for i in range(len(ds)):
        ts, rgb = frames[i] if frames is not None else ds[i]
        s = time.perf_counter()
        eng.step(float(ts), rgb)
        dt = time.perf_counter() - s
        if i == warmup:
            mark = RECORDER.mark()
        elif mark is not None:
            lat.append(dt)
    end_run(eng)
    label_of = {span: label for label, span in SPANS.items()}
    acc = {label: [] for _, _, label in PHASES}
    for sp in list(RECORDER.spans):
        if mark is not None and sp.t0 >= mark.t and sp.name in label_of:
            acc[label_of[sp.name]].append((sp.t1 - sp.t0) * 1e-9)
    return acc, lat


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--img", type=int, nargs=2, default=[192, 256])
    p.add_argument("--scene", default="clutter")
    p.add_argument("--warmup", type=int, default=30)
    p.add_argument("--lag", type=int, default=None,
                   help="override engine decision_lag (dispatch depth)")
    p.add_argument("--batch", type=int, default=None,
                   help="frames per fused dispatch (cfg.frame_batch)")
    p.add_argument("--prerender", action="store_true",
                   help="render all frames before the loop")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = tool_device(args.device)
    from como_tpu_torch.config import ComoConfig
    from como_tpu_torch.data.synthetic import SyntheticDataset

    img = tuple(args.img)
    cfg = ComoConfig()
    cfg.img_size = list(img)
    if args.batch is not None:
        cfg.frame_batch = args.batch
        if args.batch == 2:
            cfg.dispatch_depth = max(args.lag or 2, 2)
    cfg.validate()
    ds = SyntheticDataset(n_frames=args.frames, img_size=img, seed=0, step=0.012,
                          scene=args.scene, device=dev)
    acc, lat = profile_run(cfg, ds, dev, args.warmup, args.lag, args.prerender)

    lat_ms = np.array(lat) * 1e3
    print(f"device: {device_name(dev)}  steady frames: {len(lat_ms)}")
    print(f"frame wall: total {lat_ms.sum():8.0f} ms  median "
          f"{np.median(lat_ms):6.1f}  p90 {np.percentile(lat_ms, 90):6.1f}  "
          f"max {lat_ms.max():6.1f}")
    print(f"{'phase':<26}{'n':>5}{'total_ms':>10}{'median':>8}{'p90':>8}{'max':>8}")
    rows = {}
    for k in sorted((k for k in acc if acc[k]), key=lambda k: -sum(acc[k])):
        v = np.array(acc[k]) * 1e3
        rows[k] = dict(n=len(v), total_ms=float(v.sum()), median_ms=float(np.median(v)),
                       p90_ms=float(np.percentile(v, 90)), max_ms=float(v.max()))
        print(f"{k:<26}{len(v):>5}{v.sum():>10.0f}{np.median(v):>8.1f}"
              f"{np.percentile(v, 90):>8.1f}{v.max():>8.1f}")
    print(json.dumps(dict(frames=args.frames, steady_frames=len(lat_ms),
                          frame_ms=dict(total=float(lat_ms.sum()),
                                        median=float(np.median(lat_ms)),
                                        p90=float(np.percentile(lat_ms, 90)),
                                        max=float(lat_ms.max())),
                          phases=rows, card=card_line(dev))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
