"""Full-size end-to-end run of the port (port of scripts/run_full_tpu.py):
192x256, 9-KF window, a synthetic sequence with ground truth -> warm-up
seconds, steady-state FPS after frame 20, latency per resolved frame,
keyframes and scale-aligned ATE.

    python -m como_tpu_torch.tools.run_full --frames 150

The flags are the JAX script's, with the same names and the same mapping
onto the config, plus --device, so a sweep recipe written for the JAX
script (scripts/r4_sweep*.sh) runs against the port by changing only the
script path.  The text lines are the JAX script's; a last line holds the
same numbers as one JSON object.  --log writes the engine's events and,
at the end, the spans of the run and their summary to one jsonl file.
Runs on the card unless --device cpu is given; without a CUDA device it
raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from como_tpu_torch.tools.common import (card_line, device_name, engine_ate, render_frames,
                                         timed_frames, tool_device)
from como_tpu_torch.utils.profiling import RECORDER, write_log

WARM = 20        # frames 0..20 include the first calls; the clock restarts after


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--img", type=int, nargs=2, default=[192, 256])
    p.add_argument("--runtime", default="seq", choices=["seq", "pipeline"])
    p.add_argument("--step", type=float, default=0.012)
    p.add_argument("--scene", default="plane",
                   choices=["plane", "clutter", "plane_chroma", "plane_photo",
                            "clutter_chroma", "clutter_photo"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prior", default=None, choices=[None, "analytic", "unet"])
    p.add_argument("--lag", type=int, default=None,
                   help="dispatch depth (cfg.dispatch_depth)")
    p.add_argument("--stride", type=int, default=None,
                   help="burst decision resolution (cfg.resolve_stride)")
    p.add_argument("--batch", type=int, default=None,
                   help="frames per fused dispatch (cfg.frame_batch)")
    p.add_argument("--model", default=None,
                   help="msgpack UNet weights (with --prior unet)")
    p.add_argument("--log", default=None,
                   help="jsonl path of the events, spans and span summary")
    # keyframing sweep knobs (tracking.keyframing)
    p.add_argument("--kf_ratio", type=float, default=None,
                   help="kf_depth_motion_ratio")
    p.add_argument("--rot_weight", type=float, default=None,
                   help="kf_rot_weight (rotation-aware motion criterion)")
    p.add_argument("--rot_mode", default=None, choices=["sum", "max"],
                   help="kf_rot_mode: how the rotation term combines with "
                        "translation in the keyframe criterion")
    p.add_argument("--stat_ema", type=float, default=None,
                   help="EMA factor on the decision median depth")
    p.add_argument("--one_way_freq", type=int, default=None)
    p.add_argument("--kf_pixels_frac", type=float, default=None,
                   help="kf_num_pixels_frac (coverage trigger)")
    p.add_argument("--motion", action="store_true",
                   help="constant-velocity motion model (use_motion_model)")
    p.add_argument("--promote", action="store_true",
                   help="kf_promote_latest: insert the newest dispatched "
                        "frame when a keyframe decision fires")
    p.add_argument("--anticipate", type=int, default=None,
                   help="kf_anticipate: extrapolate the keyframe motion "
                        "criterion N frames ahead (dispatch-lag aware)")
    p.add_argument("--radius", type=float, default=None,
                   help="photo_construction.radius_thresh (covisibility "
                        "radius edges; needs --degrees too)")
    p.add_argument("--degrees", type=float, default=None,
                   help="photo_construction.degrees_thresh")
    p.add_argument("--prerender", action="store_true",
                   help="render all frames up front (input acquisition off "
                        "the clock)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def make_config(args):
    """ComoConfig() with the flags applied, as the JAX script applies them."""
    from como_tpu_torch.config import ComoConfig

    cfg = ComoConfig()
    cfg.img_size = list(args.img)
    if args.prior:
        cfg.mapping.prior = args.prior
    if args.model:
        cfg.mapping.model_path = args.model
    if args.lag is not None:
        cfg.dispatch_depth = args.lag
    if args.stride is not None:
        cfg.resolve_stride = args.stride
    if args.batch is not None:
        cfg.frame_batch = args.batch
        if args.batch == 2 and args.lag is None:
            cfg.dispatch_depth = max(2, cfg.dispatch_depth)
    kf = cfg.tracking.keyframing
    if args.kf_ratio is not None:
        kf.kf_depth_motion_ratio = args.kf_ratio
    if args.rot_weight is not None:
        kf.kf_rot_weight = args.rot_weight
    if args.rot_mode is not None:
        kf.kf_rot_mode = args.rot_mode
    if args.stat_ema is not None:
        kf.stat_ema = args.stat_ema
    if args.one_way_freq is not None:
        kf.one_way_freq = args.one_way_freq
    if args.kf_pixels_frac is not None:
        kf.kf_num_pixels_frac = args.kf_pixels_frac
    if args.motion:
        cfg.tracking.use_motion_model = True
    if args.promote:
        kf.kf_promote_latest = True
    if args.anticipate is not None:
        kf.kf_anticipate = args.anticipate
    if args.radius is not None:
        cfg.mapping.photo_construction.radius_thresh = args.radius
    if args.degrees is not None:
        cfg.mapping.photo_construction.degrees_thresh = args.degrees
    return cfg.validate()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = tool_device(args.device)
    from como_tpu_torch.data.synthetic import SyntheticDataset

    img = tuple(args.img)
    cfg = make_config(args)
    ds = SyntheticDataset(n_frames=args.frames, img_size=img, seed=args.seed, step=args.step,
                          scene=args.scene, device=dev)
    if args.runtime == "seq":
        from como_tpu_torch.runtime.seq import ComoSeq as Engine
    else:
        from como_tpu_torch.runtime.pipeline import ComoPipeline as Engine
    eng = Engine(cfg, ds.intrinsics, img, device=dev)
    eng.setup()
    if args.log and hasattr(eng, "log"):
        from como_tpu_torch.utils.log import EventLog
        eng.log = EventLog(args.log)

    print(f"device: {device_name(dev)}  frames: {len(ds)}  img: {img}", flush=True)
    frames = (render_frames(ds, dev) if args.prerender
              else (ds[i] for i in range(len(ds))))
    mark = RECORDER.mark()
    steady, lat, warm = timed_frames(eng, frames, WARM)
    if hasattr(eng, "log"):
        if args.log:
            write_log(eng.log, mark)
        eng.log.close()
    fps = (len(ds) - WARM - 1) / steady
    lat = np.array(lat if lat else [0.0]) * 1000
    ate = engine_ate(eng, ds.poses)
    m = eng.mapping

    print(f"warmup({WARM + 1} frames incl. first calls): {warm:.1f}s")
    print(f"steady-state: {fps:.1f} FPS  "
          f"(median {np.median(lat):.1f} ms, p90 {np.percentile(lat, 90):.1f} ms)")
    print(f"num keyframes: {m.num_kf}  one-way: {m.num_ow}")
    print(f"ATE RMSE (scale-aligned): {ate * 100:.2f} cm")
    print(json.dumps(dict(frames=len(ds), img=list(img), runtime=args.runtime, scene=args.scene,
                          seed=args.seed, warmup_s=warm, fps=fps,
                          median_ms=float(np.median(lat)),
                          p90_ms=float(np.percentile(lat, 90)),
                          frames_tracked=len(eng.timestamps), num_kf=m.num_kf,
                          num_ow=m.num_ow, ate_m=ate, card=card_line(dev))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
