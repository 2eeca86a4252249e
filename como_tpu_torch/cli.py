"""Headless CLI entry point (port of como_tpu/cli.py).

    python -m como_tpu_torch.cli --dataset_type tum --dataset_dir .../fr2_desk/
    python -m como_tpu_torch.cli --dataset_type synthetic:clutter \\
        --config configs/como_unet.yml --max_frames 60 --save_traj results

The flags are those of the JAX package's CLI, plus --device (default
"cuda").  Without a CUDA device the run fails unless --device cpu is given;
it does not carry on on the CPU.  --runtime pipeline runs the two stage
threads of runtime/pipeline.py.  --viz attaches the Open3D viewer, or where
open3d is not installed the snapshot viewer, which writes PNGs of the map
to results/viz/ under the working directory (viz/viewer.py).  --log writes
the engine's events and, at the end of the run, the spans it recorded and
their summary (utils/profiling.py::write_log) to one jsonl file.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time


def main(argv=None):
    """Run one sequence; returns the engine (for in-process callers)."""
    p = argparse.ArgumentParser(description="como_tpu_torch odometry")
    p.add_argument("--dataset_type", type=str, required=True,
                   help="tum | replica | scannet | realsense | synthetic[:scene]")
    p.add_argument("--dataset_dir", type=str, default=None)
    p.add_argument("--config", type=str, default=None,
                   help="YAML config overriding defaults (configs/como.yml)")
    p.add_argument("--runtime", type=str, default="seq",
                   choices=["seq", "pipeline"])
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--save_traj", type=str, default="results")
    p.add_argument("--realtime", action="store_true",
                   help="pace frames to dataset timestamps")
    p.add_argument("--viz", action="store_true",
                   help="attach the Open3D viewer (PNG snapshots without open3d)")
    p.add_argument("--profile", type=str, default=None,
                   help="directory for a torch profiler trace (trace.json)")
    p.add_argument("--resume", type=str, default=None,
                   help="mapping-state checkpoint to resume from")
    p.add_argument("--save_state", type=str, default=None,
                   help="write a mapping-state checkpoint at the end")
    p.add_argument("--log", type=str, default=None,
                   help="jsonl path of the events, spans and span summary")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the engine: cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")

    from como_tpu_torch.config import load_config
    from como_tpu_torch.data.datasets import get_dataset
    from como_tpu_torch.runtime.queues import monotonic_now, sleep_until
    from como_tpu_torch.utils import profiling

    if args.runtime == "seq":
        from como_tpu_torch.runtime.seq import ComoSeq as Engine
    else:
        from como_tpu_torch.runtime.pipeline import ComoPipeline as Engine

    cfg = load_config(args.config)
    dataset = get_dataset(args.dataset_type, cfg.img_size, args.dataset_dir,
                          device=args.device)
    eng = Engine(cfg, dataset.intrinsics, cfg.img_size, device=args.device)
    eng.setup()
    if args.log and hasattr(eng, "log"):
        from como_tpu_torch.utils.log import EventLog
        eng.log = EventLog(args.log)
    if args.resume:
        from como_tpu_torch.utils.checkpoint import load_mapping_state
        load_mapping_state(eng.mapping, args.resume, device=args.device)
    if args.viz:
        from como_tpu_torch.viz.viewer import attach_viewer
        attach_viewer(eng)

    n = len(dataset) if args.max_frames is None else min(len(dataset), args.max_frames)
    mark = profiling.RECORDER.mark()
    t_start = time.perf_counter()
    t_pace0 = monotonic_now()
    t0_ts = None
    with profiling.trace(args.profile) if args.profile else contextlib.nullcontext():
        for i in range(n):
            ts, rgb = dataset[i]
            ts = float(ts)
            if args.realtime and not dataset.is_live:
                t0_ts = ts if t0_ts is None else t0_ts
                # absolute-deadline pacing: no per-frame drift accumulation
                sleep_until(t_pace0 + (ts - t0_ts))
            eng.step(ts, rgb)
        if hasattr(eng, "finish"):
            eng.finish()
        if hasattr(eng, "shutdown"):
            eng.shutdown()
        if eng.device.type == "cuda":
            for d in {eng.track_dev, eng.map_dev}:
                torch.cuda.synchronize(d)
    wall = time.perf_counter() - t_start

    if args.save_state:
        from como_tpu_torch.utils.checkpoint import save_mapping_state
        save_mapping_state(eng.mapping, args.save_state)

    os.makedirs(args.save_traj, exist_ok=True)
    name = getattr(dataset, "save_traj_name", args.dataset_type)
    out = os.path.join(args.save_traj, name + ".txt")
    eng.save_trajectory(out)
    if hasattr(eng, "log"):
        if args.log:
            profiling.write_log(eng.log, mark)
        eng.log.close()
    print(f"{n} frames in {wall:.1f}s ({n / wall:.1f} FPS); trajectory -> {out}")
    return eng


if __name__ == "__main__":
    main()
