"""The two-frame bootstrap of each seed under each cell's runtime, as a
run's warm-up feeds it (benchmark/drive.py, `warm_up`): the frames and
seconds the warm-up took (a run's `setup_parts.warmup_frames` and
`warmup_s`), the attempts and their seconds (the program's
"mapping.two_frame_init" spans), and what each SfM alignment said: the
share of pixels it kept (under `init.kf_num_pixels_frac` the reference is
re-seeded on the next frame) and its translation over the median depth
(over `init.kf_depth_motion_ratio` the bootstrap ends).

    python3 -m benchmark.bootstrap_sweep --workloads <cell> [<cell> ...] \\
        --seeds <n> [<n> ...] [--out FILE]

Prints one JSON line per cell and seed (and appends it to FILE).  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time


def bootstrap(cell: dict, seed: int, device, config_override=None) -> dict:
    """Warm one engine of the cell up on the seed's stream; what its
    bootstrap took."""
    import copy

    import torch

    import como_tpu_torch.odom.frontend.sfm as sfm_mod
    from benchmark import drive, hooks, spec
    from benchmark.stream import Stream
    from como_tpu_torch.utils.profiling import RECORDER

    config = spec.load_config(cell["config"])
    if config_override:
        config = copy.deepcopy(config)
        hooks.merge(config["config"], config_override)
    traffic = spec.load_traffic(cell["traffic"])
    init = config["config"]["mapping"]["init"]
    H, W = config["config"]["img_size"]
    dev = torch.device(device)
    stream = Stream(traffic, (H, W), seed, int(traffic["warmup"]["max_frames"]), dev)
    eng = drive.build_engine(config, stream.K, dev.type)
    aligns = []
    align = sfm_mod.sfm_align

    def wrapped(*a, **k):
        out = align(*a, **k)
        Tji, _, _, count, med = out
        aligns.append(torch.stack([count.to(med.dtype), torch.linalg.norm(Tji[:3, 3]), med]))
        return out

    mark = RECORDER.mark()
    sfm_mod.sfm_align = wrapped
    try:
        drive.synchronize(dev)
        t = time.perf_counter()
        frames = drive.warm_up(eng, stream, traffic["warmup"])
        drive.synchronize(dev)
        seconds = time.perf_counter() - t
    finally:
        sfm_mod.sfm_align = align
        drive.stop_engine(eng)
    spans = [s for s in list(RECORDER.spans)
             if s.name == "mapping.two_frame_init" and s.t0 >= mark.t]
    said = torch.stack(aligns).double().cpu().numpy() if aligns else []
    frac = [float(a[0]) / (H * W) for a in said]
    ratio = [float(a[1] / a[2]) for a in said]
    reseeds = [i for i, f in enumerate(frac) if f < init["kf_num_pixels_frac"]]
    ms = [1e-6 * (s.t1 - s.t0) for s in spans]
    return {"workload": cell["name"], "seed": seed, "warmup_frames": frames,
            "warmup_s": seconds, "attempts": len(spans), "attempts_s": 1e-3 * sum(ms),
            "attempt_ms_median": statistics.median(ms) if ms else None,
            "aligns": len(said), "reseeds": len(reseeds),
            "last_reseed_align": reseeds[-1] if reseeds else None,
            "aligns_after_last_reseed": len(said) - 1 - reseeds[-1] if reseeds else len(said),
            "frac_min": min(frac) if frac else None,
            "ratio_last": ratio[-1] if ratio else None,
            "frac": [round(f, 4) for f in frac], "ratio": [round(r, 5) for r in ratio]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workloads", nargs="+", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from benchmark import run

    run.set_cache_dirs()
    import torch

    from benchmark import spec

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("bootstrap_sweep: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    for name in args.workloads:
        cell = spec.find_cell(bench, name)
        for seed in args.seeds:
            line = json.dumps(bootstrap(cell, seed, "cuda"))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
