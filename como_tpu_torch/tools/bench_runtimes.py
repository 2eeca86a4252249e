"""ComoSeq against ComoPipeline on the bench world (port of
scripts/bench_runtimes.py).

Both engines run the clutter world of python -m como_tpu_torch.bench (seed
--seed, step 0.02, all frames rendered first) at their natural operating
points: ComoSeq with frame_batch 2 and dispatch_depth 6 (the bench's e2e
config), ComoPipeline (two stage threads) with dispatch_depth 2.  Per run:
wall FPS over the whole sequence (the clock stops after the engine's
finish / shutdown and a synchronize of both stage devices), scale-aligned
ATE, frames tracked; per engine the fastest of --runs runs, and the
pipeline's FPS over ComoSeq's.  The report goes to --out (default
results/torch_runtime_bench.json; results/runtime_bench.json is the JAX
package's and is never written here).

    python -m como_tpu_torch.tools.bench_runtimes [--frames 110] [--runs 2]

Runs on the card unless --device cpu is given (with a small --img: full
size takes minutes per frame on the CPU); without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

from como_tpu_torch.tools.common import (card_line, end_run, engine_ate, render_frames,
                                         synchronize, tool_device)

IMG = (192, 256)
ENGINES = ("seq", "pipeline")


def run_once(engine_kind: str, frames, poses, intr, seed: int, device="cuda",
             img=IMG, base_cfg=None) -> dict:
    """One timed run of `engine_kind` ("seq" or "pipeline") over pre-rendered
    frames; `base_cfg` (default ComoConfig()) before the runtime's fields."""
    from como_tpu_torch.config import ComoConfig

    cfg = copy.deepcopy(base_cfg) if base_cfg is not None else ComoConfig()
    cfg.img_size = list(img)
    if engine_kind == "seq":
        # the bench's operating point: pair dispatches, deep dispatch
        cfg.frame_batch = 2
        cfg.dispatch_depth = 6
        from como_tpu_torch.runtime.seq import ComoSeq as Engine
    else:
        # decoupled stages; the tracker runs open-loop at its own depth
        cfg.dispatch_depth = 2
        from como_tpu_torch.runtime.pipeline import ComoPipeline as Engine
    cfg.validate()
    eng = Engine(cfg, intr, tuple(img), device=device)
    eng.setup()
    synchronize(device)
    t0 = time.perf_counter()
    for ts_i, rgb_i in frames:
        eng.step(float(ts_i), rgb_i)
    end_run(eng)
    wall = time.perf_counter() - t0
    return dict(fps=len(frames) / wall, ate_cm=100.0 * engine_ate(eng, poses),
                frames_tracked=len(eng.timestamps), seed=seed)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=110)
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="results/torch_runtime_bench.json")
    p.add_argument("--img", type=int, nargs=2, default=list(IMG))
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = tool_device(args.device)
    from como_tpu_torch.data.synthetic import SyntheticDataset

    img = tuple(args.img)
    ds = SyntheticDataset(n_frames=args.frames, img_size=img, seed=args.seed, step=0.02,
                          scene="clutter", device=dev)
    frames = render_frames(ds, dev)

    out = {}
    for kind in ENGINES:
        runs = []
        for r in range(args.runs):
            res = run_once(kind, frames, ds.poses, ds.intrinsics, args.seed, dev, img)
            runs.append(res)
            print(f"{kind} run {r}: {json.dumps(res)}", flush=True)
        out[kind] = dict(best=max(runs, key=lambda x: x["fps"]), runs=runs)
    out["pipeline_vs_seq"] = out["pipeline"]["best"]["fps"] / out["seq"]["best"]["fps"]
    out["card"] = card_line(dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v["best"] if isinstance(v, dict) else v for k, v in out.items()}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
