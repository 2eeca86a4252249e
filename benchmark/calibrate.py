"""Readings for the limits of the check (benchmark/check.py): runs a cell
once per seed in one process, with a short window at the cell's own load,
and prints per seed one JSON line with the numbers of the program's run
("sound") and, for the first --control seeds, those of the control (the
reference one precision lower in the program's place).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 \\
        --seconds 15 --control 3
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    args = p.parse_args(argv)
    from benchmark import run

    run.set_cache_dirs()
    import torch

    from benchmark import harness, spec

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, args.workload)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        res, _ = harness.execute(bench, cell, seed, args.seconds, False, "cuda", t0,
                                 control=i < args.control)
        line = {"workload": args.workload, "seed": seed, "correct": res["correct"],
                "attempted": res["attempted"], "failed": res["failed"],
                "seconds": time.perf_counter() - t0,
                "sound": {k: v["value"] for k, v in res["checks"].items()}}
        if "control_checks" in res:
            line["control_correct"] = res["control_correct"]
            line["control"] = {k: v["value"] for k, v in res["control_checks"].items()}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
