"""One run of a cell on the CPU at a small size (48x64, 4 keyframes / 4
one-way frames, 16 anchors), through everything but the look for a chip;
prints one JSON line: the result and the forbidden modules loaded.

    python3 benchmark/tests/cpu_run.py <cell> <seed> <seconds> [fault]
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SMALL = {"img_size": [48, 64],
         "mapping": {"graph": {"num_keyframes": 4, "num_one_way_frames": 4},
                     "sampling": {"max_num_coords": 16, "border": 2}, "init": {"max_iter": 30}}}


def main(argv):
    t0 = time.perf_counter()
    import torch

    from benchmark import harness, run, spec

    torch.set_num_threads(2)
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, argv[0])
    fault = argv[3] if len(argv) > 3 else None
    res, _ = harness.execute(bench, cell, int(argv[1]), float(argv[2]), False, "cpu", t0,
                             config_override=SMALL, fault=fault)
    print(json.dumps({"result": res, "forbidden": run.forbidden_modules()}))


if __name__ == "__main__":
    main(sys.argv[1:])
