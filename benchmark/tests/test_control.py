"""The control comes out not correct: the reference, one precision lower,
put in the program's place (benchmark/check.py, control=True), at the
cell's own size, on three seeds, with a short window at the cell's load.
Needs the card (skips without one, decided inside the test):

    python3 -m pytest benchmark/tests/test_control.py -m cuda -s

The other tests of benchmark/tests/ run on the CPU:
    python3 -m pytest benchmark/tests -m "not cuda"
"""

import json
import time

import pytest
import torch

from benchmark import harness, spec

SEEDS = (2147483661, 2147483662, 2147483663)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_control_is_not_correct(cuda_device, cell):
    bench = spec.load_benchmark()
    for seed in SEEDS:
        res, _ = harness.execute(bench, spec.find_cell(bench, cell), seed, 20.0, False,
                                 cuda_device, time.perf_counter(), control=True)
        print(json.dumps({"cell": cell, "seed": seed,
                          "sound": {k: v["value"] for k, v in res["checks"].items()},
                          "control": {k: v["value"] for k, v in res["control_checks"].items()}}))
        assert res["correct"], res["checks"]
        assert not res["control_correct"], res["control_checks"]
