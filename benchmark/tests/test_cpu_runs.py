"""Whole runs of the harness on the CPU at 48x64 (each in a process of its
own), of a ComoSeq cell and of the ComoPipeline cell: the reference agrees
with the port, nothing of JAX or the JAX package is loaded, and with the
timed path broken underneath the check comes out false: also where the GN
step or the insertion runs out of the wraps' reach, as after a change that
renames or fuses it (ComoSeq), and where an answer is altered where the
pipeline's stage threads produce it."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import check, spec

HERE = Path(__file__).resolve().parent
SEED, SECONDS = 2147483648 + 17, 12
FAULTS = ("state_unchanged", "half_sites", "answer_altered", "gn_unhooked", "insert_unhooked")
# the faults each cell's runs break its timed path with
CELLS = {"como-seq-unet.clutter-fast": FAULTS,
         "como-pipeline-unet.clutter-orbit": ("answer_altered",)}


@pytest.fixture(scope="module", params=list(CELLS))
def runs(request):
    cell = request.param
    procs = {f: subprocess.Popen([sys.executable, str(HERE / "cpu_run.py"), cell, str(SEED),
                                  str(SECONDS)] + ([f] if f else []),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for f in (None,) + CELLS[cell]}
    out = {}
    for f, p in procs.items():
        stdout, stderr = p.communicate(timeout=1500)
        assert p.returncode == 0, stderr[-3000:]
        out[f] = json.loads(stdout.strip().splitlines()[-1])
    return cell, out


def test_reference_agrees_with_the_port_at_48x64(runs):
    cell, out = runs
    res = out[None]["result"]
    # a frame fails only where the pipeline's pose queue dropped its pose
    # as stale (none under ComoSeq)
    assert res["attempted"] > 0 and res["failed"] == res["after_parts"]["dropped"]
    for k in check.required_of(spec.load_traffic(cell.split(".", 1)[1])):
        assert res["checks"][k]["value"] is not None, k
    assert res["correct"], res["checks"]


def test_no_module_of_jax_or_the_jax_package_is_loaded(runs):
    _, out = runs
    for f, r in out.items():
        assert r["forbidden"] == [], (f, r["forbidden"])


@pytest.mark.parametrize("runs, fault", [(c, f) for c, faults in CELLS.items() for f in faults],
                         indirect=["runs"])
def test_a_broken_timed_path_is_not_correct(runs, fault):
    _, out = runs
    res = out[fault]["result"]
    assert not res["correct"], res["checks"]
