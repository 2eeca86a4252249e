"""Whole runs of the harness on the CPU at 48x64 (each in a process of its
own): the reference agrees with the port, nothing of JAX or the JAX
package is loaded, and with the timed path broken underneath the check
comes out false: also where the GN step or the insertion runs out of the
wraps' reach, as after a change that renames or fuses it."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import check, spec

HERE = Path(__file__).resolve().parent
CELL, SEED, SECONDS = "como-seq-unet.clutter-fast", 2147483648 + 17, 12
FAULTS = ("state_unchanged", "half_sites", "answer_altered", "gn_unhooked", "insert_unhooked")


@pytest.fixture(scope="module")
def runs():
    procs = {f: subprocess.Popen([sys.executable, str(HERE / "cpu_run.py"), CELL, str(SEED),
                                  str(SECONDS)] + ([f] if f else []),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for f in (None,) + FAULTS}
    out = {}
    for f, p in procs.items():
        stdout, stderr = p.communicate(timeout=1500)
        assert p.returncode == 0, stderr[-3000:]
        out[f] = json.loads(stdout.strip().splitlines()[-1])
    return out


def test_reference_agrees_with_the_port_at_48x64(runs):
    res = runs[None]["result"]
    assert res["attempted"] > 0 and res["failed"] == 0
    for k in check.required_of(spec.load_traffic(CELL.split(".", 1)[1])):
        assert res["checks"][k]["value"] is not None, k
    assert res["correct"], res["checks"]


def test_no_module_of_jax_or_the_jax_package_is_loaded(runs):
    for f, r in runs.items():
        assert r["forbidden"] == [], (f, r["forbidden"])


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(runs, fault):
    res = runs[fault]["result"]
    assert not res["correct"], res["checks"]
