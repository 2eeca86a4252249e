"""The bootstrap sweep (benchmark/bootstrap_sweep.py) on the CPU at 48x64:
both runtimes hand the two-frame SfM the same frames and read the same
alignments, so a long bootstrap is the seed's and not the runtime's; and
every attempt is a reference set-up (the first, then one after each
re-seed) or an alignment."""

import pytest

from benchmark import bootstrap_sweep, spec
from benchmark.tests.cpu_run import SMALL

SEED = 2147483648 + 17
CELLS = ("como-seq-unet.clutter-orbit", "como-pipeline-unet.clutter-orbit")
# the bootstrap ends at the first alignment whose translation over the
# median depth is above this
MOTION_RATIO = spec.load_config("como-seq-unet")["config"]["mapping"]["init"][
    "kf_depth_motion_ratio"]


@pytest.fixture(scope="module")
def sweep():
    bench = spec.load_benchmark()
    return [bootstrap_sweep.bootstrap(spec.find_cell(bench, c), SEED, "cpu", SMALL)
            for c in CELLS]


def test_both_runtimes_read_the_same_alignments(sweep):
    seq, pipe = sweep
    assert seq["aligns"] > 0
    assert seq["frac"] == pipe["frac"] and seq["ratio"] == pipe["ratio"]
    assert seq["reseeds"] == pipe["reseeds"]


def test_attempts_are_set_ups_and_alignments(sweep):
    for r in sweep:
        assert r["attempts"] == r["aligns"] + 1 + r["reseeds"]
        assert r["warmup_frames"] > r["attempts"] and r["warmup_s"] > r["attempts_s"] > 0
        assert r["ratio_last"] > MOTION_RATIO
