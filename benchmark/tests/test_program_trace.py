"""On the card: the program's own spans (como_tpu_torch/utils/profiling.py)
sit on the device trace's clock.  One traced run of a cell, shortened:
the kernels launched inside the program's "tracking.track_frame" spans
are those inside the benchmark's "tracking" wraps; the program's
"gn.step" and "mapping.add_keyframe" spans lie inside the wraps' "gn" and
"kf_insert" spans and, outside the device trace's sessions, cover all but
at most 2% of their summed length (the largest gap of one span is
reported: the thread can lose its CPU between the two clock reads); and
the share of IC iterations used equals, to the iteration, what
track_pyramid returned over the same frames.  The numbers are printed
before they are checked.  Needs the card (skips without one, decided
inside the test):

    python3 -m pytest benchmark/tests/test_program_trace.py -m cuda -s
"""

import json
import os
import time

import pytest
import torch

from benchmark import harness, layers, spec

CELL = "como-seq-unet.clutter-fast"
SEED, SECONDS = 2147483648 + 4242, 30.0
GAP = 0.02


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _inside(prog, wraps):
    """The wrap span (same thread) that holds each program span; None where
    not exactly one does."""
    out = []
    for p in prog:
        w = [s for s in wraps if s[1] == p.thread and s[2] <= p.t0 and p.t1 <= s[3]]
        out.append(w[0] if len(w) == 1 else None)
    return out


@pytest.mark.cuda
def test_program_spans_share_the_device_trace_clock(cuda_device, monkeypatch):
    from como_tpu_torch.odom.frontend import tracking_kernels as tk
    from como_tpu_torch.utils.profiling import RECORDER

    got = {}
    per_layer = layers.per_layer

    def spy_layers(bench, cell, window, captured, tracer):
        got.update(window=window, captured=captured, tracer=tracer)
        return per_layer(bench, cell, window, captured, tracer)

    direct = []
    solve = tk.track_pyramid

    def spy_solve(*a, **k):
        out = solve(*a, **k)
        direct.append((time.time_ns(), out[2]))
        return out

    monkeypatch.setattr(layers, "per_layer", spy_layers)
    monkeypatch.setattr(tk, "track_pyramid", spy_solve)
    bench = spec.load_benchmark()
    cpus = os.sched_getaffinity(0)
    try:
        res, _ = harness.execute(bench, spec.find_cell(bench, CELL), SEED, SECONDS, True,
                                 cuda_device, time.perf_counter())
    finally:
        os.sched_setaffinity(0, cpus)
    run = layers.TracedRun(bench, CELL, got["window"], got["captured"], got["tracer"],
                           torch.cuda.get_device_name(cuda_device))
    lo, hi = min(s[2] for s in run.spans), max(s[3] for s in run.spans)
    prog = [s for s in RECORDER.spans if lo <= s.t0 and s.t1 <= hi]
    report = {"metrics": {k: v["value"] for k, v in res["metrics"].items()},
              "correct": res["correct"]}

    # the same kernels inside the program's track_frame spans as inside the wraps'
    sess = run.session("frames")
    wraps = [s for s in run.spans_named("tracking") if sess["t0"] <= s[2] and s[3] <= sess["t1"]]
    frames = [s for s in prog if s.name == "tracking.track_frame"
              and sess["t0"] <= s.t0 and s.t1 <= sess["t1"]]
    k_prog, k_wrap = run.kernels_in(frames, sess), run.kernels_in(wraps, sess)
    report["frames"] = dict(program=len(frames), wraps=len(wraps), kernels=len(k_prog),
                            wrap_kernels=len(k_wrap))

    # the GN step and the insertion: inside the wraps, and as long outside the sessions
    def quiet(s):
        return not any(s[2] < x["t1"] and x["t0"] < s[3] for x in run.sessions)

    held = {}
    for name, wrap in (("gn.step", "gn"), ("mapping.add_keyframe", "kf_insert")):
        spans = [s for s in prog if s.name == name]
        held[name] = list(zip(spans, _inside(spans, run.spans_named(wrap))))
        pairs = [(p, w) for p, w in held[name] if w is not None and quiet(w)]
        gaps = sorted(1.0 - (p.t1 - p.t0) / (w[3] - w[2]) for p, w in pairs)
        summed = (1.0 - sum(p.t1 - p.t0 for p, _ in pairs) / sum(w[3] - w[2] for _, w in pairs)
                  if pairs else None)
        report[name] = dict(spans=len(spans), outside_sessions=len(pairs),
                            summed_gap=summed, median_gap=gaps[len(gaps) // 2] if gaps else None,
                            max_gap=gaps[-1] if gaps else None)

    # the IC iterations used: the device counter against track_pyramid's own return
    used = sum(int(v.sum()) for t, _, v in RECORDER.device_values("tracking.ic_iters_used",
                                                                  since=lo) if t <= hi)
    mine = [it for t, it in direct if lo <= t <= hi]
    launched = sum(s.payload["launched"] for s in prog if s.name == "tracking.ic_level")
    report["ic_iters"] = dict(frames=len(mine), used=used, launched=launched,
                              direct=sum(int(it.sum()) for it in mine),
                              per_level=[int(x) for x in sum(it.cpu() for it in mine)])
    print(json.dumps(report))

    assert len(frames) == len(wraps) > 0 and None not in _inside(frames, wraps)
    assert sorted(k[3] for k in k_prog) == sorted(k[3] for k in k_wrap)
    assert len(k_prog) / len(frames) == report["metrics"]["tracking.launches_per_frame"]
    for name, pairs in held.items():
        assert pairs and all(w is not None for _, w in pairs), name
        gap = report[name]["summed_gap"]
        assert gap is None or 0 <= gap <= GAP, report[name]
    assert report["ic_iters"]["direct"] == used and launched == 150 * len(mine)
    assert report["metrics"]["tracking.ic_iters_used_share"] == 100.0 * used / launched
    for k in ("tracking.ic_iter_host_ms", "tracking.host_cpu_share", "mapping.sampler_call_ms"):
        assert report["metrics"][k] > 0, k
    assert res["correct"]
