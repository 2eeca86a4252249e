"""The readers of the program's own spans and counters
(benchmark/metrics/tracking.ic_iters_used_share.py, tracking.ic_iter_host_ms.py,
tracking.host_cpu_share.py, mapping.sampler_call_ms.py): on a made-up
traced run and recorder, which spans they keep (inside the range of the
benchmark's own spans, outside the device trace's sessions), what they
read where the program has no recorder, and a whole traced run of the
harness on the CPU at 48x64 that reports all four."""

import gc
from collections import deque

import pytest
import torch

from benchmark import harness, layers, spec
from benchmark.tests.cpu_run import SMALL
from como_tpu_torch.utils import profiling

MS = 1_000_000
READERS = ("tracking.ic_iters_used_share", "tracking.ic_iter_host_ms",
           "tracking.host_cpu_share", "mapping.sampler_call_ms")
KEYS = (7, 7)


def _span(name, t0, t1, cpu=None, payload=None, sid=1):
    cpu = t1 - t0 if cpu is None else cpu
    return profiling.Span(name, KEYS, t0, t1, 0, cpu, 0.0, sid, 0, payload)


def _run(sessions=()):
    """The benchmark's own spans cover 10-100 ms; sessions as given."""
    class Tracer:
        pass

    Tracer.sessions = [dict(label=lbl, t0=a, t1=b, ops=[], kernels=[], launches={})
                       for lbl, a, b in sessions]
    bench = spec.load_benchmark()
    captured = {"spans": [("tracking", KEYS, 10 * MS, 20 * MS, False, None),
                          ("gn", KEYS, 90 * MS, 100 * MS, False, None)], "calls": []}
    window = {"frames": [0, 1], "latency_s": [0.1, 0.1], "calls": {}}
    return layers.TracedRun(bench, bench["workloads"][0]["name"], window, captured,
                            Tracer(), "cpu")


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def _read(name, run):
    return spec.load_module("metrics", name).read(run)


def test_used_share_counts_the_range_s_frames(recorder):
    used = recorder.device["tracking.ic_iters_used"] = deque()
    for t, its in ((5, [9, 9, 9]), (15, [3, 2, 1]), (50, [4, 1, 1]), (105, [50, 50, 50])):
        used.append((t * MS, None, torch.tensor(its, dtype=torch.int32)))
        recorder.spans.extend(_span("tracking.ic_level", t * MS - MS // 2 + i, t * MS - MS // 4,
                                    payload={"level": i, "launched": 50}) for i in range(3))
    # the frames at 15 and 50 ms: 12 iterations used of 300 launched
    assert _read("tracking.ic_iters_used_share", _run()) == pytest.approx(100 * 12 / 300)


def test_host_readers_drop_spans_in_a_session_or_outside_the_range(recorder):
    recorder.spans.extend([
        _span("tracking.ic_level", 12 * MS, 14 * MS, payload={"launched": 50}),
        _span("tracking.ic_level", 30 * MS, 35 * MS, payload={"launched": 50}),    # session
        _span("tracking.ic_level", 60 * MS, 66 * MS, payload={"launched": 100}),
        _span("tracking.ic_level", 101 * MS, 110 * MS, payload={"launched": 50}),  # after
        _span("tracking.track_frame", 11 * MS, 15 * MS, cpu=3 * MS),
        _span("tracking.track_frame", 31 * MS, 39 * MS, cpu=1 * MS),               # session
        _span("tracking.track_frame", 60 * MS, 66 * MS, cpu=6 * MS),
        _span("tracking.track_frame", 2 * MS, 8 * MS, cpu=1 * MS),                 # before
        _span("gp.sampler", 20 * MS, 40 * MS),                                     # session
        _span("gp.sampler", 70 * MS, 80 * MS),
        _span("gp.sampler", 80 * MS, 86 * MS),
    ])
    run = _run(sessions=[("frames", 30 * MS, 40 * MS)])
    assert _read("tracking.ic_iter_host_ms", run) == pytest.approx(8 / 150)
    assert _read("tracking.host_cpu_share", run) == pytest.approx(100 * 9 / 10)
    assert _read("mapping.sampler_call_ms", run) == pytest.approx(8.0)
    # where every sampler call was profiled, all of them count
    run = _run(sessions=[("frames", 30 * MS, 40 * MS), ("insert", 69 * MS, 90 * MS)])
    assert _read("mapping.sampler_call_ms", run) == pytest.approx(12.0)


def test_readers_read_nothing_without_the_program_s_recorder(recorder, monkeypatch):
    """An empty recorder (or one switched off) and a program without one
    (an earlier commit): None, no error."""
    for name in READERS:
        assert _read(name, _run()) is None
    monkeypatch.delattr(profiling, "RECORDER")
    recorder.spans.append(_span("gp.sampler", 70 * MS, 80 * MS))
    for name in READERS:
        assert _read(name, _run()) is None


def test_a_traced_cpu_run_reports_the_program_s_metrics(monkeypatch):
    """The harness's traced run at 48x64 on the CPU (no device trace, so no
    session): each of the four readers finds its spans and counters.  The
    run stays off the one CPU the harness pins its caller to, which the
    whole runs of test_cpu_runs.py, in processes of their own, take, and
    on two PyTorch threads, as theirs."""
    monkeypatch.setattr(harness, "steady_window", gc.collect)
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, "como-seq-unet.clutter-fast")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res, _ = harness.execute(bench, cell, 2147483648 + 29, 6.0, True, "cpu", 0.0,
                                 config_override=SMALL)
    finally:
        torch.set_num_threads(threads)
    m = res["metrics"]
    print({k: m[k]["value"] for k in READERS if k in m})
    assert 0 < m["tracking.ic_iters_used_share"]["value"] <= 100
    assert m["tracking.ic_iter_host_ms"]["value"] > 0
    assert 0 < m["tracking.host_cpu_share"]["value"] <= 101
    assert m["mapping.sampler_call_ms"]["value"] > 0
