"""The port's span and counter recorder (como_tpu_torch/utils/profiling.py)
on the CPU: spans, the ring, counters, the device counter of the IC
iterations, a 48x64 CLI run with the recorder on and off, and the --log
exporter.  One test needs the card (marker `cuda`, skips without one)."""

import json
import threading

import numpy as np
import pytest
import torch
import yaml

from como_tpu_torch import cli
from como_tpu_torch.data.synthetic import PlaneScene
from como_tpu_torch.geometry import lie
from como_tpu_torch.odom import tracking
from como_tpu_torch.odom.frontend import tracking_kernels as tk
from como_tpu_torch.utils import profiling
from como_tpu_torch.utils.profiling import RECORDER, Recorder
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

SMALL = dict(
    img_size=[48, 64],
    tracking=dict(term_criteria=dict(max_iter=30)),
    mapping=dict(graph=dict(num_keyframes=4, num_one_way_frames=4),
                 sampling=dict(max_num_coords=16, border=2), init=dict(max_iter=30)))
FRAMES = 25
# the spans a short ComoSeq run at frame_batch 1 records; besides these,
# "runtime.dispatch_pair" (frame_batch 2), "runtime.dispatch_frame" (once
# mapping converged), "sync.should_iterate" (the convergence test, from
# eight GN steps after an insertion on) and "sync.rebuild_pairs" (radius
# pairs) lie on other paths
ENGINE_SPANS = {
    "runtime.step", "runtime.resolve", "runtime.refresh_reference", "runtime.dispatch_fused",
    "tracking.decide", "tracking.update_kf_reference", "tracking.track_frame",
    "tracking.ic_level", "gn.step", "mapping.two_frame_init", "mapping.handle_tracking_data",
    "mapping.add_keyframe", "mapping.prior", "mapping.corr_and_prep", "gp.sampler",
    "mapping.finalize", "mapping.add_one_way_frame", "mapping.get_kf_ref_data",
    "sync.host_value", "sync.insert_host", "sync.two_frame_init"}


@pytest.fixture
def switch():
    """Restores the module's switch after a test that turns it."""
    yield
    profiling.enabled = True


def test_spans_nest_per_thread_with_frame_and_thread_keys():
    rec = Recorder()
    keys = {}

    def work(tag, ts):
        keys[tag] = profiling.thread_keys()
        with rec.span("outer", frame=ts):
            with rec.span("inner", level=tag):
                pass
        with rec.span("alone"):
            pass

    threads = [threading.Thread(target=work, args=(t, 0.5 * t)) for t in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    spans = list(rec.spans)
    assert len(spans) == 6
    by_id = {s.id: s for s in spans}
    for tag in (1, 2):
        mine = {s.name: s for s in spans if s.thread == keys[tag]}
        outer, inner, alone = mine["outer"], mine["inner"], mine["alone"]
        assert inner.parent == outer.id and outer.parent == 0 and alone.parent == 0
        assert inner.frame == outer.frame == 0.5 * tag and alone.frame is None
        assert inner.payload == {"level": tag} and outer.payload is None
        assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
        assert 0 <= inner.cpu1 - inner.cpu0 and by_id[inner.parent].thread == keys[tag]
    native, ident = keys[1]
    assert native == threads[0].native_id and -2 ** 31 <= ident < 2 ** 31


def test_threads_lose_no_count_or_span():
    """More threads than cores, switching every microsecond: every count
    and every span of every thread is kept."""
    import os
    import sys

    rec = Recorder()
    n_threads, n = 2 * (os.cpu_count() or 1) + 2, 300

    def work():
        for i in range(n):
            with rec.span("s"):
                rec.count("c", key=(i % 3, 64))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert rec.counter("c") == n_threads * n and len(rec.spans) == n_threads * n
    assert len({s.id for s in rec.spans}) == n_threads * n


def test_the_ring_keeps_the_newest_spans():
    rec = Recorder(ring=5)
    for i in range(12):
        with rec.span("s", i=i):
            pass
    assert [s.payload["i"] for s in rec.spans] == list(range(7, 12))
    assert [s.id for s in rec.spans] == list(range(8, 13))


def test_counters_keyed_by_shape_and_reset():
    rec = Recorder()
    rec.count("kernels.k", key=(64, 64))
    rec.count("kernels.k", key=(64, 64))
    rec.count("kernels.k", key=(1, 64))
    rec.count("frames", 3)
    assert rec.counter("kernels.k") == 3 and rec.counter("kernels.k", key=(64, 64)) == 2
    assert rec.by_key("kernels.k") == {(64, 64): 2, (1, 64): 1}
    assert rec.counter("frames") == 3 and rec.by_key("frames") == {}
    mark = rec.mark()
    rec.count("kernels.k", key=(1, 64))
    assert rec.summary(mark)["counters"] == {"kernels.k": {"1x64": 1}}
    rec.reset("kernels.k")
    assert rec.counter("kernels.k") == 0 and rec.counter("frames") == 3


def test_ic_iterations_used_are_the_solves_own_count(monkeypatch):
    """One 48x64 tracked frame: the device counter holds the very tensor
    track_pyramid returned (no copy made while tracking), read equal to it
    when asked; each level's span carries the iterations it launched."""
    scene = PlaneScene(img_size=(48, 64), seed=0, device="cpu")
    rgb0, depth0 = scene.render(torch.eye(4))
    T1 = lie.se3_exp(torch.tensor([0.004, -0.003, 0.002, 0.03, -0.01, 0.02]))
    rgb1, _ = scene.render(T1)
    levels = tracking.build_reference(rgb0, torch.eye(4)[None], depth0, scene.K, 0, 3,
                                      "nearest_neighbor")
    term = tk.TermStatic(max_iter=30, delta_norm=1e-3, rel_tol=1e-3, grad_norm=1.0)
    seen = []
    solve = tk.track_pyramid

    def spy(*a, **k):
        out = solve(*a, **k)
        seen.append(out[2])
        return out

    monkeypatch.setattr(tk, "track_pyramid", spy)
    mark = RECORDER.mark()
    launched0 = RECORDER.counter("tracking.ic_iters_launched")
    tracking.track_frame(levels, rgb1, torch.eye(4), torch.zeros(2), torch.eye(4), term,
                         0, 3, (48, 64))
    entry = RECORDER.device["tracking.ic_iters_used"][-1]
    assert entry[2] is seen[0] and entry[0] >= mark.t
    (_, _, used), = RECORDER.device_values("tracking.ic_iters_used", since=mark.t)
    np.testing.assert_array_equal(used, seen[0].numpy())
    assert 1 <= used.min() and used.max() <= 30
    assert RECORDER.counter("tracking.ic_iters_launched") - launched0 == 3 * 30
    lv = [s for s in RECORDER.spans if s.name == "tracking.ic_level" and s.t0 >= mark.t]
    frame = next(s for s in RECORDER.spans if s.name == "tracking.track_frame"
                 and s.t0 >= mark.t)
    assert [s.payload for s in lv] == [{"level": i, "launched": 30} for i in range(3)]
    assert all(s.parent == frame.id for s in lv)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same 48x64 CLI run with the recorder on (with --log) and off."""
    d = tmp_path_factory.mktemp("trace")
    cfg = d / "small.yml"
    cfg.write_text(yaml.safe_dump(SMALL))
    args = ["--dataset_type", "synthetic", "--device", "cpu", "--max_frames", str(FRAMES),
            "--config", str(cfg)]
    try:
        mark = RECORDER.mark()
        on = cli.main(args + ["--save_traj", str(d / "on"), "--log", str(d / "on.jsonl")])
        on_spans = [s for s in RECORDER.spans if s.t0 >= mark.t]
        on_summary = RECORDER.summary(mark)
        profiling.enabled = False
        mark = RECORDER.mark()
        n_spans = len(RECORDER.spans)
        off = cli.main(args + ["--save_traj", str(d / "off")])
        off_recorded = (len(RECORDER.spans) - n_spans, RECORDER.summary(mark))
    finally:
        profiling.enabled = True
    return dict(dir=d, on=on, off=off, on_spans=on_spans, on_summary=on_summary,
                off_recorded=off_recorded)


def test_run_is_bit_identical_with_the_recorder_on_and_off(runs):
    on, off = runs["on"], runs["off"]
    assert len(on.est_poses) == len(off.est_poses) >= FRAMES - 8
    np.testing.assert_array_equal(on.poses_numpy(), off.poses_numpy())
    a, b = on.mapping.state, off.mapping.state
    for f in ("kf_pose", "kf_aff", "logzm", "ow_pose", "ow_aff", "P_lm"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert on.mapping.total_iters == off.mapping.total_iters > 0
    assert (on.mapping.num_kf, on.mapping.num_ow) == (off.mapping.num_kf, off.mapping.num_ow)
    # every span of the path was recorded when on; nothing at all when off
    names = {s.name for s in runs["on_spans"]}
    assert ENGINE_SPANS <= names, sorted(ENGINE_SPANS - names)
    assert runs["off_recorded"] == (0, dict(spans={}, counters={}, device_counters={}))
    c = runs["on_summary"]["counters"]
    assert c["gn.steps"] == on.mapping.total_iters
    kinds = [e["frame_kind"] for e in on.log.ring if e["kind"] == "insert"]
    assert c["mapping.keyframes"] == 1 + kinds.count("keyframe")    # and the bootstrap's
    assert c["mapping.one_way_frames"] == kinds.count("one-way") > 0
    assert c["tracking.ic_iters_launched"] == 3 * 30 * c["tracking.frames"]
    used = runs["on_summary"]["device_counters"]["tracking.ic_iters_used"]
    assert len(used) == 3 and 0 < sum(used) < c["tracking.ic_iters_launched"]


def test_log_holds_the_spans_and_their_summary(runs):
    events = [json.loads(line) for line in
              (runs["dir"] / "on.jsonl").read_text().splitlines()]
    spans = [e for e in events if e["kind"] == "span"]
    assert len(spans) == len(runs["on_spans"])
    first = runs["on_spans"][0]
    assert spans[0]["t0"] == first.t0 and spans[0]["t1"] == first.t1
    assert spans[0]["thread"] == list(first.thread) and spans[0]["name"] == first.name
    assert [e["kind"] for e in events][-1] == "summary"
    summary = events[-1]
    steps = [s for s in runs["on_spans"] if s.name == "runtime.step"]
    row = summary["spans"]["runtime.step"]
    assert row["count"] == len(steps) == FRAMES
    assert row["total_ms"] == pytest.approx(sum(s.t1 - s.t0 for s in steps) * 1e-6)
    assert row["median_ms"] <= row["p90_ms"] <= row["total_ms"]
    assert summary["counters"]["tracking.frames"] > 0
    assert any(e["kind"] == "insert" for e in events)


@pytest.mark.cuda
def test_no_synchronization_is_added_on_the_card(switch):
    """One tracked frame at 48x64 on the card: the same host
    synchronizations with the recorder on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import warnings

    dev = torch.device("cuda")
    scene = PlaneScene(img_size=(48, 64), seed=0, device=dev)
    rgb0, depth0 = scene.render(torch.eye(4, device=dev))
    rgb1, _ = scene.render(lie.se3_exp(torch.tensor([0.004, -0.003, 0.002, 0.03, -0.01,
                                                     0.02], device=dev)))
    eye = torch.eye(4, device=dev)
    levels = tracking.build_reference(rgb0, eye[None], depth0, scene.K, 0, 3,
                                      "nearest_neighbor")
    term = tk.TermStatic(max_iter=30, delta_norm=1e-3, rel_tol=1e-3, grad_norm=1.0)

    def syncs(on):
        profiling.enabled = on
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                tracking.track_frame(levels, rgb1, eye, torch.zeros(2, device=dev), eye, term,
                                     0, 3, (48, 64))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return len(caught)

    syncs(True)                                     # first calls
    assert syncs(True) == syncs(False)
