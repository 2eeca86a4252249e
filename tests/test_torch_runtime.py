"""The port's runtimes on the CPU at 48x64 (4 KF / 4 OW / 16 anchors): the
queues (native ring and Python), ComoSeq with frame_batch 2 against the
JAX engine on the same frames,
Tracking.handle_frame against JAX's, and ComoPipeline end to end, with a
stage that fails and with one that never ends.  Every test that starts a
thread bounds its own waiting, so none can hang the suite."""

import threading
import time

import numpy as np
import pytest
import torch

from como_tpu.config import ComoConfig as JConfig
from como_tpu.odom.mapping import Mapping as JMapping
from como_tpu.odom.tracking import Tracking as JTracking
from como_tpu_torch.config import ComoConfig as TConfig
from como_tpu_torch.odom.tracking import Tracking as TTracking
from como_tpu_torch.runtime import queues as q_mod
from como_tpu_torch.runtime.pipeline import ComoPipeline
from como_tpu_torch.runtime.seq import ComoSeq as TSeq
import torch_runtime_cases as cases
from torch_runtime_cases import IMG, plane_frames, small_config

# --- queues --------------------------------------------------------------------

@pytest.fixture(params=["native", "python"])
def queue_factory(request):
    cls = q_mod.NativeQueue if request.param == "native" else q_mod.PyQueue
    return lambda n=4: cls(n)


def test_native_ring_is_built_and_default():
    """g++ is here, so make_queue hands out the native ring, built from
    native/como_runtime.cpp into the package's _build directory."""
    q = q_mod.make_queue(3)
    assert type(q).__name__ == "NativeQueue"
    assert "como_tpu_torch/_build/runtime_" in q_mod.build_info["path"]
    assert abs(q_mod.monotonic_now() - time.monotonic()) < 0.05
    t = q_mod.monotonic_now()
    q_mod.sleep_until(t + 0.05)
    assert q_mod.monotonic_now() - t >= 0.05
    q_mod.sleep_until(t - 1.0)                       # a past deadline returns at once
    assert q_mod.monotonic_now() - t < 0.5


def test_fifo(queue_factory):
    q = queue_factory(4)
    for i in range(3):
        q.push(("msg", i))
    assert q.pop()[1] == 0
    assert q.pop()[1] == 1
    assert q.qsize() == 1


def test_drop_stale_push(queue_factory):
    q = queue_factory(2)
    for i in range(5):
        q.push(i, block=False)
    assert q.qsize() == 2
    assert q.pop() == 3
    assert q.pop() == 4


def test_pop_until_latest(queue_factory):
    q = queue_factory(4)
    for i in range(4):
        q.push(i)
    assert q.pop_until_latest() == 3
    assert q.qsize() == 0
    assert q.pop_until_latest(timeout=0.01) is None


def test_blocking_producer_consumer(queue_factory):
    q = queue_factory(2)
    got = []

    def consumer():
        while True:
            v = q.pop(timeout=2.0)
            if v is None or v == "end":
                break
            got.append(v)

    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    for i in range(20):
        assert q.push(i, block=True, timeout=2.0)
    q.push("end")
    t.join(5.0)
    assert not t.is_alive() and got == list(range(20))


def test_close(queue_factory):
    """A closed queue refuses blocking pushes, still hands out what it
    holds, then returns None."""
    q = queue_factory(2)
    q.push("a")
    q.close()
    assert q.pop(timeout=0.5) == "a"
    assert q.pop(timeout=0.5) is None
    q2 = queue_factory(1)
    q2.push("x")
    q2.close()
    assert q2.push("y", block=True) is False


def test_close_while_blocked(queue_factory):
    """close() wakes a producer blocked on a full queue (push -> False) and
    a consumer blocked on an empty one (pop -> None)."""
    full, empty = queue_factory(1), queue_factory(1)
    full.push("x")
    out = {}
    threads = [threading.Thread(target=lambda: out.update(push=full.push("y", block=True)),
                                daemon=True),
               threading.Thread(target=lambda: out.update(pop=empty.pop()), daemon=True)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    assert all(t.is_alive() for t in threads)       # both are waiting
    full.close()
    empty.close()
    for t in threads:
        t.join(5.0)
    assert not any(t.is_alive() for t in threads)
    assert out == {"push": False, "pop": None}


# --- ComoSeq with frame_batch 2 against the JAX engine ----------------------------
# (resolve_stride 2 and the split stage devices: tests/test_torch_placement.py)

@pytest.fixture(scope="module")
def batched_runs():
    return cases.option_runs("frame_batch")


@pytest.mark.parametrize("check", cases.OPTION_CHECKS, ids=lambda f: f.__name__)
def test_frame_batch_2(batched_runs, check):
    check(batched_runs)


def test_viz_listener_is_called_at_each_refresh():
    frames, K, _ = plane_frames(14, 0.02)
    te = TSeq(small_config(TConfig), K, IMG, device="cpu")
    te.setup()
    seen = []
    te.viz_listener = seen.append
    te.run(frames)
    assert te.mapping.is_init and len(seen) >= 1
    assert seen[-1]["depths"].shape[1:] == (1,) + IMG


# --- Tracking.handle_frame against JAX's -------------------------------------------

def test_handle_frame_matches_jax():
    """20 frames fed synchronously to both trackers, decision_lag as the
    pipeline passes it (dispatch_depth).  The JAX mapping serves both: each
    reference it hands out goes to the JAX tracker as it is and to the
    port's as numpy, so the two trackers are compared on the same
    references.  Held: the same decision kinds at the same frames, T_w_curr
    within 1e-4 (f32 rounding of the IC solve), the same lost flags."""
    frames, K, _ = plane_frames(20, 0.02)
    jcfg, tcfg = small_config(JConfig), small_config(TConfig)
    jm = JMapping(jcfg.mapping, K, IMG)
    jm.setup()
    jt = JTracking(cfg=jcfg.tracking, intrinsics=K, img_size=IMG,
                   decision_lag=jcfg.dispatch_depth)
    jt.setup()
    tt = TTracking(cfg=tcfg.tracking, intrinsics=K, img_size=IMG,
                   decision_lag=tcfg.dispatch_depth, device="cpu")
    tt.setup()

    def refresh():
        ref = jm.get_kf_ref_data(1)
        jt.update_kf_reference(ref)
        tt.update_kf_reference((list(ref[0]),) + tuple(
            torch.from_numpy(np.array(a, np.float32)) for a in ref[1:]))

    kinds, n_tracked = [], 0
    for ts, rgb in frames:
        if not jm.is_init:
            if jm.attempt_two_frame_init(ts, rgb):
                refresh()
            continue
        (jts, jT), jmap = jt.handle_frame(ts, rgb)
        (tts, tT), tmap = tt.handle_frame(ts, torch.from_numpy(rgb))
        n_tracked += 1
        assert tts == jts == ts
        assert (tT is None) == (jT is None)
        np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
        np.testing.assert_allclose(tt.get_curr_world_pose().numpy(),
                                   np.asarray(jt.get_curr_world_pose()), atol=1e-4)
        assert (tmap is None) == (jmap is None)
        if jmap is not None:
            assert tmap[0] == jmap[0] and tmap[4:] == tuple(jmap[4:])
            np.testing.assert_allclose(tmap[2].numpy(), np.asarray(jmap[2]), atol=1e-4)
            kinds.append((jmap[0], round(ts, 6)))
            if jm.handle_tracking_data(jmap):
                refresh()
        jm.maybe_iterate()
    assert n_tracked >= 10
    assert {k for k, _ in kinds} == {"keyframe", "one-way"}


# --- nothing that crosses a queue aliases the window ---------------------------------

def test_queue_messages_own_their_storage():
    """Mapping writes its window in place.  A reference popped from a queue,
    the tracker's levels built from it, and a track_map message must not
    change when the window is written afterwards."""
    frames, K, _ = plane_frames(25, 0.02)
    cfg = small_config(TConfig)
    cfg.tracking.keyframing.kf_depth_motion_ratio = 0.01     # decide early and often
    te = TSeq(cfg, K, IMG, device="cpu")
    te.setup()
    i = 0
    while not te.mapping.is_init:
        te.step(*frames[i])
        i += 1
    m, t = te.mapping, te.tracking
    q = q_mod.make_queue(2)
    q.push(m.get_kf_ref_data(1), block=False)
    ref = q.pop(timeout=1.0)
    t.update_kf_reference(ref)
    held = [x.clone() for x in ref[1:]]
    first_levels = [(lv.vals, lv.vals.clone()) for lv in t.levels]

    def window_fields():
        return [getattr(m.state, f) for f in m.state.fields()]

    ptrs = {x.untyped_storage().data_ptr() for x in window_fields()}
    for x in list(ref[1:]) + [lv.vals for lv in t.levels] + [t.T_w_kf, t.aff_w_kf]:
        assert x.untyped_storage().data_ptr() not in ptrs

    # a track_map through the queue, then insertions, GN steps and window
    # rolls behind it
    msgs = []
    while i < len(frames) and len(msgs) < 3:
        ts, rgb = frames[i]
        i += 1
        _, track_map = t.handle_frame(ts, torch.from_numpy(rgb))
        if track_map is None:
            continue
        q.push(track_map)
        msg = q.pop(timeout=1.0)
        copies = [x.clone() for x in msg[1:4]]
        inserted = m.handle_tracking_data(msg)
        m.iterate()
        floats = [f for f in window_fields() if f.dtype.is_floating_point]
        for f in floats:                       # every window tensor, in place
            f.add_(0.25)
        t._reset_rel_vars()                    # the tracker rebinds, never writes
        for x, c in zip(msg[1:4], copies):
            assert torch.equal(x, c)
        for f in floats:
            f.sub_(0.25)
        msgs.append(msg[0])
        if inserted:
            t.update_kf_reference(m.get_kf_ref_data(1))
    assert len(msgs) == 3
    for x, c in zip(list(ref[1:]) + [a for a, _ in first_levels],
                    held + [b for _, b in first_levels]):
        assert torch.equal(x, c)               # the first reference never moved


# --- ComoPipeline ----------------------------------------------------------------------

def _bounded(fn, seconds):
    """Run fn in a helper thread; fail instead of waiting for ever."""
    out = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001
            out["error"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), f"still running after {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def test_pipeline_end_to_end():
    """Full pipelined SLAM on the 20-frame plane scene of
    tests/test_runtime.py: initialised, more than 5 finite poses, both
    stage threads gone after shutdown."""
    frames, K, _ = plane_frames(20, 0.012)
    eng = ComoPipeline(small_config(TConfig), K, IMG, device="cpu")
    assert [type(q).__name__ for q in eng._queues()] == ["NativeQueue"] * 5
    assert [q._maxsize for q in eng._queues()] == [5, 8, 1, 2, 2]

    def drive():
        eng.setup()
        for ts, rgb in frames:
            eng.step(ts, rgb)
            time.sleep(0.01)  # let the host interleave the threads
        eng.shutdown(timeout=60.0)

    _bounded(drive, 120.0)
    assert eng.mapping.is_init
    assert len(eng.est_poses) > 5 and len(eng.timestamps) == len(eng.est_poses)
    assert np.all(np.isfinite(eng.poses_numpy()))
    assert eng.frames_tracked >= len(eng.est_poses) and eng.poses_dropped >= 0
    assert not any(t.is_alive() for t in eng._threads)
    assert sorted(t.name for t in eng._threads) == ["mapping", "tracking"]
    assert eng.tracking.decision_lag == eng.cfg.dispatch_depth   # as the JAX package


@pytest.mark.parametrize("stage", ["tracking", "mapping"])
def test_pipeline_stage_failure_reaches_the_caller(stage):
    """A stage loop that raises must not be lost: step or shutdown raises
    it, and neither blocks on the dead stage's queues."""
    frames, K, _ = plane_frames(12, 0.012)
    eng = ComoPipeline(small_config(TConfig), K, IMG, device="cpu")

    def boom(*a, **k):
        raise ValueError(f"{stage} broke")

    if stage == "tracking":
        eng.tracking.mapping_init = True
        eng.tracking.handle_frame = boom
    else:
        eng.mapping.attempt_two_frame_init = boom

    def drive():
        eng.setup()
        for ts, rgb in frames:      # more frames than rgb_q holds
            eng.step(ts, rgb)
        eng.shutdown(timeout=10.0)

    with pytest.raises(RuntimeError, match=f"{stage} broke") as exc:
        _bounded(drive, 30.0)
    assert isinstance(exc.value.__cause__, ValueError)
    for t in eng._threads:
        t.join(5.0)
    assert not any(t.is_alive() for t in eng._threads)
    with pytest.raises(RuntimeError):
        eng.step(*frames[0])        # and it stays failed


def test_pipeline_shutdown_raises_on_a_stage_that_never_ends():
    _, K, _ = plane_frames(1, 0.012)
    eng = ComoPipeline(small_config(TConfig), K, IMG, device="cpu")
    release = threading.Event()
    eng._mapping_loop = lambda: release.wait(20.0)
    try:
        with pytest.raises(RuntimeError, match="still alive"):
            _bounded(lambda: (eng.setup(), eng.shutdown(timeout=0.5)), 15.0)
    finally:
        release.set()
