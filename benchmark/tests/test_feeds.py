"""Where each feed puts the traced run's frames session (benchmark/drive.py
calls `tick`, benchmark/layers.py keys the session to it), on a made-up
engine, stream and clock and a device trace whose sessions are only
recorded: the closed loop ticks the frames handed over, before each
hand-over, as it always has; the CLI feed ticks the window poses received,
after each `step`, so its session holds the work of tracked frames and not
the hand-over of the frames that fill the empty queue at the window's
start, also where the pose queue dropped a pose as stale.  Every session
is started and stopped on the main thread."""

import threading

import numpy as np
import pytest

from benchmark import drive, layers

HZ = 30.0


class Clock:
    """Stands in for the time module in benchmark/drive.py: a `step` takes
    one second."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += s


class Stream:
    def frame(self, i):
        return i / HZ, None

    def index_of(self, ts):
        return int(round(ts * HZ))


class Seq:
    def __init__(self, clock):
        self.clock = clock
        self.timestamps, self.est_poses = [], []

    def step(self, ts, rgb):
        self.clock.t += 1.0
        return np.eye(4)


class Pipeline:
    """The first `quick` calls find room in the input queue and return at
    once with no pose; each later call gives back one pose, the oldest
    frame's, except that the pose of frame `drop` was dropped as stale (that
    call gives back the next frame's)."""

    def __init__(self, clock, quick=5, drop=None):
        self.clock, self.quick, self.drop = clock, quick, drop
        self.timestamps, self.est_poses = [], []
        self.queued, self.calls = [], 0

    def step(self, ts, rgb):
        self.calls += 1
        self.queued.append(ts)
        if self.calls <= self.quick:
            return None
        self.clock.t += 1.0
        ts_out = self.queued.pop(0)
        if Stream().index_of(ts_out) == self.drop:
            ts_out = self.queued.pop(0)
        self.timestamps.append(ts_out)
        self.est_poses.append(np.eye(4))
        return self.est_poses[-1]


class Trace(layers.DeviceTrace):
    """The device trace's own `tick`; its sessions are recorded with the
    count at which each started and stopped, and no profiler runs."""

    def __init__(self, received=None):
        super().__init__("cpu")
        self.ticks, self.events, self.received = [], [], received

    def tick(self, k, lead=0):
        self.ticks.append((k, lead))
        self.k = k
        super().tick(k, lead)

    def start(self, label):
        self._on_main_thread("started")
        with self.lock:
            if self.active:
                return False
            self.active = True
        self.label = label
        self.events.append(("start", label, self.k, self._frames()))
        return True

    def stop(self):
        self._on_main_thread("stopped")
        self.events.append(("stop", self.label, self.k, self._frames()))
        with self.lock:
            self.active = False

    def _frames(self):
        return None if self.received is None else len(self.received.timestamps)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(drive, "time", c)
    return c


def test_closed_loop_ticks_the_frames_handed_over_before_each(clock):
    tracer = Trace()
    window = drive.window_closed_loop(Seq(clock), Stream(), 40, 12.0, "cpu", tick=tracer.tick)
    n = len(window["frames"])
    assert n == 12
    assert tracer.ticks == [(k, 0) for k in range(n)]
    start, stop = layers.FRAMES_FROM, layers.FRAMES_FROM + layers.FRAMES
    assert [e[:3] for e in tracer.events] == [("start", "frames", start),
                                              ("stop", "frames", stop)]


@pytest.mark.parametrize("drop", [None, 41, 44, 50])
def test_cli_keys_the_session_to_poses_received(clock, drop):
    """Warm-up frames 0-39; window frames from 40.  Calls 1-5 return at
    once; call 6 gives back frame 40's pose, call 7 frame 41's (the
    FRAMES_FROM-th: the session starts), and so on.  With `drop`, that
    frame's pose never comes and the call that would give it gives the
    next frame's: just before the session (41), inside it (44) or after it
    (50), the count of poses received, not of frames tracked, keys it."""
    eng = Pipeline(clock, drop=drop)
    tracer = Trace(received=eng)
    window = drive.window_cli(eng, Stream(), 40, 20.0, "cpu", tick=tracer.tick)
    poses = [t[0] for t in tracer.ticks]
    assert poses[:5] == [0] * 5 and tracer.ticks[0][1] == 1
    assert all(b - a in (0, 1) for a, b in zip(poses, poses[1:]))
    assert [e[0] for e in tracer.events] == ["start", "stop"]
    (_, _, k0, n0), (_, _, k1, n1) = tracer.events
    assert k0 == layers.FRAMES_FROM and k1 == k0 + layers.FRAMES + 1
    # FRAMES + 1 poses came back inside the session: the frame the tracking
    # stage had taken when it started, and FRAMES whole frames
    assert n1 - n0 == layers.FRAMES + 1
    assert window["dropped"] == (drop is not None)
    assert sum(not ok for ok in window["ok"]) == (drop is not None)


@pytest.mark.parametrize("what", ["start", "stop"])
def test_a_session_off_the_main_thread_raises(what):
    trace = layers.DeviceTrace("cpu")
    got = []

    def call():
        try:
            trace.start("frames") if what == "start" else trace.stop()
        except RuntimeError as e:
            got.append(str(e))

    t = threading.Thread(target=call, name="mapping")
    t.start()
    t.join(10)
    assert not t.is_alive()
    assert got and "main thread" in got[0] and "'mapping'" in got[0]
    assert not trace.active
