"""Driving the engine: build it from a configuration file, warm it up on
the start of the stream, then feed the measured window.

Feeds (the mix's `feed` entry for the configuration's runtime):
  closed_loop  one frame at a time: hand a frame to `step`, read its pose
               back to the host, then hand the next (ComoSeq);
  cli          as the port's CLI feeds ComoPipeline: each frame is handed
               to `step` as soon as the engine takes it (`step` waits while
               five frames are queued); a pose comes back to the caller
               when a later `step` returns it.
A frame's latency runs from the call to `step` that hands it over to the
return of the call that gives its pose back to the caller.

A feed calls `tick` of the traced run's device trace (benchmark/
layers.py), which keys its frames session to a count: closed_loop passes
the window frames handed over, before each hand-over; cli the window
poses received, after each `step`, with the one frame in flight.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch


def build_engine(config: dict, K, device):
    """The configuration file's engine: the port's config defaults
    overridden by every key the file states."""
    from como_tpu_torch.config import load_config

    cfg = load_config(None, overrides=config["config"])
    if config["runtime"] == "seq":
        from como_tpu_torch.runtime.seq import ComoSeq as Engine
    elif config["runtime"] == "pipeline":
        from como_tpu_torch.runtime.pipeline import ComoPipeline as Engine
    else:
        raise ValueError(f"unknown runtime {config['runtime']!r}")
    eng = Engine(cfg, K, tuple(cfg.img_size), device=device)
    eng.setup()
    return eng


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _host_pose(pose):
    """The pose as the caller reads it: a host array (waits for the device)."""
    if pose is None:
        return None
    if isinstance(pose, torch.Tensor):
        return pose.detach().to("cpu").numpy()
    return np.asarray(pose)


def _finite(pose) -> bool:
    return pose is not None and bool(np.all(np.isfinite(pose)))


def warm_up(eng, stream, rule: dict) -> int:
    """Feed the stream from its first frame through the two-frame bootstrap
    (whose second keyframe goes through the whole insertion: the UNet
    prior, correspondence with both sampler calls, the predictor's prep)
    until `poses_after_bootstrap` poses of tracked frames came back (the
    tracking solve and the GN step).  An engine with stage queues
    (ComoPipeline) gets the next frame once the last has left them, so
    its bootstrap sees every frame, as ComoSeq's does (under the CLI's
    feed its mapping stage takes only the newest bootstrap frame).
    Returns the index of the next frame."""
    queues = [q for q in (getattr(eng, "rgb_q", None), getattr(eng, "frame_q", None)) if q]
    i = 0
    n_init = None
    while n_init is None or len(eng.timestamps) - n_init < int(rule["poses_after_bootstrap"]):
        if i >= int(rule["max_frames"]):
            raise RuntimeError(f"warm-up did not end within {i} frames")
        ts, rgb = stream.frame(i)
        _host_pose(eng.step(ts, rgb))
        i += 1
        while any(q.qsize() for q in queues) and getattr(eng, "_error", None) is None:
            # each look takes the interpreter lock from the stage threads,
            # whose launches need it; the mapping stage spends ~0.9 s on a
            # bootstrap frame, so looking 50 times a second delays nothing
            time.sleep(0.02)
        if n_init is None and eng.mapping.is_init:
            n_init = len(eng.timestamps)
    return i


def window_closed_loop(eng, stream, start: int, seconds: float, device, tick=None) -> dict:
    synchronize(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    lat, ok, frames = [], [], []
    i = start
    while True:
        ts, rgb = stream.frame(i)
        if tick is not None:
            tick(len(frames))
        ta = time.perf_counter()
        pose = _host_pose(eng.step(ts, rgb))
        tb = time.perf_counter()
        lat.append(tb - ta)
        ok.append(_finite(pose))
        frames.append(i)
        i += 1
        if tb >= deadline:
            break
    synchronize(device)
    t1 = time.perf_counter()
    return dict(t0=t0, t1=t1, frames=frames, latency_s=lat, ok=ok,
                received_in_window=int(sum(ok)), next_frame=i)


def window_cli(eng, stream, start: int, seconds: float, device, tick=None,
               drain_s: float = 60.0) -> dict:
    """The pipeline under the CLI's feed.  After the window closes, frames
    keep coming (as a camera's would) until every window frame's pose is
    back, or a later frame's pose came back first (the pose queue keeps only
    the newest pose for the caller: that frame's pose never comes, and the
    frame counts among `dropped`), or `drain_s` has passed."""
    synchronize(device)
    recv = {}                      # frame -> (seconds when its pose came back, finite)
    seen = [len(eng.timestamps)]

    def poll(tb):
        ts_list, poses = eng.timestamps, eng.est_poses
        for j in range(seen[0], len(ts_list)):
            recv.setdefault(stream.index_of(ts_list[j]), (tb, _finite(poses[j])))
        seen[0] = len(ts_list)

    t0 = time.perf_counter()
    poll(t0)
    before = set(recv)
    deadline = t0 + seconds
    handed = {}
    i = start
    while True:
        ts, rgb = stream.frame(i)
        ta = time.perf_counter()
        eng.step(ts, rgb)
        tb = time.perf_counter()
        handed[i] = ta
        poll(tb)
        if tick is not None:
            tick(len(recv) - len(before), lead=1)
        i += 1
        if tb >= deadline:
            break
    t1 = tb
    received_in_window = sum(1 for f, (tr, good) in recv.items() if f not in before and good)

    drain_end = t1 + drain_s
    while any(f not in recv and not (recv and max(recv) > f) for f in handed):
        if time.perf_counter() > drain_end:
            break
        ts, rgb = stream.frame(i)
        eng.step(ts, rgb)
        poll(time.perf_counter())
        i += 1
    drained_s = time.perf_counter() - t1
    frames = sorted(handed)
    lat = [recv[f][0] - handed[f] if f in recv else math.inf for f in frames]
    ok = [f in recv and recv[f][1] for f in frames]
    newest = max(recv, default=-1)
    dropped = sum(1 for f in frames if f not in recv and f < newest)
    return dict(t0=t0, t1=t1, frames=frames, latency_s=lat, ok=ok,
                received_in_window=received_in_window, next_frame=i, dropped=dropped,
                drain_s=drained_s)


FEEDS = {"closed_loop": window_closed_loop, "cli": window_cli}


def until_exercised(eng, stream, start: int, exercised, max_s: float = 90.0) -> int:
    """After a window that ran no keyframe insertion or no GN step, keep
    handing frames over (the camera's next ones) until both ran
    (`exercised(layer)`), or `max_s` passed, so that the check has a call
    of each to compare and the per-layer readers one to read.  Nothing of
    it is timed.  Returns the index of the next frame."""
    i = start
    end = time.perf_counter() + max_s
    while not (exercised("kf_insert") and exercised("gn")) and time.perf_counter() < end:
        ts, rgb = stream.frame(i)
        _host_pose(eng.step(ts, rgb))
        i += 1
    return i


def feed_of(config: dict, traffic: dict) -> str:
    feed = traffic["feed"][config["runtime"]]
    if feed not in FEEDS:
        raise ValueError(f"unknown feed {feed!r}")
    return feed


def stop_engine(eng) -> None:
    """End the engine's threads, if it has any (waits for them).  Frames
    still waiting in its input queue are taken out first, as a camera that
    stops leaves them untracked: nothing is measured or checked after the
    window's wraps closed, and each would cost a tracked frame."""
    rgb_q = getattr(eng, "rgb_q", None)
    if rgb_q is not None:
        rgb_q.pop_until_latest()
    if hasattr(eng, "shutdown"):
        eng.shutdown()
