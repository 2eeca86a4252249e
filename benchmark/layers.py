"""The traced run (--trace 1): the device trace of a few window frames,
and the per-layer metrics read from it and from the host spans.

torch.profiler (CUDA activity only: the CUDA runtime's calls and the
device's kernels, copies and sets, no CPU operator events) is on for
  session "frames": window frames FRAMES_FROM .. FRAMES_FROM+FRAMES-1,
      from the call to `step` that hands the first over to the call that
      hands the one after the last;
  session "insert": the window's first keyframe insertion on the main
      thread (ComoSeq's), when the frames session is not running.
Each session's events are read in memory when it stops; nothing is
written to disk.  A kernel belongs to the call in whose host span its
launch (the runtime call with the same correlation id) started, on the
same thread: so a roofline share reads the work of the function called,
whatever kernels implement it.  A CUDA graph's replay is one runtime call
(cudaGraphLaunch) whose correlation id every kernel of the graph carries:
each of those kernels belongs to the span of the replay, and what is
counted is kernels, not runtime calls.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict

import torch

from benchmark import peaks, spec

FRAMES_FROM = 2
FRAMES = 3
# the runtime and driver calls that put kernels on the device
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
                "cudaGraphLaunch_v10000", "cuGraphLaunch")


def thread_keys() -> tuple:
    """The ids a runtime event may carry for the calling thread: its
    native id, or the low 32 bits of pthread_self as a signed int."""
    ident = threading.get_ident() & 0xFFFFFFFF
    return threading.get_native_id(), ident - (1 << 32) if ident >= 1 << 31 else ident


def split_events(events):
    """A session's profiler events as (device operations, kernels,
    launches): operations and kernels as (start, end, name, correlation
    id), launches as {correlation id: (start, thread id)}.  A kernel is a
    device operation whose correlation id is a launch's: one per kernel,
    also where one replay of a graph launched many."""
    launches, ops = {}, []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                        e.correlation_id()))
        elif e.name() in LAUNCH_NAMES:
            launches[e.correlation_id()] = (e.start_ns(), e.device_resource_id())
    kernels = [op for op in ops if op[3] in launches]
    return ops, kernels, launches


class DeviceTrace:
    def __init__(self, device):
        self.device = torch.device(device)
        self.active = False
        self.prof = None
        self.label = None
        self.sessions = []          # dicts: label, t0, t1 (time_ns), kernels, launches
        self.lock = threading.Lock()
        self.insert_seen = False
        self.stop_at = None

    def warm(self) -> None:
        """Start the profiler once outside the window (its first start takes
        seconds)."""
        self.start("warm")
        torch.zeros(1, device=self.device).add_(1)
        self.stop()
        self.sessions.clear()

    def start(self, label: str) -> bool:
        from torch.profiler import ProfilerActivity, profile

        with self.lock:
            if self.active:
                return False
            self.active = True
        self.label = label
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.time_ns()
        return True

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        t1 = time.time_ns()
        self.prof.__exit__(None, None, None)
        ops, kernels, launches = split_events(self.prof.profiler.kineto_results.events())
        self.sessions.append(dict(label=self.label, t0=self.t0, t1=t1, ops=ops,
                                  kernels=kernels, launches=launches))
        self.prof = None
        with self.lock:
            self.active = False

    # -- called by the feed and the hooks --------------------------------------
    def tick(self, k: int) -> None:
        """Before the window's k-th frame is handed over: the frames
        session starts at FRAMES_FROM (or the first frame after it at which
        no other session runs) and covers FRAMES frames."""
        if self.stop_at is None and k >= FRAMES_FROM:
            if self.start("frames"):
                self.stop_at = k + FRAMES
        elif k == self.stop_at and self.label == "frames" and self.active:
            self.stop()

    def around_insert(self, call):
        """Run a keyframe insertion; the window's first on the main thread
        is profiled (inside the frames session if that is running, else in
        a session of its own).  An insertion on another thread (the
        pipeline's mapping stage) is not: a session started and stopped
        there left the next frames session without the other threads'
        kernels (one traced pipeline run in three, PERF.md)."""
        if self.insert_seen or threading.current_thread() is not threading.main_thread():
            return call()
        self.insert_seen = True
        if not self.start("insert"):
            return call()
        try:
            return call()
        finally:
            self.stop()

    def close(self) -> None:
        if self.active:
            self.stop()


# -- reading ----------------------------------------------------------------------

def _merge(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


class TracedRun:
    """What the readers of benchmark/metrics/ read: the window, the host
    spans, the roofline calls and the device trace's sessions."""

    def __init__(self, bench, cell, window, captured, tracer, kind):
        self.bench, self.cell, self.window = bench, cell, window
        self.spans = captured["spans"]
        self.calls = captured["calls"]
        self.sessions = tracer.sessions if tracer is not None else []
        self.kind = kind

    def session(self, label):
        for s in self.sessions:
            if s["label"] == label:
                return s
        return None

    def spans_named(self, name, profiled=None):
        return [s for s in self.spans if s[0] == name and (profiled is None or s[4] == profiled)]

    @staticmethod
    def _by_launch(session):
        """The session's kernels sorted by the start of their launch:
        (launch times, [(launch time, thread id, kernel)])."""
        if "_by_launch" not in session:
            rows = sorted((session["launches"][k[3]][0], session["launches"][k[3]][1], k)
                          for k in session["kernels"])
            session["_by_launch"] = ([r[0] for r in rows], rows)
        return session["_by_launch"]

    def kernels_in(self, spans, session) -> list:
        """Kernels of `session` launched inside one of `spans` (same thread)."""
        times, rows = self._by_launch(session)
        out = []
        for s in spans:
            keys = s[1] if isinstance(s[1], tuple) else (s[1],)
            lo, hi = bisect.bisect_left(times, s[2]), bisect.bisect_right(times, s[3])
            out.extend(k for _, tid, k in rows[lo:hi] if tid in keys)
        return out

    def roofline_share(self, fname):
        """Percent: the least time the calls' work needs over the device
        time of every kernel launched inside them, summed over every call
        the sessions hold; None without a call."""
        mod = spec.load_module("rooflines", fname)
        need = used = 0.0
        n = 0
        for sess in self.sessions:
            calls = [c for c in self.calls if c[0] == fname and sess["t0"] <= c[2] <= sess["t1"]]
            for c in calls:
                ks = self.kernels_in([c], sess)
                if not ks:
                    continue
                used += sum(t - s for s, t, _, _ in ks) * 1e-9
                need += peaks.bound_s(mod.nbytes(**c[4]), mod.nops(**c[4]), self.kind)
                n += 1
        return 100.0 * need / used if n and used > 0 else None

    def busy(self, session):
        """(busy seconds, window seconds) of a session: the union of the
        device's operations over the session's span."""
        iv = _merge([(max(s, session["t0"]), min(t, session["t1"]))
                     for s, t, _, _ in session["ops"] if t > session["t0"] and s < session["t1"]])
        busy = sum(t - s for s, t in iv) * 1e-9
        return busy, (session["t1"] - session["t0"]) * 1e-9, iv


def breakdown(run: TracedRun) -> dict:
    """The device operations that took most time (all sessions) and the
    frames session's idle time by the host span open during it (the
    innermost; "harness" where none is)."""
    by_name = defaultdict(float)
    for sess in run.sessions:
        for s, t, name, _ in sess["ops"]:
            by_name[name[:64]] += (t - s) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = defaultdict(float)
    sess = run.session("frames")
    if sess is not None:
        _, _, iv = run.busy(sess)
        edges = [sess["t0"]] + [x for pair in iv for x in pair] + [sess["t1"]]
        spans = sorted((s for s in run.spans if s[3] > sess["t0"] and s[2] < sess["t1"]),
                       key=lambda s: s[3] - s[2])             # innermost first
        cuts = sorted({t for s in spans for t in (s[2], s[3])})
        for a, b in zip(edges[0::2], edges[1::2]):
            pts = [a] + cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)] + [b]
            for x, y in zip(pts, pts[1:]):
                mid = (x + y) // 2
                name = next((s[0] for s in spans if s[2] <= mid <= s[3]), "harness")
                gaps[name] += (y - x) * 1e-9
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def per_layer(bench, cell_name, window, captured, tracer):
    """(metrics, breakdown, device busy / window seconds) of a traced run."""
    kind = torch.cuda.get_device_name(tracer.device) if tracer is not None else "cpu"
    run = TracedRun(bench, cell_name, window, captured, tracer, kind)
    metrics = {}
    for m in spec.metrics_of(bench, cell_name, "per_layer"):
        value = spec.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    busy = {}
    sess = run.session("frames")
    if sess is not None:
        b, w, _ = run.busy(sess)
        busy = {"busy_s": b, "window_s": w}
    return metrics, breakdown(run) if run.sessions else None, busy
