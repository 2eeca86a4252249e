"""Spans and counters of the engine path, and a torch profiler hook.

`RECORDER` is the process's one recorder (like torch.profiler's, one per
process).  The engine path opens its spans and bumps its counters on it:

- a span (`RECORDER.span(name, frame=None, **payload)`, a `with` block)
  records its name; the thread, as (native id, pthread id as a signed
  32-bit int), the ids a CUDA runtime event in torch.profiler's trace
  carries for that thread; its parent, the span open around it on the same
  thread; the frame it serves (the timestamp handed to `ComoSeq.step`,
  inherited from the parent where not given); start and end on
  `time.time_ns()`, the clock of torch.profiler's events; the thread's CPU
  time at both ends on `time.thread_time_ns()`; and a small payload.
  Spans go into a bounded ring in memory (`RING` of them, over an hour of
  frames); nothing is written during a run.
- a counter (`RECORDER.count(name, n, key=None)`) is a host integer,
  optionally keyed (a kernel's launches by shape).
- a device counter (`RECORDER.count_device(name, tensor)`) keeps a
  reference to a small tensor the program has already computed, and copies
  it to the host only when read (`device_values`): no launch and no host
  synchronization on the hot path.

`enabled` (this module's attribute, on by default) switches all of it: off,
a span is a shared no-op and nothing is counted.  `write_log` is the one
exporter: the spans, one event each, and a closing summary, through a
utils/log.py::EventLog.

`trace` wraps a block in a torch.profiler trace and writes a Chrome trace
file.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np

enabled = True
RING = 65536


class Span(NamedTuple):
    name: str
    thread: tuple               # (native id, pthread id as a signed 32-bit int)
    t0: int                     # time.time_ns()
    t1: int
    cpu0: int                   # time.thread_time_ns()
    cpu1: int
    frame: Optional[float]      # the timestamp handed to ComoSeq.step
    id: int
    parent: int                 # the enclosing span's id on this thread, 0 at the root
    payload: Optional[dict]


class Mark(NamedTuple):
    t: int                      # time.time_ns() when it was taken
    counters: dict


def thread_keys() -> tuple:
    """The ids a CUDA runtime event may carry for the calling thread: its
    native id, or the low 32 bits of pthread_self as a signed int."""
    ident = threading.get_ident() & 0xFFFFFFFF
    return threading.get_native_id(), ident - (1 << 32) if ident >= 1 << 31 else ident


class _Off:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("rec", "name", "frame", "payload", "id", "parent", "t0", "cpu0", "local")

    def __init__(self, rec, name, frame, payload):
        self.rec, self.name, self.frame, self.payload = rec, name, frame, payload

    def __enter__(self):
        local = self.rec._thread()
        stack = local.stack
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else 0
        if self.frame is None and top is not None:
            self.frame = top.frame
        self.id = next(self.rec._ids)
        self.local = local
        stack.append(self)
        self.cpu0 = time.thread_time_ns()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        cpu1 = time.thread_time_ns()
        self.local.stack.pop()
        self.rec.spans.append(Span(self.name, self.local.keys, self.t0, t1, self.cpu0, cpu1,
                                   self.frame, self.id, self.parent, self.payload))
        return False


class Recorder:
    def __init__(self, ring: int = RING):
        self.ring = ring
        self.spans = deque(maxlen=ring)
        self.counters = {}          # {name: {key: n}}, key None where unkeyed
        self.device = {}            # {name: deque of (time_ns, frame, tensor)}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _thread(self):
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.keys = [], thread_keys()
        return local

    # -- recording ------------------------------------------------------------
    def span(self, name: str, frame: Optional[float] = None, **payload):
        """A `with` block recorded as one Span (see the module doc)."""
        if not enabled:
            return _OFF
        return _Open(self, name, frame, payload or None)

    def count(self, name: str, n: int = 1, key=None) -> None:
        if not enabled:
            return
        with self._lock:
            c = self.counters.setdefault(name, {})
            c[key] = c.get(key, 0) + n

    def count_device(self, name: str, tensor) -> None:
        """Keep `tensor` (computed by the program anyway) under `name`, with
        the time and the frame of the innermost open span; it is read on
        the host only by `device_values`."""
        if not enabled:
            return
        stack = self._thread().stack
        entry = (time.time_ns(), stack[-1].frame if stack else None, tensor)
        with self._lock:
            self.device.setdefault(name, deque(maxlen=self.ring)).append(entry)

    # -- reading --------------------------------------------------------------
    def counter(self, name: str, key=None) -> int:
        """A counter's value: summed over its keys, or under `key`."""
        c = self.counters.get(name, {})
        return c.get(key, 0) if key is not None else sum(c.values())

    def by_key(self, name: str) -> dict:
        return {k: n for k, n in self.counters.get(name, {}).items() if k is not None}

    def reset(self, *names: str) -> None:
        """Zero the named counters."""
        with self._lock:
            for name in names:
                self.counters.pop(name, None)

    def device_values(self, name: str, since: int = 0) -> list:
        """[(time_ns, frame, numpy value)] of a device counter's entries from
        `since` (time_ns) on, copied to the host here (one copy per device)."""
        import torch

        with self._lock:
            entries = [e for e in self.device.get(name, ()) if e[0] >= since]
        by_dev = {}
        for i, e in enumerate(entries):
            by_dev.setdefault(e[2].device, []).append(i)
        values = [None] * len(entries)
        for idx in by_dev.values():
            host = torch.stack([entries[i][2] for i in idx]).cpu().numpy()
            for i, v in zip(idx, host):
                values[i] = v
        return [(t, frame, v) for (t, frame, _), v in zip(entries, values)]

    def mark(self) -> Mark:
        with self._lock:
            return Mark(time.time_ns(), {k: dict(c) for k, c in self.counters.items()})

    def summary(self, since: Optional[Mark] = None) -> dict:
        """{"spans": {name: count, total / median / p90 ms}, "counters":
        {name: n or {key: n}}, "device_counters": {name: summed value}}
        of what was recorded since the mark (everything without one)."""
        t, base = (since.t, since.counters) if since is not None else (0, {})
        times = {}
        for s in list(self.spans):
            if s.t0 >= t:
                times.setdefault(s.name, []).append((s.t1 - s.t0) * 1e-6)
        spans = {name: dict(count=len(v), total_ms=float(np.sum(v)),
                            median_ms=float(np.median(v)), p90_ms=float(np.percentile(v, 90)))
                 for name, v in sorted(times.items())}
        counters = {}
        for name, c in sorted(self.counters.items()):
            was = base.get(name, {})
            diff = {k: n - was.get(k, 0) for k, n in c.items() if n != was.get(k, 0)}
            if not diff:
                continue
            if list(diff) == [None]:
                counters[name] = diff[None]
            else:
                counters[name] = {_key_text(k): n for k, n in diff.items()}
        device = {}
        for name in sorted(self.device):
            vals = [v for _, _, v in self.device_values(name, since=t)]
            if vals:
                device[name] = np.sum(vals, axis=0).tolist()
        return dict(spans=spans, counters=counters, device_counters=device)


def _key_text(key) -> str:
    if key is None:
        return "all"
    return "x".join(map(str, key)) if isinstance(key, tuple) else str(key)


RECORDER = Recorder()


def write_log(log, since: Optional[Mark] = None) -> None:
    """The exporter: every span recorded since the mark as one "span" event
    of `log` (a utils/log.py::EventLog), times on the time.time_ns() clock,
    then one "summary" event (Recorder.summary)."""
    t = since.t if since is not None else 0
    for s in list(RECORDER.spans):
        if s.t0 >= t:
            log.emit("span", **{**s._asdict(), "thread": list(s.thread)})
    log.emit("summary", **RECORDER.summary(since))
    log.flush()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace (CPU, and CUDA when there is a device) around a
    block; writes <log_dir>/trace.json, viewable in chrome://tracing or
    Perfetto.  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
