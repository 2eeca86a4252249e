"""Structured event log (jsonl).

The reference's observability is print statements + GUI labels (SURVEY.md
section 5.5).  Here engines emit typed events (frame, insertion, gn,
refresh) to a jsonl file and/or an in-memory ring for dashboards/tests.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Optional


class EventLog:
    def __init__(self, path: Optional[str] = None, ring: int = 1000):
        self._f = open(path, "a") if path else None
        self.ring = deque(maxlen=ring)
        self._t0 = time.monotonic()

    def emit(self, kind: str, **fields):
        ev = {"t": round(time.monotonic() - self._t0, 4), "kind": kind, **fields}
        self.ring.append(ev)
        if self._f is not None:
            self._f.write(json.dumps(ev) + "\n")

    def flush(self):
        if self._f is not None:
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def counts(self):
        out = {}
        for ev in self.ring:
            out[ev["kind"]] = out.get(ev["kind"], 0) + 1
        return out


NULL_LOG = EventLog(path=None, ring=1)
