"""tracking: host ms per tracked frame, the mean of the spans around
odom/tracking.py::track_frame outside the profiled frames."""


def read(run):
    spans = run.spans_named("tracking", profiled=False)
    return 1e-6 * sum(s[3] - s[2] for s in spans) / len(spans) if spans else None
