"""mapping backend: host ms per GN step, the mean of the spans around
odom/backend/gn_step.py::_gn_step_impl outside the profiled frames (all
of them where every step was profiled)."""


def read(run):
    spans = run.spans_named("gn", profiled=False) or run.spans_named("gn")
    return 1e-6 * sum(s[3] - s[2] for s in spans) / len(spans) if spans else None
