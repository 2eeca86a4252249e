"""tracking: device kernels per tracked frame, counted in the device trace
of the profiled frames: every kernel whose launch (a kernel launch, or the
replay of a CUDA graph that holds it) started inside a span around
track_frame, over the number of those spans."""


def read(run):
    sess = run.session("frames")
    if sess is None:
        return None
    spans = [s for s in run.spans_named("tracking")
             if sess["t0"] <= s[2] and s[3] <= sess["t1"]]
    if not spans:
        return None
    return len(run.kernels_in(spans, sess)) / len(spans)
