"""tracking: the tracking thread's CPU time over wall time (%) inside the
program's "tracking.track_frame" spans (time.thread_time_ns against
time.time_ns, read at both ends of each span), in the traced run's range
(the earliest start to the latest end of the benchmark's own spans, on the
same clock), outside the device trace's sessions.  No host read of device
values happens inside the span, so a shortfall is time the OS gave the
thread no CPU.  None where the program records no such span."""


def read(run):
    try:
        from como_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    if not run.spans:
        return None
    lo, hi = min(s[2] for s in run.spans), max(s[3] for s in run.spans)
    spans = [s for s in list(RECORDER.spans)
             if s.name == "tracking.track_frame" and lo <= s.t0 and s.t1 <= hi
             and not any(s.t0 < x["t1"] and x["t0"] < s.t1 for x in run.sessions)]
    wall = sum(s.t1 - s.t0 for s in spans)
    return 100.0 * sum(s.cpu1 - s.cpu0 for s in spans) / wall if wall > 0 else None
