"""tracking: host ms per launched inverse-compositional iteration: the host
time of the program's "tracking.ic_level" spans (one per pyramid level,
around its masked solve) over the iterations they launched (their
payload), in the traced run's range (the earliest start to the latest end
of the benchmark's own spans, on the same clock), outside the device
trace's sessions (CUPTI slows launches there).  None where the program
records no such span."""


def read(run):
    try:
        from como_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    if not run.spans:
        return None
    lo, hi = min(s[2] for s in run.spans), max(s[3] for s in run.spans)
    spans = [s for s in list(RECORDER.spans)
             if s.name == "tracking.ic_level" and lo <= s.t0 and s.t1 <= hi
             and not any(s.t0 < x["t1"] and x["t0"] < s.t1 for x in run.sessions)]
    launched = sum(s.payload["launched"] for s in spans)
    return 1e-6 * sum(s.t1 - s.t0 for s in spans) / launched if launched else None
