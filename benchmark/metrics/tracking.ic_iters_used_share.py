"""tracking: the share (%) of the launched inverse-compositional iterations
that the solves used, over the tracked frames of the traced run's range
(from the earliest start to the latest end of the benchmark's own spans,
on the same clock): the iterations each pyramid level ran before its
convergence test fired (the program's device counter
"tracking.ic_iters_used", the count track_pyramid returns, copied to the
host only here) over the iterations the levels launched (the payload of
the program's "tracking.ic_level" spans).  None where the program records
neither (como_tpu_torch.utils.profiling has no RECORDER, or it is off)."""


def read(run):
    try:
        from como_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    if not run.spans:
        return None
    lo, hi = min(s[2] for s in run.spans), max(s[3] for s in run.spans)
    launched = sum(s.payload["launched"] for s in list(RECORDER.spans)
                   if s.name == "tracking.ic_level" and lo <= s.t0 and s.t1 <= hi)
    used = sum(int(v.sum()) for t, _, v in RECORDER.device_values("tracking.ic_iters_used",
                                                                  since=lo) if t <= hi)
    return 100.0 * used / launched if launched else None
