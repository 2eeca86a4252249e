"""mapping: host ms per greedy-sampler call, the mean of the program's
"gp.sampler" spans (around gp/sampler.py::greedy_entropy_sample's 64-step
loop; two a keyframe insertion) in the traced run's range (the earliest
start to the latest end of the benchmark's own spans, on the same clock),
outside the device trace's sessions; all of them where every call was
profiled.  None where the program records no such span."""


def read(run):
    try:
        from como_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    if not run.spans:
        return None
    lo, hi = min(s[2] for s in run.spans), max(s[3] for s in run.spans)
    spans = [s for s in list(RECORDER.spans)
             if s.name == "gp.sampler" and lo <= s.t0 and s.t1 <= hi]
    quiet = [s for s in spans
             if not any(s.t0 < x["t1"] and x["t0"] < s.t1 for x in run.sessions)]
    spans = quiet or spans
    return 1e-6 * sum(s.t1 - s.t0 for s in spans) / len(spans) if spans else None
