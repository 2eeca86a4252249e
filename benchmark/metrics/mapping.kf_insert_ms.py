"""mapping: host ms per keyframe insertion, the mean of the spans around
odom/mapping.py::Mapping.add_keyframe (the UNet prior, correspondence
with its two sampler calls, the predictor's prep and the window writes)
in the window, or in the frames the traced run goes on for when the
window held none; the profiled insertion is among them."""


def read(run):
    spans = run.spans_named("kf_insert")
    return 1e-6 * sum(s[3] - s[2] for s in spans) / len(spans) if spans else None
