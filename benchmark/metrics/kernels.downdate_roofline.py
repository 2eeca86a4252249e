"""kernels: the greedy sampler's downdate pass's share of its roofline, in
%: the least time its calls' work needs (benchmark/rooflines/downdate.py)
over the device time of every kernel launched inside those calls, summed
over the calls in the profiled frames and insertion."""


def read(run):
    return run.roofline_share("downdate")
