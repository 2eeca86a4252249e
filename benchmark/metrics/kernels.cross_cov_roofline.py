"""kernels: the GP cross-covariance's share of its roofline, in %: the
least time its calls' work needs (benchmark/rooflines/cross_cov.py) over
the device time of every kernel launched inside those calls, summed over
the calls in the profiled frames and insertion."""


def read(run):
    return run.roofline_share("cross_cov")
