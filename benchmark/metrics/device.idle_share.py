"""device: the share (%) of the profiled frames' span in which no
operation ran on the device."""


def read(run):
    sess = run.session("frames")
    if sess is None:
        return None
    busy, window, _ = run.busy(sess)
    return 100.0 * (1.0 - busy / window) if window > 0 else None
