"""runtime: keyframes inserted per 100 frames handed over in the window
(says whether the mix does what it claims)."""


def read(run):
    frames = len(run.window["frames"])
    return 100.0 * run.window["calls"].get("kf_insert", 0) / frames if frames else None
