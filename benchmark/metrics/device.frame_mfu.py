"""device: the profiled frames' share of the chip's f32 peak, in %: the
operations their work needs, counted from the configuration's shapes,
over the frames' seconds times the f32 peak (benchmark/peaks.py).

Counted, per call in the frames session:
  tracking   each pyramid level's sites (every pixel of the level) at one
             inverse-compositional iteration a level, the least a solve
             takes (the iterations a solve used are not observable from
             outside the program): per site and iteration the operations
             of the reference's iteration (benchmark/reference/odom/
             frontend/tracking_kernels.py, `_gn_iter`), written out in
             IC_SITE_OPS;
  gn         the GN step's dense solve of its D x D system (D = 8 K + 8 O
             + 3 L, L = K M landmarks): the Cholesky factorization (D^3/3)
             and the two triangular solves (2 D^2);
  rooflines  each roofline function's operations (benchmark/rooflines/).
Not counted: the GN step's linearization and assembly, the insertion's
UNet and correspondence, the medians; so the share is a lower bound."""

from benchmark import peaks, spec

PARAMS = 8                                  # 6 pose + 2 affine parameters
IC_SITE_OPS = {
    "warp": 18 + 6,                         # R P + t; projection through K
    "sample": 16,                           # bilinear: 4 weights, 4 multiply-adds
    "residual": 3,                          # exp(-a) I + b - I_ref
    "weight": 5,                            # r / sigma, Huber, valid / sigma^2
    "normal_equations": PARAMS + 2 * PARAMS * PARAMS + 2 * PARAMS,  # J w; Jw^T J; Jw^T r
    "error": 3,                             # sum of w r^2
}


def ops_per_tracked_frame(cfg) -> float:
    H, W = cfg["img_size"]
    pyr = cfg["tracking"]["pyr"]
    sites = sum((H >> lv) * (W >> lv) for lv in range(pyr["start_level"], pyr["end_level"]))
    return sum(IC_SITE_OPS.values()) * sites


def ops_per_gn_step(cfg) -> float:
    g, m = cfg["mapping"]["graph"], cfg["mapping"]["sampling"]
    K, O = g["num_keyframes"], g["num_one_way_frames"]
    D = 8 * K + 8 * O + 3 * K * m["max_num_coords"]
    return D ** 3 / 3 + 2 * D ** 2


def read(run):
    sess = run.session("frames")
    if sess is None:
        return None
    cfg = spec.load_config(spec.find_cell(run.bench, run.cell)["config"])["config"]

    def inside(s):
        return sess["t0"] <= s[2] and s[3] <= sess["t1"]

    ops = ops_per_tracked_frame(cfg) * sum(1 for s in run.spans_named("tracking") if inside(s))
    ops += ops_per_gn_step(cfg) * sum(1 for s in run.spans_named("gn") if inside(s))
    for c in run.calls:
        if inside(c):
            ops += spec.load_module("rooflines", c[0]).nops(**c[4])
    seconds = (sess["t1"] - sess["t0"]) * 1e-9
    return 100.0 * ops / (seconds * peaks.peaks_of(run.kind)["f32_flops_per_s"])
