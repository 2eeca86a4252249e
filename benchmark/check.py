"""Whether what the window produced is correct: the plain reference
(benchmark/reference/) recomputes, once the window has closed, each
stage the window ran from the inputs that stage got (the program's own
state at that moment: whole-run poses are chaotic, so a run is not
compared end to end), and each number is held to its limit
(benchmark/limits/default.json, overridden by benchmark/limits/<cell>.json
where that exists).

Numbers (the largest over what was compared):
  track_t_m        tracking: |t| gap of the pose against the keyframe (m),
                   on frames drawn from the seed
  track_rot_rad    tracking: rotation angle between the two poses
  track_aff        tracking: largest gap of the affine (log gain, bias)
  track_stats_rel  tracking: relative gap of the decision stats (pixels
                   reprojected, median depth)
  decide_mismatch  keyframe / one-way decisions that differ from the
                   reference's rule on the frame's own stats (every frame)
  gn_rel           mapping GN step, on steps drawn from the seed: |d_prog -
                   d_ref| / |d_ref|, d = the step's change of the keyframe
                   and one-way poses and affines, anchor log-depths and
                   landmarks
  unet_rel         the UNet prior's covariance image at each insertion:
                   |cov_prog - cov_ref| / |cov_ref|
  cross_cov_rel    the cross-covariance calls over the whole image (N = H W):
                   max |K_prog - K_ref| / max |K_ref|
  depth_rel        each new keyframe's dense depth from its predictor
                   (its anchors, log-depths and covariance image):
                   max |z_prog - z_ref| / z_ref
  sampler_gap      the greedy sampler's choices, scored slot by slot with
                   the program's earlier choices: the largest (best -
                   chosen) / best of the reference's score
  uncaptured       layers that the engine's own state shows ran in the
                   window (two or more GN iterations, two or more new
                   keyframes: one may straddle the window's start on a
                   stage thread) with no call of theirs captured, as where
                   a change fused, graph-captured or renamed the entry the
                   wraps hold (benchmark/hooks.py): exact, limit 0
Every number is compared in every run unless the mix's traffic file lists
fewer under "required" (`required_of`); the window goes on, untimed, until
an insertion and a GN step ran (benchmark/drive.py, `until_exercised`), and
a required number with nothing to compare makes the run not correct.
`control=True` puts the reference in the program's place, computed one
precision lower (TF32 matmuls and convolutions for the f32 stages,
fp8 convolutions for the bf16 UNet, bf16 for the elementwise
cross-covariance and the sampler's scores): benchmark/tests/test_control.py.
"""

from __future__ import annotations

import contextlib
import json
import math

import numpy as np
import torch

from benchmark import spec

N_TRACK = 4           # tracked frames recomputed per run
SCALE = 1.0           # the DepthCov prior's signal variance k(x, x)
NUMBERS = ("track_t_m", "track_rot_rad", "track_aff", "track_stats_rel", "decide_mismatch",
           "gn_rel", "unet_rel", "cross_cov_rel", "depth_rel", "sampler_gap", "uncaptured")


def required_of(traffic: dict) -> tuple:
    """The numbers every run of the mix compares: its "required" list, or
    all of them."""
    req = tuple(traffic.get("required", NUMBERS))
    unknown = set(req) - set(NUMBERS)
    if unknown:
        raise ValueError(f"traffic {traffic.get('name')!r} requires unknown numbers {unknown}")
    return req


def limits_of(cell: str) -> dict:
    with open(spec.HERE / "limits" / "default.json") as f:
        lim = json.load(f)["limits"]
    path = spec.HERE / "limits" / f"{cell}.json"
    if path.is_file():
        with open(path) as f:
            lim.update(json.load(f)["limits"])
    return lim


@contextlib.contextmanager
def tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _rot_gap(Ra, Rb) -> float:
    """|Ra - Rb|_F / sqrt(2): the angle between two rotations where it is
    small, and free of the rounding of an arccos near 1."""
    return float(torch.linalg.norm((Ra - Rb).double()) / math.sqrt(2.0))


def _reference_track(c, ref, rgb, K, cfg, lowp: bool):
    from benchmark.reference.odom import tracking as rt
    from benchmark.reference.odom.frontend import tracking_kernels as tk

    tc, pyr = cfg["tracking"]["term_criteria"], cfg["tracking"]["pyr"]
    term = tk.TermStatic(max_iter=tc["max_iter"], delta_norm=tc["delta_norm"],
                         rel_tol=tc["rel_tol"], grad_norm=tc["grad_norm"],
                         abs_tol=tc["abs_tol"], estimate_affine=cfg["tracking"]["estimate_affine"])
    _, kf_rgb, kf_pose, _, depth = ref
    color = cfg["tracking"]["color"]
    with tf32(lowp):
        levels = rt.build_reference(kf_rgb, kf_pose, depth, K, pyr["start_level"],
                                    pyr["end_level"], pyr["depth_interp_mode"], color)
        return rt.track_frame(levels, rgb, c["T_init"], c["aff_init"], c["T_w_kf"], term,
                              pyr["start_level"], pyr["end_level"], c["img_hw"], color)


def _track_gaps(prog, ref) -> dict:
    Tp, ap, _, sp = prog
    Tr, ar, _, sr = ref
    sp, sr = sp.double().cpu(), sr.double().cpu()
    return {"track_t_m": float(torch.linalg.norm((Tp[:3, 3] - Tr[:3, 3]).double())),
            "track_rot_rad": _rot_gap(Tp[:3, :3], Tr[:3, :3]),
            "track_aff": float((ap - ar).abs().max()),
            "track_stats_rel": float(max(abs(sp[0] - sr[0]) / max(abs(float(sr[0])), 1.0),
                                         abs(sp[1] - sr[1]) / max(abs(float(sr[1])), 1e-9)))}


def _decisions(captured, kcfg, track_stats=None) -> int:
    """Decisions the reference's rule makes differently on the same stats
    (or, with `track_stats` {ts: (prog stats, ref stats)}, on the
    reference's stats of those frames)."""
    from benchmark.reference.odom.tracking import decide

    bad = 0
    for d in captured["decide"]:
        stats, kind = d["stats"], d["kind"]
        if track_stats is not None:
            if d["ts"] not in track_stats:
                continue
            stats, ref_stats = track_stats[d["ts"]]
            kind, _ = decide(ref_stats, d["ts"], d["kf_received_ts"], d["num_kf_pixels"],
                             d["promoted"], d["before"], kcfg)
        got, _ = decide(stats, d["ts"], d["kf_received_ts"], d["num_kf_pixels"],
                        d["promoted"], d["before"], kcfg)
        bad += int(got != kind)
    return bad


def _reference_gn(g, cfg, lowp: bool):
    from benchmark.reference.odom import window as rw
    from benchmark.reference.odom.backend import gn_step as rg

    state, pr, pt, pv, K = g["inputs"]
    st = rw.WindowState(**{name: getattr(state, name) for name in rw.WindowState.__dataclass_fields__})
    dims = rw.WindowDims(*tuple(g["dims"]))
    m = cfg["mapping"]
    s = m["sigmas"]
    sigmas = rg.SigmaStatic(
        mean_depth_prior=s["mean_depth_prior"], scale_prior=s["scale_prior"],
        pose_prior=s["pose_prior"], gp_prior=s["gp_prior"], log_depth_first=s["log_depth_first"],
        log_depth_all=s["log_depth_all"], pixel_first=s["pixel_first"], pixel_all=s["pixel_all"],
        log_depth_mode=s["log_depth_mode"], pixel_mode=s["pixel_mode"],
        far_depth_ratio=s["far_depth_ratio"], lm_step_frac=s["lm_step_frac"],
        occlusion_thresh=s["occlusion_thresh"], estimate_affine=m["estimate_affine"])
    with tf32(lowp):
        new, _ = rg._gn_step_impl(st, pr, pt, pv, K, dims, sigmas, m["gn_damping"])
    return new


GN_FIELDS = ("kf_pose", "kf_aff", "logzm", "ow_pose", "ow_aff", "P_lm")


def _gn_rel(g, out_prog, out_ref) -> float:
    state = g["inputs"][0]
    d_prog = torch.cat([(out_prog[f] - getattr(state, f)).reshape(-1).double() for f in GN_FIELDS])
    d_ref = torch.cat([(getattr(out_ref, f) - getattr(state, f)).reshape(-1).double()
                       for f in GN_FIELDS])
    return float(torch.linalg.norm(d_prog - d_ref) / torch.clamp(torch.linalg.norm(d_ref),
                                                                 min=1e-30))


def _uncaptured(captured) -> int:
    ran = captured.get("engine") or {}
    return (int((ran.get("gn") or 0) >= 2 and not captured["gn"])
            + int((ran.get("kf_insert") or 0) >= 2 and not captured["insert"]))


def judge(captured, stream, config, cell: str, device, seed: int = 0,
          required: tuple = NUMBERS, control: bool = False):
    """Returns (correct, {number: {"value", "limit"}})."""
    from benchmark.reference import gp
    from benchmark.reference import prior as rprior

    cfg = config["config"]
    cell_limits = limits_of(cell)
    rng = np.random.default_rng([seed % 2 ** 63, 3])
    vals = {k: None for k in NUMBERS}

    def worst(key, v):
        vals[key] = v if vals[key] is None else max(vals[key], v)

    with tf32(False):
        # tracking, on frames drawn from the seed
        frame_of = {f.data_ptr(): i for i, f in enumerate(stream.frames)}
        tracks = captured["track"]
        pick = sorted(rng.choice(len(tracks), size=min(N_TRACK, len(tracks)), replace=False)) \
            if tracks else []
        track_stats = {}
        for j in pick:
            c = tracks[j]
            i = frame_of[c["rgb_ptr"]]
            rgb = stream.frames[i]
            ref = captured["refs"][c["ref"]]
            out_ref = _reference_track(c, ref, rgb, stream.K, cfg, lowp=False)
            out_prog = (_reference_track(c, ref, rgb, stream.K, cfg, lowp=True) if control
                        else c["out"])
            for k, v in _track_gaps(out_prog, out_ref).items():
                worst(k, v)
            track_stats[i / stream.hz] = (out_prog[3].double().cpu().numpy(),
                                          out_ref[3].double().cpu().numpy())
        kcfg = cfg["tracking"]["keyframing"]
        vals["decide_mismatch"] = float(_decisions(captured, kcfg,
                                                   track_stats if control else None))

        for g in captured["gn"]:
            out_ref = _reference_gn(g, cfg, lowp=False)
            if control:
                low = _reference_gn(g, cfg, lowp=True)
                out_prog = {f: getattr(low, f) for f in GN_FIELDS}
            else:
                out_prog = g["out"]
            worst("gn_rel", _gn_rel(g, out_prog, out_ref))

        if captured["insert"]:
            net = rprior.load(str(spec.ROOT / cfg["mapping"]["model_path"]), device)
            for ins in captured["insert"]:
                cov_ref = rprior.cov_params(net, ins["rgb"])
                cov_prog = rprior.cov_params(net, ins["rgb"], fp8=True) if control \
                    else ins["cov_img"]
                worst("unet_rel", float(torch.linalg.norm((cov_prog - cov_ref).double())
                                        / torch.linalg.norm(cov_ref.double())))
                z_ref = gp.dense_depth(ins["cov_img"], ins["coords"], ins["logzm"], SCALE)
                if control:
                    with tf32(True):
                        z_prog = gp.dense_depth(ins["cov_img"], ins["coords"], ins["logzm"],
                                                SCALE)
                else:
                    z_prog = torch.exp(ins["Knm_full"] @ ins["logzm"])
                worst("depth_rel", float(((z_prog - z_ref).abs() / z_ref).max()))
            del net
        for cc in captured["cross_cov"]:
            k_ref = gp.cross_covariance(*cc["inputs"], cc["scale"])
            k_prog = gp.cross_covariance(*cc["inputs"], cc["scale"], dtype=torch.bfloat16) \
                if control else cc["out"]
            worst("cross_cov_rel", float((k_prog - k_ref).abs().max() / k_ref.abs().max()))
        for sc in captured["sampler"]:
            chosen = sc["out"].domain_inds
            if control:
                chosen = gp.greedy_choices(sc["inputs"], sc["kw"], dtype=torch.bfloat16)
            gap, _ = gp.sampler_gaps(sc["inputs"], sc["kw"], chosen)
            worst("sampler_gap", gap)
    vals["uncaptured"] = float(_uncaptured(captured))

    checks = {}
    ok = True
    for k in NUMBERS:
        lim = cell_limits[k]
        v = vals[k]
        checks[k] = {"value": v, "limit": lim}
        if v is None:
            ok = ok and k not in required
        else:
            ok = ok and math.isfinite(v) and v <= lim
    return ok, checks
