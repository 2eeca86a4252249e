#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (como_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in this order, one JSON line each:
  device     nvidia-smi card line, torch / CUDA versions
  build      compile the hand-written CUDA kernels (csrc/*.cu), seconds
  kernel     each kernel against its plain PyTorch version at main-path
             shapes (inputs from a rendered 192x256 clutter frame): max
             abs/rel error, kernel / plain time, bound.  One line for the
             sampler downdate (64 x 49,152) and one per shape class of the
             cross-covariance (49,152 x 64, 64 x 64, 1 x 64), each with a
             bitwise-repeat check
  plane      ComoSeq on the 25-frame plane sequence at 192x256 with
             configs/como.yml: the accuracy guard (ATE < PLANE_ATE_GUARD_M)
  main_path  ComoSeq on 120 clutter frames at 192x256 with configs/como.yml:
             frames, KF/OW counts, ATE, FPS, latencies, kernel launches
             (the cross-covariance's also by shape)
  layers     one GN iteration and one frame's tracking on the final window
  profile    device time by kernel over a few more frames, idle share
  determinism two GN steps on the final full-size window: bitwise equal
  total      seconds the script took
Then the kernel table line {"kernels": [...]}, the nvidia-smi card line,
and last {"ok": true, "device": {...}}.  Any failed check raises and the
script exits non-zero; without a CUDA device, or without the repository
beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = HERE / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12      # H100 SXM f32, non-tensor-core
CROSS_COV_OPS = 36           # f32 operations per (n, m) element (special functions = 1)
TOL_ABS, TOL_REL = 1e-5, 1e-4
N_TIMED = 30
# Accuracy guard of the `plane` phase: the JAX package's own bound for this
# sequence (tests/test_e2e_seq.py).  Three runs on an H100 (the kernels, their
# plain versions, scene seed 1) all gave less than half of it (PERF.md).
PLANE_ATE_GUARD_M = 0.02


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, n: int = N_TIMED, warmup: int = 3) -> float:
    """Host-clock milliseconds per call (median of n, each ended by a
    synchronize): what a caller waits, launch overhead included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def device_ms(fn, n: int = N_TIMED, warmup: int = 3):
    """Device milliseconds per call: the summed time of the CUDA kernels fn
    launches (torch.profiler), averaged over n calls; and the kernel
    launches per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    return busy_us / 1e3 / n, sum(e.count for e in kern) / n


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def errors(got, want):
    d = (got - want).abs()
    rel = d / want.abs().clamp(min=1e-30)
    ok = bool(((d <= TOL_ABS + TOL_REL * want.abs()) | (got == want)).all())
    return float(d.max()), float(rel[want.abs() > 1e-6].max()) if (want.abs() > 1e-6).any() else 0.0, ok


def ate_m(eng, ds) -> float:
    """Scale-aligned ATE of an engine's poses against the dataset's."""
    import torch

    from como_tpu_torch.utils.io import ate_rmse

    idx = (torch.tensor(eng.timestamps) * ds.fps).round().long().numpy()
    return ate_rmse(eng.poses_numpy(), ds.poses[idx], with_scale=True)


def main() -> int:
    t_script = time.perf_counter()
    if not (HERE / "como_tpu_torch").is_dir() or not (HERE / "configs" / "como.yml").is_file():
        print("chip_smoke.py: the como_tpu_torch package and configs/ must sit beside "
              "this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this check runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    OUT.mkdir(exist_ok=True)
    dev = torch.device("cuda")

    # ---- 1. device ---------------------------------------------------------
    card = card_line()
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # ---- 2. build ----------------------------------------------------------
    from como_tpu_torch import cuda_lib

    t0 = time.perf_counter()
    info = cuda_lib.build()
    (OUT / "chip_smoke_ptxas.txt").write_text(json.dumps(info.get("ptxas", {}), indent=1))
    emit("build", seconds=round(time.perf_counter() - t0, 3), compiled=info["compiled"])

    from como_tpu_torch.config import load_config
    from como_tpu_torch.data.synthetic import SyntheticDataset
    from como_tpu_torch.gp import kernels_cuda, sampler, sampler_cuda
    from como_tpu_torch.net.depthcov import DepthCovPrior
    from como_tpu_torch.odom.backend.gn_step import _gn_step_impl
    from como_tpu_torch.odom.tracking import track_frame
    from como_tpu_torch.runtime.seq import ComoSeq

    cfg = load_config(str(HERE / "configs" / "como.yml"))
    H, W = cfg.img_size
    ds = SyntheticDataset(n_frames=120, img_size=(H, W), seed=0, scene="clutter",
                          device=dev)
    frames = [ds[i] for i in range(len(ds))]
    torch.cuda.synchronize()

    # ---- 3. kernel: each kernel against its plain version -------------------
    scfg = cfg.mapping.sampling
    cov_img = DepthCovPrior().cov_params(frames[0][1])
    dom, e_dom, dom_valid, _ = sampler.full_image_domain(cov_img, scfg.border)
    D, S = dom.shape[0], scfg.max_num_coords
    zeros = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
    samp_args = (dom, e_dom, dom_valid, zeros(S, 2), zeros(S, 3),
                 zeros(S, dt=torch.bool), zeros(S), 1.0, scfg.fixed_var,
                 scfg.max_stdev_thresh, scfg.dist_thresh, S, False)
    res_k, obs_k, var_k, _ = sampler.greedy_entropy_loop(*samp_args)
    res_p, obs_p, var_p, _ = sampler.greedy_entropy_loop(
        *samp_args, downdate=sampler_cuda.downdate_step_plain)
    same_inds = bool(torch.equal(res_k.domain_inds, res_p.domain_inds))
    dd_abs, dd_rel, dd_ok = errors(torch.cat([obs_k.reshape(-1), var_k]),
                                   torch.cat([obs_p.reshape(-1), var_p]))
    # one step timed on the state the 64-step loop ends with (last row
    # cleared, as it is when the loop reaches it)
    xnT, enT = dom.T.contiguous(), e_dom.T.contiguous()
    buf = [obs_k.clone(), var_k.clone(), torch.full_like(var_k, float("inf"))]
    buf[0][S - 1] = 0.0
    i_best = int(torch.argmax(var_k))
    sc = torch.cat([dom[i_best], e_dom[i_best],
                    torch.tensor([1.0 / 0.7, 1.0, 1.0], device=dev)])
    l_ni = obs_k[:, i_best].contiguous()
    l_ni[S - 1] = 0.0
    dd_ms, _ = device_ms(lambda: sampler_cuda.downdate_step(xnT, enT, *buf, sc, l_ni, S - 1))
    dd_plain_ms, dd_plain_k = device_ms(lambda: sampler_cuda.downdate_step_plain(
        xnT, enT, *buf, sc, l_ni, S - 1))
    dd_call_ms = time_ms(lambda: sampler_cuda.downdate_step(xnT, enT, *buf, sc, l_ni, S - 1))
    samp_ms = time_ms(lambda: sampler.greedy_entropy_loop(*samp_args), n=5)
    samp_plain_ms = time_ms(lambda: sampler.greedy_entropy_loop(
        *samp_args, downdate=sampler_cuda.downdate_step_plain), n=5)
    samp_dev_ms, samp_kernels = device_ms(lambda: sampler.greedy_entropy_loop(*samp_args), n=3)
    dd_bytes = 4 * (S * D + 5 * D + 4 * D + D + S + 8)
    dd_bound, dd_by = bound(dd_bytes, D * (CROSS_COV_OPS + 2 * S + 8))
    emit("kernel", name="sampler_downdate", shape=[S, D],
         compared="obs_info and var after the full 64-step sampler call",
         max_abs_err=dd_abs, max_rel_err=dd_rel, tol=[TOL_ABS, TOL_REL], ok=dd_ok,
         sampler_domain_inds_identical=same_inds, ms=dd_ms, plain_ms=dd_plain_ms,
         plain_kernels_per_call=dd_plain_k, call_ms=dd_call_ms,
         bound_ms=dd_bound, bound_by=dd_by, sampler_call_ms=samp_ms,
         sampler_call_plain_ms=samp_plain_ms, sampler_call_device_ms=samp_dev_ms,
         sampler_call_kernels=samp_kernels, sampler_call_bound_ms=S * dd_bound,
         library_ms=None, library="no single PyTorch call computes this step")
    if not (dd_ok and same_inds):
        raise SystemExit("sampler downdate kernel disagrees with its plain version")

    # cross-covariance at its three main-path shape classes: all H*W sites x
    # the M = 64 anchors just sampled (keyframe insertion), M x M (K_mm) and
    # 1 x M (once per sampler iteration)
    x_m, e_m = res_k.coords_norm.contiguous(), res_k.covs.contiguous()
    M = x_m.shape[0]
    cc_shapes = []
    one = slice(i_best, i_best + 1)
    for x_n, e_n in ((dom, e_dom), (x_m, e_m), (dom[one], e_dom[one])):
        args = (x_n.contiguous(), e_n.contiguous(), x_m, e_m, 1.0)
        Nn = x_n.shape[0]
        got = kernels_cuda.cross_covariance(*args)
        repeat = bool(torch.equal(got, kernels_cuda.cross_covariance(*args)))
        cc_abs, cc_rel, cc_ok = errors(got, kernels_cuda.cross_covariance_plain(*args))
        cc_ms, _ = device_ms(lambda: kernels_cuda.cross_covariance(*args))
        cc_plain_ms, cc_plain_k = device_ms(lambda: kernels_cuda.cross_covariance_plain(*args))
        cc_call_ms = time_ms(lambda: kernels_cuda.cross_covariance(*args))
        cc_bound, cc_by = bound(4 * (5 * Nn + 5 * M + Nn * M), CROSS_COV_OPS * Nn * M)
        cc_shapes.append(dict(shape=[Nn, M], max_abs_err=cc_abs, max_rel_err=cc_rel, ms=cc_ms,
                              plain_ms=cc_plain_ms, bound_ms=cc_bound, bound_by=cc_by))
        emit("kernel", name="cross_covariance", tol=[TOL_ABS, TOL_REL], ok=cc_ok,
             two_launches_bitwise_equal=repeat, plain_kernels_per_call=cc_plain_k,
             call_ms=cc_call_ms, library_ms=None,
             library="no single PyTorch call computes this function", **cc_shapes[-1])
        if not cc_ok:
            raise SystemExit("cross-covariance kernel disagrees with its plain version "
                             f"at {Nn} x {M}")
        if not repeat:
            raise SystemExit(f"two cross-covariance launches at {Nn} x {M} differ")

    # ---- 4. plane: the accuracy guard --------------------------------------
    # The 25-frame plane sequence of the JAX package's end-to-end test
    # (step 0.012), at full size with the default config, both kernels
    # launched.  Unlike the clutter run below, its ATE does not move with the
    # kernels' rounding (PERF.md), so a guard on it judges a kernel change.
    ds_p = SyntheticDataset(n_frames=25, img_size=(H, W), seed=0, scene="plane", step=0.012,
                            device=dev)
    eng_p = ComoSeq(cfg, ds_p.intrinsics, (H, W), device="cuda")
    eng_p.setup()
    kernels_cuda.cross_covariance.launches = 0
    sampler_cuda.downdate_step.launches = 0
    t0 = time.perf_counter()
    for i in range(len(ds_p)):
        ts, rgb = ds_p[i]
        eng_p.step(float(ts), rgb)
    eng_p.finish()
    torch.cuda.synchronize()
    plane_ate = ate_m(eng_p, ds_p)
    plane_launches = {"cross_covariance": kernels_cuda.cross_covariance.launches,
                      "sampler_downdate": sampler_cuda.downdate_step.launches}
    emit("plane", frames=len(ds_p), frames_tracked=len(eng_p.timestamps),
         num_kf=eng_p.mapping.num_kf, num_ow=eng_p.mapping.num_ow, ate_m=plane_ate,
         guard_m=PLANE_ATE_GUARD_M, launches=plane_launches,
         seconds=time.perf_counter() - t0)
    if min(plane_launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched in the plane phase: {plane_launches}")
    if not plane_ate < PLANE_ATE_GUARD_M:
        raise SystemExit(f"plane ATE {plane_ate:.4f} m exceeds the {PLANE_ATE_GUARD_M} m guard")
    del eng_p, ds_p

    # ---- 5. main_path: ComoSeq, 120 clutter frames -------------------------
    eng = ComoSeq(cfg, ds.intrinsics, (H, W), device="cuda")
    eng.setup()
    kf_ms = []
    add_kf = eng.mapping.add_keyframe

    def timed_add_keyframe(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        add_kf(*a)
        torch.cuda.synchronize()
        kf_ms.append((time.perf_counter() - t) * 1e3)

    eng.mapping.add_keyframe = timed_add_keyframe
    torch.cuda.reset_peak_memory_stats()
    kernels_cuda.cross_covariance.launches = 0
    kernels_cuda.cross_covariance.launches_by_shape.clear()
    sampler_cuda.downdate_step.launches = 0
    lat = []
    t_start = None
    for i, (ts, rgb) in enumerate(frames):
        if i == 20:
            t_start = time.perf_counter()
        t = time.perf_counter()
        eng.step(float(ts), rgb)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    eng.finish()
    torch.cuda.synchronize()
    fps = (len(frames) - 20) / (time.perf_counter() - t_start)
    launches = {"cross_covariance": kernels_cuda.cross_covariance.launches,
                "sampler_downdate": sampler_cuda.downdate_step.launches}
    by_shape = {f"{n}x{k}": c for (n, k), c in
                sorted(kernels_cuda.cross_covariance.launches_by_shape.items(), reverse=True)}
    ate = ate_m(eng, ds)
    m = eng.mapping
    finite = bool(torch.isfinite(torch.as_tensor(eng.poses_numpy())).all())
    steady = lat[20:]
    emit("main_path", frames=len(frames), frames_tracked=len(eng.timestamps),
         num_kf=m.num_kf, num_ow=m.num_ow, kf_insertions=len(kf_ms),
         total_gn_iters=m.total_iters, ate_m=ate, fps_after_20=fps,
         frame_ms_median=statistics.median(steady),
         frame_ms_p90=sorted(steady)[int(0.9 * (len(steady) - 1))],
         kf_insert_ms_median=statistics.median(kf_ms) if kf_ms else None,
         launches=launches, cross_covariance_launches_by_shape=by_shape,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         poses_finite=finite)
    (OUT / "chip_smoke_latency_ms.json").write_text(json.dumps(
        {"frame_ms": lat, "kf_insert_ms": kf_ms}))
    if not finite:
        raise SystemExit("main path produced non-finite poses")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched on the main path: {launches}")
    # Checks that catch a lost tracker, not a rounding change: this run is
    # chaotic, and 20 runs on an H100 (seeds 0-9, with the kernels and with
    # their plain versions) gave ATEs of 0.04-0.45 m (PERF.md).  Accuracy is
    # judged by the plane phase above.
    if len(eng.timestamps) < 110:
        raise SystemExit(f"main path tracked only {len(eng.timestamps)} of {len(frames)} frames")
    if not 6 <= m.num_kf <= 9:
        raise SystemExit(f"main path ended with {m.num_kf} keyframes, expected 6 to 9")
    if not ate < 0.5:
        raise SystemExit(f"main-path ATE {ate:.4f} m exceeds 0.5 m: the tracker is lost")

    # ---- 6. layers: on the final full-size window, one GN iteration and one
    # frame's tracking
    gn_args = (m.state, *m._pairs, m.K, m.dims, m.sigmas, m.damping)
    gn_ms = time_ms(lambda: _gn_step_impl(*gn_args), n=20)
    gn_dev_ms, gn_kernels = device_ms(lambda: _gn_step_impl(*gn_args), n=5)
    tr = eng.tracking

    def track_once():
        track_frame(tr.levels, frames[-1][1], tr.T_curr_kf, tr.aff_curr_kf, tr.T_w_kf,
                    tr.term, tr.cfg.pyr.start_level, tr.cfg.pyr.end_level, (H, W),
                    tr.cfg.color)

    track_ms = time_ms(track_once, n=5)
    track_dev_ms, track_kernels = device_ms(track_once, n=2)
    emit("layers", gn_iter_ms_median=gn_ms, gn_iter_device_ms=gn_dev_ms,
         gn_iter_kernels=gn_kernels, track_frame_ms_median=track_ms,
         track_frame_device_ms=track_dev_ms, track_frame_kernels=track_kernels)

    # ---- 7. profile: device kernel time by name over a few more frames,
    # against the unprofiled median frame time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof_frames = [(float(ts) + 10.0 + k / ds.fps, rgb) for k, (ts, rgb)
                   in enumerate(frames[-4:])]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for ts, rgb in prof_frames:
            eng.step(ts, rgb)
        eng.finish()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    kern = sorted((e for e in ka if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / len(prof_frames)
    (OUT / "chip_smoke_profile.txt").write_text(ka.table(
        sort_by="self_device_time_total", row_limit=50))
    frame_med = statistics.median(steady)
    emit("profile", frames=len(prof_frames), device_busy_ms_per_frame=busy_ms,
         frame_ms_median_unprofiled=frame_med,
         device_idle_share=1.0 - busy_ms / frame_med,
         kernel_launches_per_frame=sum(e.count for e in kern) / len(prof_frames),
         top_kernels_ms_per_frame={e.key[:70]: e.self_device_time_total / 1e3 / len(prof_frames)
                                   for e in kern[:8]})

    # ---- 8. determinism: two GN steps on the same full-size state ----------
    s1, g1 = _gn_step_impl(*gn_args)
    s2, g2 = _gn_step_impl(*gn_args)
    same = all(torch.equal(getattr(s1, f), getattr(s2, f)) for f in s1.fields()) \
        and all(torch.equal(a, b) for a, b in zip(g1, g2))
    emit("determinism", gn_steps_bitwise_equal=same, dims=list(m.dims))
    if not same:
        raise SystemExit("two GN steps on the same state differ")

    emit("total", seconds=time.perf_counter() - t_script)
    # the cross-covariance entry's own keys are those of its full-size shape;
    # "shapes" holds every timed shape class with its main-path launches
    for sh in cc_shapes:
        sh["launches"] = by_shape.get("{}x{}".format(*sh["shape"]), 0)
    full = cc_shapes[0]
    table = [
        dict(name="cross_covariance", route="cuda", source="como_tpu_torch/csrc/gp_kernels.cu",
             replaces="como_tpu/gp/kernels_pallas.py:95", launches=launches["cross_covariance"],
             max_abs_err=full["max_abs_err"], ms=full["ms"], plain_ms=full["plain_ms"],
             bound_ms=full["bound_ms"], bound_by=full["bound_by"], library_ms=None,
             shapes=cc_shapes, launches_by_shape=by_shape),
        dict(name="sampler_downdate", route="cuda",
             source="como_tpu_torch/csrc/sampler_kernels.cu",
             replaces="como_tpu/gp/sampler_pallas.py:96", launches=launches["sampler_downdate"],
             max_abs_err=dd_abs, ms=dd_ms, plain_ms=dd_plain_ms, bound_ms=dd_bound,
             bound_by=dd_by, library_ms=None),
    ]
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
