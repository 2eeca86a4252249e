#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (como_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in this order, one JSON line each:
  device     nvidia-smi card line, torch / CUDA versions
  build      compile the hand-written CUDA kernels (csrc/*.cu), seconds
  queues     compile the native queue ring (native/como_runtime.cpp, g++) and
             check that runtime.queues.make_queue hands it out
  kernel     each kernel against its plain PyTorch version at main-path
             shapes (inputs from a rendered 192x256 clutter frame): max
             abs/rel error, kernel / plain time, bound.  One line for the
             sampler downdate (64 x 49,152) and one per shape class of the
             cross-covariance (49,152 x 64, the SfM pyramid's 12,288 x 64 and
             3,072 x 64, 64 x 64, 1 x 64), each with a bitwise-repeat check;
             then the cross-covariance's backward kernel at its training
             shapes (64 x 64 with one anchor set on both sides, 1,024 x 64)
             and at 49,152 x 64 against autograd of the plain version:
             max abs error against the largest |grad|, bitwise repeat, one
             kernel per call (torch.profiler)
  unet       the learned prior (net/depthcov.py, models/depthcov.msgpack) on
             a fixed image against tests/data/unet_golden.npz, written by the
             JAX package (tests/torch_make_unet_golden.py): f32 and bf16
             convolutions, two passes bitwise equal, device ms per forward
  train      python -m como_tpu_torch.train.train_depthcov's main at full
             width (the shipped UNet, bf16 convolutions, random weights from a
             seed) on synthetic data, TRAIN_STEPS steps with multires and
             --val_every TRAIN_VAL_EVERY: finite loss and gradient norm on
             every step, both cross-covariance kernels launched, first / last
             loss, best val score; host and device ms and kernels per step at
             96x128 and 192x256; the saved EMA read back by load_params and
             run as the UNet prior on one frame
  plane      ComoSeq on the 25-frame plane sequence at 192x256 with
             configs/como.yml: the accuracy guard (ATE < PLANE_ATE_GUARD_M)
  main_path  ComoSeq on 120 clutter frames at 192x256 with configs/como.yml:
             frames, KF/OW counts, ATE, FPS, latencies, kernel launches
             (the cross-covariance's also by shape)
  cli        como_tpu_torch.cli.main on 45 clutter frames with
             configs/como_unet.yml (the UNet prior in bf16), no --device: the
             trajectory file parses, frames / keyframes / ATE, both kernels
             launched
  rgb        ComoSeq on 15 plane_chroma frames with color: rgb in tracking
             and mapping: ATE under the plane guard, both kernels launched
  pipeline   como_tpu_torch.cli.main --runtime pipeline (ComoPipeline: two
             stage threads over the native ring) on 60 clutter frames, default
             config, no --device: trajectory file, frames / keyframes / ATE,
             FPS, poses dropped by pose_q, per-thread CPU share, both kernels
             launched
  pipeline_plane  ComoPipeline on the 25-frame plane sequence: the pipeline's
             accuracy guard (ATE < PLANE_ATE_GUARD_M)
  runtimes   ComoSeq on the same plane sequence with dispatch_depth 2 +
             frame_batch 2 and with dispatch_depth 2 + resolve_stride 2 (each
             twice, bitwise equal), and with tracking.device cuda:0 /
             mapping.device cuda:1 (the unfused step; on one card its poses
             equal the plane phase's bit for bit): ATE under the guard, one
             pose per frame from the bootstrap on, both kernels launched
  layers     one GN iteration and one frame's tracking on the final window
  profile    device time by kernel over two more frames, idle share
  determinism two GN steps on the final full-size window: bitwise equal
  viz        como_tpu_torch.cli.main --viz on 15 plane frames, no --device, in
             chiprun_out/viz/ (headless: the snapshot viewer): one PNG per
             viewer call, each 384x512x3 with overlay pixels, no failed
             snapshot, both kernels launched; render_map on the card against
             the same call on the CPU (the main path's final window), device
             ms per render
  mesh       the sharded GN step (parallel/sharded.py) over 2 and 8 shards of
             this card against the single step, on the main path's final
             window and on the 18 KF / 48 OW stress window: global sigma
             bitwise equal, photometric grids within 1e-5, update within the
             JAX package's tolerances (tests/test_multichip.py), whether it
             is the single step's bit for bit, two sharded steps bitwise
             equal, host ms per step (the single step's spread under a
             reversal of its pairs is reported beside); then ComoSeq with
             mapping.mesh_devices: 2 (raises on a one-card host; runs the
             plane sequence on two or more cards)
  entry_points  each measurement entry point's main(argv) in this process at a
             small depth, no --device (python -m como_tpu_torch.bench: every
             cell, seed 0 at 30 frames, a 25-frame probe engine; eval_matrix,
             run_full on the plane sequence; bench_runtimes, profile_e2e,
             profile_gn, probe_pair_throughput), reports under
             chiprun_out/entry_points/: seconds and launches of each; the bench
             line's keys, finite values, positive rates, ATE < 0.5 m,
             iterations per level within [1, max_iter], both kernels launched;
             the plane ATEs under the guard (eval_matrix's equal to the plane
             phase's where ComoConfig() is configs/como.yml); finite rows,
             stage times and rates
  total      seconds the script took
Then the kernel table line {"kernels": [...]}, the nvidia-smi card line,
and last {"ok": true, "device": {...}}.  Any failed check raises and the
script exits non-zero; without a CUDA device, or without the repository
beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import re
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
CROSS_COV_BWD_OPS = 84       # the backward's, per element (its sums included)
TOL_ABS, TOL_REL = 1e-5, 1e-4
N_TIMED = 30
# Accuracy guard of the `plane` phase: the JAX package's own bound for this
# sequence (tests/test_e2e_seq.py).  Three runs on an H100 (the kernels, their
# plain versions, scene seed 1) all gave less than half of it (PERF.md).
PLANE_ATE_GUARD_M = 0.02
# The UNet prior against the JAX package's golden output: f32 convolutions
# within UNET_F32_TOL (abs, rel); bf16 convolutions within the bf16 floor
# (median relative difference, max abs), which is what JAX's own bf16 run
# differs from its f32 run by (tests/test_torch_unet.py).
# The sharded step against the single step: tests/test_multichip.py's
# tolerances (total_err rtol, kf_pose atol, P_lm atol), on the default window
# and on the 18 KF / 48 OW stress window; the photometric grids of the linear
# system within MESH_GRID_RTOL of the largest entry.
MESH_TOL = (1e-3, 1e-4, 1e-3)
MESH_STRESS_TOL = (1e-3, 2e-2, 5e-3)
MESH_GRID_RTOL = 1e-5
# render_map on the card against the CPU: depth within VIZ_DEPTH_RTOL where
# both are set; colours within VIZ_COLOUR_ATOL (the shading's depth
# gradients are convolutions, summed in another order on each device) on
# all but VIZ_COLOUR_SHARE of the pixels (a projection's truncation to a
# pixel, or a z-buffer tie, flips with ulp-level differences).
VIZ_DEPTH_RTOL = 1e-5
VIZ_COLOUR_ATOL = 1e-5
VIZ_COLOUR_SHARE = 0.01
# Depths of two earlier paths, cut (from 60 and 25 frames) when the runtime
# phases were added, to keep the whole script well inside its time limit on a
# slow host; both still bootstrap and insert keyframes.
CLI_FRAMES = 45
RGB_FRAMES = 15
UNET_F32_TOL = (5e-4, 1e-3)
UNET_BF16_FLOOR = (2e-2, 0.5)
# The train phase: steps of the trainer's own run, and its validation period.
TRAIN_STEPS = 60
TRAIN_VAL_EVERY = 20
INFERENCE_KERNELS = ("cross_covariance", "sampler_downdate")
# The entry_points phase: python -m como_tpu_torch.bench's line has the JAX
# bench's keys (bench.py) less the transport ones, plus tracking_iters_per_level
# and card; its e2e cell runs ENTRY_BENCH_FRAMES frames of one seed.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_EXTRA_KEYS = {"mapping_gn_iter_ms", "gn_vs_50ms_budget", "stress", "e2e_fps",
                    "e2e_median_ms", "e2e_p90_ms", "e2e_ate_cm", "e2e_per_seed",
                    "frame_program_throughput_fps", "e2e_dispatch_depth", "e2e_frame_batch",
                    "e2e_world", "device", "tracking_iters_per_level", "card"}
BENCH_SEED_KEYS = {"fps", "ate_cm", "median_ms", "p90_ms", "frames_tracked", "seed", "n_runs",
                   "path_len_m"}
ENTRY_BENCH_FRAMES = 30


T_START = time.perf_counter()


def emit(phase: str, **kw):
    """One JSON line; `at_s` is the script's clock when the phase ended."""
    print(json.dumps({"phase": phase, "at_s": round(time.perf_counter() - T_START, 1), **kw}),
          flush=True)


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


PROFILES_LOST = []      # the labels of device_ms readings whose profiles lost events


def device_ms(fn, n: int = N_TIMED, warmup: int = 3, label: str = ""):
    """Device milliseconds per call: the summed time of the CUDA kernels fn
    launches (torch.profiler), averaged over n calls; the kernel launches
    per call; and the profiles' record: the kernels counted in each profile
    taken (`profile_kernel_counts`) and `profile_events_lost`.  A profile
    whose count is not a multiple of n either lost events (seen once on an
    H100: 0.4 kernels per call of a two-kernel function) or profiled a
    function whose kernels vary from call to call.  So it is taken again,
    up to three times, and kept once its count is a multiple of n or equals
    the previous profile's (a count that repeats is the function's own,
    lost events are not); otherwise the last profile is the reading,
    `profile_events_lost` is true, and `label` joins PROFILES_LOST, which
    the `total` phase prints."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        counts.append(sum(e.count for e in kern))
        kept = counts[-1] > 0 and (counts[-1] % n == 0 or counts[-1] in counts[:-1])
        if kept:
            break
    if not kept:
        PROFILES_LOST.append(label or getattr(fn, "__name__", "?"))
    busy_us = sum(e.self_device_time_total for e in kern)
    return busy_us / 1e3 / n, counts[-1] / n, dict(profile_kernel_counts=counts,
                                                  profile_events_lost=not kept)


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def errors(got, want):
    d = (got - want).abs()
    rel = d / want.abs().clamp(min=1e-30)
    ok = bool(((d <= TOL_ABS + TOL_REL * want.abs()) | (got == want)).all())
    return float(d.max()), float(rel[want.abs() > 1e-6].max()) if (want.abs() > 1e-6).any() else 0.0, ok


def golden_image(seed: int, hw):
    """(1, 3, H, W) f32 in [0, 1): the input of tests/data/unet_golden.npz
    (tests/torch_make_unet_golden.py carries the same function; exact f32
    arithmetic, so the bytes do not depend on the numpy version)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = hw
    coarse = rng.random((3, h // 8, w // 8), dtype=np.float32)
    fine = rng.random((3, h, w), dtype=np.float32)
    blocks = np.kron(coarse, np.ones((1, 8, 8), np.float32))
    return (np.float32(0.8) * blocks + np.float32(0.2) * fine)[None]


def unet_golden_errors(cov, want, f32: bool) -> dict:
    """A prior output (numpy, sub-sampled like the golden) against the
    golden: max abs and median relative difference, and whether it is
    within UNET_F32_TOL (f32) or UNET_BF16_FLOOR (bf16)."""
    import numpy as np

    d = np.abs(cov - want)
    med_rel = float(np.median(d / np.maximum(np.abs(want), 1e-12)))
    if f32:
        ok = bool((d <= UNET_F32_TOL[0] + UNET_F32_TOL[1] * np.abs(want)).all())
    else:
        ok = med_rel <= UNET_BF16_FLOOR[0] and float(d.max()) <= UNET_BF16_FLOOR[1]
    return dict(max_abs_err=float(d.max()), median_rel_err=med_rel, ok=ok)


# {kernel: the recorder's counter of its launches, keyed by shape}
LAUNCH_COUNTERS = {"cross_covariance": "kernels.cross_covariance",
                   "cross_covariance_bwd": "kernels.cross_covariance_bwd",
                   "sampler_downdate": "kernels.downdate"}


def reset_launches():
    from como_tpu_torch.utils.profiling import RECORDER

    RECORDER.reset(*LAUNCH_COUNTERS.values())


def launches_per_shape(kernel: str) -> dict:
    """{"NxM": launches} of a kernel since reset_launches()."""
    from como_tpu_torch.utils.profiling import RECORDER

    return {f"{n}x{k}": c for (n, k), c in
            sorted(RECORDER.by_key(LAUNCH_COUNTERS[kernel]).items(), reverse=True)}


def read_launches(names=INFERENCE_KERNELS):
    """({kernel: launches} of `names`, {"NxM": cross-covariance launches})
    since reset_launches()."""
    from como_tpu_torch.utils.profiling import RECORDER

    return ({k: RECORDER.counter(LAUNCH_COUNTERS[k]) for k in names},
            launches_per_shape("cross_covariance"))


def ate_m(eng, ds) -> float:
    """Scale-aligned ATE of an engine's poses against the dataset's."""
    import torch

    from como_tpu_torch.utils.io import ate_rmse

    idx = (torch.tensor(eng.timestamps) * ds.fps).round().long().numpy()
    return ate_rmse(eng.poses_numpy(), ds.poses[idx], with_scale=True)


def mesh_case(dev, state, pairs, K_intr, dims, sigmas, damping, n, tol) -> dict:
    """The sharded GN step over n shards of `dev` against the single step on
    one window: global sigma, the linear system's photometric grids, the
    update, repeatability, host ms per step.  The single step's own spread
    is reported beside: the single step with its pairs in reverse order
    (the same system, its grid sums reassociated)."""
    import torch

    from como_tpu_torch.odom.backend import gn_step as gs
    from como_tpu_torch.parallel import sharded

    step = sharded.make_sharded_gn_step([dev] * n, dims, sigmas, damping)
    s1, g1 = gs._gn_step_impl(state, *pairs, K_intr, dims, sigmas, damping)
    s2, g2 = step(state, *pairs, K_intr)
    s3, g3 = step(state, *pairs, K_intr)
    s_rev, _ = gs._gn_step_impl(state, *(a.flip(0) for a in pairs), K_intr, dims, sigmas,
                                damping)
    repeat = all(torch.equal(getattr(s2, f), getattr(s3, f)) for f in s2.fields()) \
        and all(torch.equal(a, b) for a, b in zip(g2, g3))
    # the photometric linearization and sigma, sharded and single
    sc = gs._scaffold(state, K_intr, dims, sigmas.far_depth_ratio)
    st = state.replace(P_lm=sc["P_lm_new"])
    dn = gs._dense_points(st, sc, K_intr, dims)
    occl = sigmas.occlusion_thresh
    photo_n, sig_n = sharded.photo_over_shards([dev] * n, st, sc, dn, *pairs, K_intr, dims,
                                               sigmas)
    sig_1 = gs.photo_sigma([gs._photo_residual(st, sc, dn, *pairs, K_intr, dims, occl)], dev)
    photo_1 = gs._photo(st, sc, dn, *pairs, K_intr, dims, occl, sigmas.estimate_affine)
    grid_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                   for a, b in zip(photo_n, photo_1))

    def maxdiff(a, b, f):
        return float((getattr(a, f) - getattr(b, f)).abs().max())

    out = dict(shards=n, pairs=int(pairs[0].shape[0]), sigma=float(sig_1),
               sigma_bitwise_equal=bool(torch.equal(sig_n, sig_1)),
               grids_max_rel_err=grid_err,
               total_err_rel_err=float(abs(g2.total_err - g1.total_err)
                                       / abs(g1.total_err)),
               kf_pose_max_abs_err=maxdiff(s2, s1, "kf_pose"),
               P_lm_max_abs_err=maxdiff(s2, s1, "P_lm"),
               single_reversed_pairs_kf_pose_max_abs_diff=maxdiff(s_rev, s1, "kf_pose"),
               single_reversed_pairs_P_lm_max_abs_diff=maxdiff(s_rev, s1, "P_lm"),
               window_bitwise_equal_to_single=all(torch.equal(getattr(s1, f), getattr(s2, f))
                                                  for f in s1.fields()),
               total_err_finite=bool(torch.isfinite(g1.total_err)),
               two_steps_bitwise_equal=repeat,
               ms=time_ms(lambda: step(state, *pairs, K_intr), n=10, warmup=1),
               single_ms=time_ms(lambda: gs._gn_step_impl(state, *pairs, K_intr, dims,
                                                          sigmas, damping), n=10, warmup=1))
    # the update within the JAX package's tolerance
    out["ok"] = (out["sigma_bitwise_equal"] and repeat and out["total_err_finite"]
                 and grid_err <= MESH_GRID_RTOL and out["total_err_rel_err"] <= tol[0]
                 and out["kf_pose_max_abs_err"] <= tol[1]
                 and out["P_lm_max_abs_err"] <= tol[2])
    return out


def render_case(viz, K_intr, dev) -> dict:
    """render_map of a window's viz data from the snapshot viewer's camera,
    on `dev` and on the CPU: depth and colour differences, device ms."""
    import torch

    from como_tpu_torch.geometry.lie import se3_exp
    from como_tpu_torch.viz.renderer import render_map

    poses = viz["poses"].to(dev)
    T_view = poses[-1] @ se3_exp(torch.tensor([0.25, 0.0, 0.0, 0.0, -0.15, -0.8],
                                              device=dev))
    args = (viz["rgbs"].to(dev), viz["depths"].to(dev), poses,
            torch.ones(poses.shape[0], dtype=torch.bool, device=dev), K_intr.to(dev), T_view)
    rgb_d, depth_d = render_map(*args)
    rgb_2, depth_2 = render_map(*args)
    rgb_c, depth_c = render_map(*(a.cpu() for a in args))
    rgb_d, depth_d = rgb_d.cpu(), depth_d.cpu()
    both = (depth_c > 0) & (depth_d > 0)
    rel = ((depth_d - depth_c).abs() / depth_c.clamp(min=1e-30))[both]
    # a pixel whose colour moved by more than the shading's rounding took
    # another candidate's colour
    colour_diff = (rgb_d - rgb_c).abs().amax(-1)
    colour_share = float((colour_diff > VIZ_COLOUR_ATOL).float().mean())
    ms, kernels, prof = device_ms(lambda: render_map(*args), n=10, label="render_map")
    out = dict(keyframes=int(poses.shape[0]), out_size=list(rgb_d.shape),
               covered_share=float((depth_d > 0).float().mean()),
               set_pixels_differ=int(((depth_c > 0) != (depth_d > 0)).sum()),
               depth_max_rel_err=float(rel.max()) if rel.numel() else 0.0,
               colour_differs_share=colour_share,
               colour_max_abs_err_elsewhere=float(colour_diff[colour_diff <= VIZ_COLOUR_ATOL]
                                                  .max()),
               two_renders_bitwise_equal=bool(torch.equal(rgb_d, rgb_2.cpu())
                                              and torch.equal(depth_d, depth_2.cpu())),
               device_ms=ms, kernels_per_render=kernels, device_profile=prof,
               call_ms=time_ms(lambda: render_map(*args), n=10))
    out["ok"] = (out["two_renders_bitwise_equal"] and out["depth_max_rel_err"] <= VIZ_DEPTH_RTOL
                 and colour_share <= VIZ_COLOUR_SHARE and out["covered_share"] > 0)
    return out


def run_tool(main_fn, argv, out_name: str):
    """A measurement entry point's main(argv), in this process, between a
    reset and a read of the launch counts.  Its stdout goes to
    chiprun_out/entry_points/<out_name>.txt.  Returns (seconds, stdout
    lines, {kernel: launches})."""
    import torch

    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = main_fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, _ = read_launches()
    (OUT / "entry_points" / f"{out_name}.txt").write_text(out.getvalue())
    if rc != 0:
        raise SystemExit(f"{out_name} {' '.join(argv)} returned {rc}")
    return seconds, out.getvalue().strip().splitlines(), launches


def all_finite(x) -> bool:
    """Every number in a JSON value is finite."""
    if isinstance(x, dict):
        return all(all_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(all_finite(v) for v in x)
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return math.isfinite(x)
    return True


def entry_points(cfg, plane_ate=None) -> dict:
    """The entry_points phase: each measurement entry point's main(argv) at a
    small depth on the card (python -m como_tpu_torch.bench and the tools
    under como_tpu_torch/tools/), with its checks.  `plane_ate` is the plane
    phase's ATE: eval_matrix runs the same sequence, so where ComoConfig()
    is configs/como.yml its ATE must be that one to the last digit.
    Returns {module: report}; raises SystemExit on a failed check."""
    from como_tpu_torch import bench
    from como_tpu_torch.config import ComoConfig
    from como_tpu_torch.tools import (bench_runtimes, eval_matrix, probe_pair_throughput,
                                      profile_e2e, profile_gn, run_full)

    out_dir = OUT / "entry_points"
    out_dir.mkdir(parents=True, exist_ok=True)
    rep = {}

    # bench: every cell, seed 0 at 30 frames, a few timed calls per cell
    secs, lines, launches = run_tool(bench.main, [
        "--seeds", "0", "--frames", str(ENTRY_BENCH_FRAMES), "--runs", "1",
        "--track_iters", "3", "--gn_iters", "3", "--stress_reps", "1", "--stress_iters", "2",
        "--probe_frames", "25", "--probe_n", "5", "--probe_bursts", "1"], "bench")
    line = json.loads(lines[-1])
    ex = line["extra"]
    seed = ex["e2e_per_seed"][0] if ex["e2e_per_seed"] else {}
    iters = ex["tracking_iters_per_level"] or []
    max_iter = ComoConfig().tracking.term_criteria.max_iter
    rep["bench"] = dict(seconds=secs, launches=launches, line=line,
                        keys_ok=(set(line) == BENCH_KEYS and set(ex) == BENCH_EXTRA_KEYS
                                 and set(seed) == BENCH_SEED_KEYS),
                        finite=all_finite(line))
    if not rep["bench"]["keys_ok"]:
        raise SystemExit(f"the bench line's keys are not the JAX line's: {sorted(line)} "
                         f"{sorted(ex)} {sorted(seed)}")
    if not rep["bench"]["finite"]:
        raise SystemExit(f"the bench line holds a non-finite value: {line}")
    if not (line["value"] > 0 and ex["e2e_fps"] > 0 and ex["frame_program_throughput_fps"] > 0
            and ex["mapping_gn_iter_ms"] > 0 and min(ex["stress"].values()) > 0):
        raise SystemExit(f"the bench line holds a rate that is not positive: {line}")
    if not ex["e2e_ate_cm"] / 100.0 < 0.5:
        raise SystemExit(f"bench e2e ATE {ex['e2e_ate_cm']} cm: the tracker is lost")
    if not (len(iters) == 3 and all(1 <= i <= max_iter for i in iters)):
        raise SystemExit(f"tracking_iters_per_level {iters} is not within [1, {max_iter}]")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched by the bench: {launches}")

    # eval_matrix: the plane phase's sequence through the matrix's cell
    evm_out = out_dir / "eval_matrix.json"
    secs, lines, launches = run_tool(eval_matrix.main, [
        "--scenes", "plane", "--priors", "analytic", "--seeds", "0", "--frames", "25",
        "--out", str(evm_out)], "eval_matrix")
    row = json.loads(evm_out.read_text())[0]
    cell_cfg = ComoConfig()
    cell_cfg.img_size = list(cfg.img_size)
    cell_cfg.mapping.prior, cell_cfg.mapping.model_path = "analytic", ""
    same_cfg = cell_cfg.validate() == cfg
    rep["eval_matrix"] = dict(seconds=secs, launches=launches, row=row,
                              config_is_como_yml=same_cfg, ate_cm_plane_phase=(
                                  100.0 * plane_ate if plane_ate is not None else None))
    if not row["ate_cm"] / 100.0 < PLANE_ATE_GUARD_M:
        raise SystemExit(f"eval_matrix plane ATE {row['ate_cm']} cm exceeds the guard")
    if same_cfg and plane_ate is not None and row["ate_cm"] != 100.0 * plane_ate:
        raise SystemExit(f"eval_matrix's plane cell ({row['ate_cm']} cm) is not the plane "
                         f"phase's run ({100.0 * plane_ate} cm)")

    # run_full: the plane sequence through the sweep script
    secs, lines, launches = run_tool(run_full.main, ["--scene", "plane", "--frames", "25"],
                                     "run_full")
    rf = json.loads(lines[-1])
    rep["run_full"] = dict(seconds=secs, launches=launches, result=rf)
    if not rf["ate_m"] < PLANE_ATE_GUARD_M:
        raise SystemExit(f"run_full plane ATE {rf['ate_m']} m exceeds the guard")

    # bench_runtimes: ComoSeq and ComoPipeline on the bench world
    rt_out = out_dir / "runtime_bench.json"
    secs, lines, launches = run_tool(bench_runtimes.main, [
        "--frames", "30", "--runs", "1", "--out", str(rt_out)], "bench_runtimes")
    rt = json.loads(rt_out.read_text())
    rep["bench_runtimes"] = dict(seconds=secs, launches=launches,
                                 seq=rt["seq"]["best"], pipeline=rt["pipeline"]["best"],
                                 pipeline_vs_seq=rt["pipeline_vs_seq"])
    for kind in ("seq", "pipeline"):
        r = rt[kind]["best"]
        if not (math.isfinite(r["ate_cm"]) and r["fps"] > 0 and r["frames_tracked"] > 0):
            raise SystemExit(f"bench_runtimes {kind}: {r}")

    # profile_e2e: the phase table after 20 frames
    secs, lines, launches = run_tool(profile_e2e.main, ["--frames", "30", "--warmup", "20"],
                                     "profile_e2e")
    pe = json.loads(lines[-1])
    rep["profile_e2e"] = dict(seconds=secs, launches=launches, result=pe)
    if not (pe["phases"] and all_finite(pe)):
        raise SystemExit(f"profile_e2e holds no phase or a non-finite row: {pe}")

    # profile_gn: five stages on each of the three windows
    secs, lines, launches = run_tool(profile_gn.main, ["--iters", "1"], "profile_gn")
    pg = json.loads(lines[-1])
    rep["profile_gn"] = dict(seconds=secs, launches=launches, result=pg)
    if len(pg["windows"]) != 3 or not all(
            len(w["ms"]) == 5 and all(math.isfinite(v) and v > 0 for v in w["ms"].values())
            for w in pg["windows"].values()):
        raise SystemExit(f"profile_gn: not five finite positive stage times per window: {pg}")

    # probe_pair_throughput: both dispatch kinds
    secs, lines, launches = run_tool(probe_pair_throughput.main, [
        "--frames", "25", "--n", "3", "--reps", "1"], "probe_pair_throughput")
    pp = json.loads(lines[-1])
    rep["probe_pair_throughput"] = dict(seconds=secs, launches=launches, result=pp)
    if not (pp["best_single_fps"] > 0 and pp["best_pair_fps"] > 0):
        raise SystemExit(f"probe_pair_throughput: a rate is not positive: {pp}")
    return rep


def main() -> int:
    t_script = time.perf_counter()
    if not (HERE / "como_tpu_torch").is_dir() or not (HERE / "configs" / "como_unet.yml").is_file():
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

    # ---- 2b. queues: the native ring of the pipeline runtime ----------------
    from como_tpu_torch.runtime import queues

    q = queues.make_queue(4)
    for i in range(6):
        q.push(i, block=False)                       # drop-stale: 2..5 remain
    ring_ok = (q.pop(timeout=1.0), q.pop_until_latest(), q.qsize()) == (2, 5, 0)
    emit("queues", queue=type(q).__name__, build_seconds=queues.build_info.get("seconds"),
         compiled=queues.build_info.get("compiled"), semantics_ok=ring_ok,
         library=str(Path(queues.build_info.get("path", "")).relative_to(HERE))
         if queues.build_info.get("path") else None)
    if type(q).__name__ != "NativeQueue" or not ring_ok:
        raise SystemExit("make_queue did not return a working native ring")

    from como_tpu_torch.config import load_config
    from como_tpu_torch.data.synthetic import SyntheticDataset
    from como_tpu_torch.gp import kernels_cuda, sampler, sampler_cuda
    from como_tpu_torch.net.depthcov import DepthCovPrior
    from como_tpu_torch.odom.backend.gn_step import _gn_step_impl
    from como_tpu_torch.odom.tracking import track_frame
    from como_tpu_torch.runtime.seq import ComoSeq
    from como_tpu_torch.utils.io import ate_rmse, load_traj

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
    dd_ms, _, dd_prof = device_ms(lambda: sampler_cuda.downdate_step(xnT, enT, *buf, sc, l_ni,
                                                                     S - 1), label="downdate")
    dd_plain_ms, dd_plain_k, _ = device_ms(lambda: sampler_cuda.downdate_step_plain(
        xnT, enT, *buf, sc, l_ni, S - 1), label="downdate plain")
    dd_call_ms = time_ms(lambda: sampler_cuda.downdate_step(xnT, enT, *buf, sc, l_ni, S - 1))
    samp_ms = time_ms(lambda: sampler.greedy_entropy_loop(*samp_args), n=5)
    samp_plain_ms = time_ms(lambda: sampler.greedy_entropy_loop(
        *samp_args, downdate=sampler_cuda.downdate_step_plain), n=5)
    samp_dev_ms, samp_kernels, samp_prof = device_ms(
        lambda: sampler.greedy_entropy_loop(*samp_args), n=3, label="sampler call")
    dd_bytes = 4 * (S * D + 5 * D + 4 * D + D + S + 8)
    dd_bound, dd_by = bound(dd_bytes, D * (CROSS_COV_OPS + 2 * S + 8))
    emit("kernel", name="sampler_downdate", shape=[S, D],
         compared="obs_info and var after the full 64-step sampler call",
         max_abs_err=dd_abs, max_rel_err=dd_rel, tol=[TOL_ABS, TOL_REL], ok=dd_ok,
         sampler_domain_inds_identical=same_inds, ms=dd_ms, plain_ms=dd_plain_ms,
         plain_kernels_per_call=dd_plain_k, call_ms=dd_call_ms, device_profile=dd_prof,
         sampler_call_device_profile=samp_prof,
         bound_ms=dd_bound, bound_by=dd_by, sampler_call_ms=samp_ms,
         sampler_call_plain_ms=samp_plain_ms, sampler_call_device_ms=samp_dev_ms,
         sampler_call_kernels=samp_kernels, sampler_call_bound_ms=S * dd_bound,
         library_ms=None, library="no single PyTorch call computes this step")
    if not (dd_ok and same_inds):
        raise SystemExit("sampler downdate kernel disagrees with its plain version")

    # cross-covariance at its five main-path shape classes: all H*W sites x
    # the M = 64 anchors just sampled (keyframe insertion), the sites of
    # pyramid levels 1 and 2 of the same covariance image (SfM bootstrap,
    # as sfm.setup_reference builds them), M x M (K_mm) and 1 x M (once per
    # sampler iteration)
    from como_tpu_torch.gp.kernels import interpolate_cov_params
    from como_tpu_torch.ops.coords import coord_grid_rc, normalize_coords

    x_m, e_m = res_k.coords_norm.contiguous(), res_k.covs.contiguous()
    M = x_m.shape[0]
    cc_shapes = []
    one = slice(i_best, i_best + 1)
    pyr = []
    for lvl in (1, 2):
        hw_l = (H >> lvl, W >> lvl)
        norm_l = normalize_coords(coord_grid_rc(hw_l, torch.float32, dev), list(hw_l))
        pyr.append((norm_l, interpolate_cov_params(cov_img, norm_l)))
    for x_n, e_n in ((dom, e_dom), *pyr, (x_m, e_m), (dom[one], e_dom[one])):
        args = (x_n.contiguous(), e_n.contiguous(), x_m, e_m, 1.0)
        Nn = x_n.shape[0]
        got = kernels_cuda.cross_covariance(*args)
        repeat = bool(torch.equal(got, kernels_cuda.cross_covariance(*args)))
        cc_abs, cc_rel, cc_ok = errors(got, kernels_cuda.cross_covariance_plain(*args))
        cc_ms, _, cc_prof = device_ms(lambda: kernels_cuda.cross_covariance(*args),
                                      label=f"cross_covariance {Nn}x{M}")
        cc_plain_ms, cc_plain_k, _ = device_ms(
            lambda: kernels_cuda.cross_covariance_plain(*args),
            label=f"cross_covariance plain {Nn}x{M}")
        cc_call_ms = time_ms(lambda: kernels_cuda.cross_covariance(*args))
        cc_bound, cc_by = bound(4 * (5 * Nn + 5 * M + Nn * M), CROSS_COV_OPS * Nn * M)
        cc_shapes.append(dict(shape=[Nn, M], max_abs_err=cc_abs, max_rel_err=cc_rel, ms=cc_ms,
                              plain_ms=cc_plain_ms, bound_ms=cc_bound, bound_by=cc_by))
        emit("kernel", name="cross_covariance", tol=[TOL_ABS, TOL_REL], ok=cc_ok,
             two_launches_bitwise_equal=repeat, plain_kernels_per_call=cc_plain_k,
             device_profile=cc_prof,
             call_ms=cc_call_ms, library_ms=None,
             library="no single PyTorch call computes this function", **cc_shapes[-1])
        if not cc_ok:
            raise SystemExit("cross-covariance kernel disagrees with its plain version "
                             f"at {Nn} x {M}")
        if not repeat:
            raise SystemExit(f"two cross-covariance launches at {Nn} x {M} differ")

    # the cross-covariance's backward kernel at the training shapes (K_mm:
    # the 64 anchors on both sides; K_nm: 1,024 test sites) and at the
    # full-size 49,152 x 64, against autograd of the plain version
    g_bwd = torch.Generator(device=dev).manual_seed(0)
    sub = torch.randperm(dom.shape[0], generator=g_bwd, device=dev)[:1024]
    bwd_shapes = []
    for name, (x_n, e_n) in (("K_mm", (x_m, e_m)), ("K_nm", (dom[sub], e_dom[sub])),
                             ("full", (dom, e_dom))):
        Nn = x_n.shape[0]
        args = (x_n.contiguous(), e_n.contiguous(), x_m, e_m, 1.0)
        grad = torch.randn((Nn, M), generator=g_bwd, device=dev)
        got = kernels_cuda.cross_covariance_bwd(grad, *args)
        repeat = all(torch.equal(a, b) for a, b in
                     zip(got, kernels_cuda.cross_covariance_bwd(grad, *args)))
        want = kernels_cuda.cross_covariance_vjp_plain(grad, *args)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        gmax = max(float(b.abs().max()) for b in want)
        ok = all(float((a - b).abs().max()) <= TOL_ABS + TOL_REL * float(b.abs().max())
                 for a, b in zip(got, want))
        ms, kernels, prof = device_ms(lambda: kernels_cuda.cross_covariance_bwd(grad, *args),
                                      label=f"cross_covariance_bwd {Nn}x{M}")
        plain_ms, plain_k, _ = device_ms(lambda: kernels_cuda.cross_covariance_vjp_plain(
            grad, *args), label=f"cross_covariance_bwd plain {Nn}x{M}")
        b_ms, b_by = bound(4 * (Nn * M + 2 * 5 * (Nn + M)), CROSS_COV_BWD_OPS * Nn * M)
        bwd_shapes.append(dict(case=name, shape=[Nn, M], max_abs_err=err, max_abs_grad=gmax,
                               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        emit("kernel", name="cross_covariance_bwd", tol=[TOL_ABS, TOL_REL],
             tol_rel_of="the largest |grad| of each output", ok=ok,
             two_launches_bitwise_equal=repeat, kernels_per_call=kernels, device_profile=prof,
             plain="autograd of cross_covariance_plain (forward recomputed)",
             plain_kernels_per_call=plain_k,
             call_ms=time_ms(lambda: kernels_cuda.cross_covariance_bwd(grad, *args)),
             library_ms=None, library="no single PyTorch call computes this function",
             **bwd_shapes[-1])
        if not ok:
            raise SystemExit(f"cross-covariance backward kernel disagrees with autograd of the "
                             f"plain version at {Nn} x {M}")
        if not repeat:
            raise SystemExit(f"two backward launches at {Nn} x {M} differ")
        if kernels != 1 and not prof["profile_events_lost"]:
            raise SystemExit(f"a backward call at {Nn} x {M} ran {kernels} kernels, not one")

    # ---- 4. unet: the learned prior against the JAX package's golden ---------
    import numpy as np

    gold = np.load(HERE / "tests" / "data" / "unet_golden.npz")
    g_hw, g_stride = tuple(int(v) for v in gold["shape"]), int(gold["stride"])
    g_rgb = golden_image(int(gold["seed"]), g_hw)
    if hashlib.sha256(g_rgb.tobytes()).hexdigest() != str(gold["input_sha256"]):
        raise SystemExit("the golden file's input could not be rebuilt from its seed")
    g_rgb = torch.from_numpy(g_rgb).to(dev)
    unet = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prior = DepthCovPrior("unet", "models/depthcov.msgpack", compute_dtype=dt)
        params = list(prior.unet.parameters())
        if not all(p.is_cuda and p.dtype == torch.float32 for p in params):
            raise SystemExit("the UNet's parameters are not f32 tensors on the card")
        cov = prior.cov_params(g_rgb)
        repeat = bool(torch.equal(cov, prior.cov_params(g_rgb)))
        err = unet_golden_errors(cov[:, ::g_stride, ::g_stride].cpu().numpy(), gold[name],
                                 f32=name == "f32")
        fwd_ms, fwd_kernels, fwd_prof = device_ms(lambda: prior.cov_params(g_rgb), n=10,
                                                  label=f"unet {name}")
        unet[name] = dict(err, two_passes_bitwise_equal=repeat, device_ms=fwd_ms,
                          call_ms=time_ms(lambda: prior.cov_params(g_rgb), n=10),
                          kernels_per_forward=fwd_kernels, device_profile=fwd_prof)
        param_bytes = sum(p.numel() * p.element_size() for p in params)
    emit("unet", image=list(g_hw), checkpoint="models/depthcov.msgpack",
         parameters=sum(p.numel() for p in params), parameter_bytes_on_device=param_bytes,
         f32_tol=list(UNET_F32_TOL), bf16_floor=list(UNET_BF16_FLOOR), **unet)
    for name, u in unet.items():
        if not u["ok"]:
            raise SystemExit(f"UNet prior ({name} convolutions) disagrees with the JAX "
                             f"package's golden output: {u}")
        if not u["two_passes_bitwise_equal"]:
            raise SystemExit(f"two UNet forward passes ({name}) differ")
    del prior, params, cov

    # ---- 4b. train: the DepthCov trainer at full width ------------------------
    # python -m como_tpu_torch.train.train_depthcov's main in this process, no
    # --device (it must land on the card): the shipped UNet with random
    # weights from its seed, bf16 convolutions, synthetic data, multires.
    from como_tpu_torch.net.depthcov import load_params
    from como_tpu_torch.train import train_depthcov
    from como_tpu_torch.train.data import synthetic_batch
    from como_tpu_torch.train.loss import M_ANCHORS, N_TEST, draw_sites
    from como_tpu_torch.train.optim import Trainer

    train_out = OUT / "train" / "depthcov_ema.msgpack"
    train_out.unlink(missing_ok=True)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as train_stdout:
        res = train_depthcov.main(["--steps", str(TRAIN_STEPS), "--val_every",
                                   str(TRAIN_VAL_EVERY), "--out", str(train_out)])
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - t0
    train_launches, _ = read_launches(("cross_covariance", "cross_covariance_bwd"))
    bwd_by_shape = dict(sorted(launches_per_shape("cross_covariance_bwd").items()))
    # per step, at each size, on a model and optimizer of the trainer's own
    # making (one image, its sites drawn on the card)
    model = train_depthcov.make_model(dev)
    trainer = Trainer(model.parameters(), 3e-4, 1000)
    gen = torch.Generator(device=dev).manual_seed(1)
    per_size = {}
    for size in ((96, 128), (192, 256)):
        rgb_s, depth_s = synthetic_batch(np.random.default_rng(0), size, device=dev)
        sites = draw_sites(gen, M_ANCHORS, N_TEST, size)

        def one_step():
            train_depthcov.train_step(model, trainer, rgb_s, depth_s, *sites)

        dev_ms, kernels, prof = device_ms(one_step, n=5, warmup=2,
                                          label=f"train step {size}")
        per_size["x".join(map(str, size))] = dict(
            step_ms_median=time_ms(one_step, n=10, warmup=1), step_device_ms=dev_ms,
            kernels_per_step=kernels, device_profile=prof)
    del model, trainer
    # the saved EMA as the product would read it
    sd = load_params(str(train_out), dev)
    prior_t = DepthCovPrior("unet", str(train_out), device=dev)
    cov_t = prior_t.cov_params(frames[0][1])
    losses, norms = np.array(res["losses"]), np.array(res["grad_norms"])
    emit("train", steps=res["steps"], sizes=res["sizes"], seconds=train_seconds,
         output_tail=train_stdout.getvalue().strip().splitlines()[-2:],
         first_loss=float(losses[0]), last_loss=float(losses[-1]),
         loss_finite_every_step=bool(np.isfinite(losses).all()),
         grad_norm_finite_every_step=bool(np.isfinite(norms).all()),
         grad_norm_max=float(norms.max()), validations=res["validations"],
         best_val_score=res["best_score"], selected=res["selected"],
         launches=train_launches, cross_covariance_bwd_launches_per_shape=bwd_by_shape,
         per_step=per_size, checkpoint=str(train_out.relative_to(HERE)),
         checkpoint_parameters=sum(v.numel() for v in sd.values()),
         prior_cov_shape=list(cov_t.shape), prior_cov_finite=bool(torch.isfinite(cov_t).all()))
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise SystemExit("the trainer produced a non-finite loss or gradient norm")
    if min(train_launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched in the train phase: {train_launches}")
    if res["selected"] != "mse" or not np.isfinite(res["best_score"]):
        raise SystemExit(f"the trainer did not select a validated EMA: {res['selected']}")
    if not bool(torch.isfinite(cov_t).all()) or tuple(cov_t.shape) != (3, H, W):
        raise SystemExit("the trained checkpoint does not run as the UNet prior")
    del prior_t, sd, cov_t

    # ---- 5. plane: the accuracy guard --------------------------------------
    # The 25-frame plane sequence of the JAX package's end-to-end test
    # (step 0.012), at full size with the default config, both kernels
    # launched.  Unlike the clutter run below, its ATE does not move with the
    # kernels' rounding (PERF.md), so a guard on it judges a kernel change.
    ds_p = SyntheticDataset(n_frames=25, img_size=(H, W), seed=0, scene="plane", step=0.012,
                            device=dev)
    eng_p = ComoSeq(cfg, ds_p.intrinsics, (H, W), device="cuda")
    eng_p.setup()
    reset_launches()
    t0 = time.perf_counter()
    for i in range(len(ds_p)):
        ts, rgb = ds_p[i]
        eng_p.step(float(ts), rgb)
    eng_p.finish()
    torch.cuda.synchronize()
    plane_ate = ate_m(eng_p, ds_p)
    plane_launches, _ = read_launches()
    plane_ts, plane_poses = list(eng_p.timestamps), eng_p.poses_numpy()
    emit("plane", frames=len(ds_p), frames_tracked=len(eng_p.timestamps),
         num_kf=eng_p.mapping.num_kf, num_ow=eng_p.mapping.num_ow, ate_m=plane_ate,
         guard_m=PLANE_ATE_GUARD_M, launches=plane_launches,
         seconds=time.perf_counter() - t0)
    if min(plane_launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched in the plane phase: {plane_launches}")
    if not plane_ate < PLANE_ATE_GUARD_M:
        raise SystemExit(f"plane ATE {plane_ate:.4f} m exceeds the {PLANE_ATE_GUARD_M} m guard")
    del eng_p

    # ---- 6. main_path: ComoSeq, 120 clutter frames -------------------------
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
    reset_launches()
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
    launches, by_shape = read_launches()
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
         launches=launches, cross_covariance_launches_per_shape=by_shape,
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

    # ---- 7. cli: the product surface with the learned prior -----------------
    # como_tpu_torch.cli.main in this process, no --device (it must land on
    # the card), full width: 192x256, default window, the shipped UNet with
    # bf16 convolutions, on the first CLI_FRAMES frames of the main path's sequence.
    from como_tpu_torch import cli
    from como_tpu_torch.odom.mapping import Mapping

    cli_dir = OUT / "cli"
    traj = cli_dir / "synthetic.txt"
    traj.unlink(missing_ok=True)
    cli_kf_ms, unet_calls = [], []
    add_kf_orig, cov_orig = Mapping.add_keyframe, DepthCovPrior.cov_params

    def cli_add_keyframe(self, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        add_kf_orig(self, *a)
        torch.cuda.synchronize()
        cli_kf_ms.append((time.perf_counter() - t) * 1e3)

    def cli_cov_params(self, rgb):
        unet_calls.append(self.mode)
        return cov_orig(self, rgb)

    Mapping.add_keyframe, DepthCovPrior.cov_params = cli_add_keyframe, cli_cov_params
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as cli_stdout:
            eng_c = cli.main(["--dataset_type", "synthetic:clutter",
                              "--config", str(HERE / "configs" / "como_unet.yml"),
                              "--max_frames", str(CLI_FRAMES), "--save_traj", str(cli_dir)])
    finally:
        Mapping.add_keyframe, DepthCovPrior.cov_params = add_kf_orig, cov_orig
    cli_seconds = time.perf_counter() - t0
    cli_launches, cli_by_shape = read_launches()
    cli_line = cli_stdout.getvalue().strip().splitlines()[-1]
    fps_m = re.search(r"\(([0-9.]+) FPS\)", cli_line)
    if not traj.is_file() or fps_m is None:
        raise SystemExit(f"the CLI wrote no trajectory or no summary line: {cli_line!r}")
    c_ts, c_poses = load_traj(traj)
    c_idx = np.round(c_ts * ds.fps).astype(int)
    cli_finite = bool(np.isfinite(c_poses).all())
    cli_ate = ate_rmse(c_poses, ds.poses[c_idx], with_scale=True) if cli_finite else None
    mc = eng_c.mapping
    emit("cli", output_line=cli_line, trajectory=str(traj.relative_to(HERE)),
         frames=CLI_FRAMES,
         frames_with_pose=len(c_ts), num_kf=mc.num_kf, num_ow=mc.num_ow,
         kf_insertions=len(cli_kf_ms), ate_m=cli_ate, fps=float(fps_m.group(1)),
         seconds_with_setup=cli_seconds,
         kf_insert_ms_median=statistics.median(cli_kf_ms) if cli_kf_ms else None,
         prior=mc.prior.mode, unet_compute_dtype=str(mc.prior.unet.compute_dtype),
         unet_calls=len(unet_calls), engine_device=str(eng_c.device),
         launches=cli_launches, cross_covariance_launches_per_shape=cli_by_shape,
         poses_finite=cli_finite)
    if eng_c.device.type != "cuda" or unet_calls.count("unet") != len(unet_calls):
        raise SystemExit("the CLI did not run the UNet prior on the card")
    if not cli_finite:
        raise SystemExit("the CLI's trajectory holds non-finite poses")
    if len(c_ts) < CLI_FRAMES - 10:
        raise SystemExit(f"the CLI's trajectory holds {len(c_ts)} of {CLI_FRAMES} frames")
    if mc.num_kf < 3:
        raise SystemExit(f"the CLI run ended with {mc.num_kf} keyframes, expected >= 3")
    if min(cli_launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched in the cli phase: {cli_launches}")
    if not cli_ate < 0.5:      # a lost-tracker check, as on the main path
        raise SystemExit(f"cli ATE {cli_ate:.4f} m exceeds 0.5 m: the tracker is lost")
    del eng_c, mc

    # ---- 8. rgb: color: rgb in tracking and mapping --------------------------
    cfg_rgb = load_config(str(HERE / "configs" / "como.yml"),
                          {"tracking": {"color": "rgb"}, "mapping": {"color": "rgb"}})
    ds_r = SyntheticDataset(n_frames=RGB_FRAMES, img_size=(H, W), seed=0, scene="plane_chroma",
                            step=0.012, device=dev)
    eng_r = ComoSeq(cfg_rgb, ds_r.intrinsics, (H, W), device="cuda")
    eng_r.setup()
    reset_launches()
    t0 = time.perf_counter()
    eng_r.run(ds_r)
    torch.cuda.synchronize()
    rgb_ate = ate_m(eng_r, ds_r)
    rgb_launches, _ = read_launches()
    emit("rgb", scene="plane_chroma", frames=len(ds_r), frames_tracked=len(eng_r.timestamps),
         num_kf=eng_r.mapping.num_kf, num_ow=eng_r.mapping.num_ow, channels=eng_r.mapping.C,
         tracking_rows=int(eng_r.tracking.levels[-1].vals.shape[0]), ate_m=rgb_ate,
         guard_m=PLANE_ATE_GUARD_M, launches=rgb_launches, seconds=time.perf_counter() - t0)
    if eng_r.mapping.C != 3 or eng_r.tracking.levels[-1].vals.shape[0] != 3 * H * W:
        raise SystemExit("the rgb phase did not run three channels")
    if min(rgb_launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched in the rgb phase: {rgb_launches}")
    if not rgb_ate < PLANE_ATE_GUARD_M:
        raise SystemExit(f"rgb ATE {rgb_ate:.4f} m exceeds the {PLANE_ATE_GUARD_M} m guard")
    del eng_r, ds_r

    # ---- 8b. pipeline: the second runtime through the product surface --------
    # cli.main --runtime pipeline in this process, no --device, default
    # config, on the first 60 frames of the main path's sequence.  The run
    # is not deterministic (two threads), so it is held to the lost-tracker
    # checks of the clutter runs above; pipeline_plane below is its accuracy
    # guard.
    from como_tpu_torch.runtime.pipeline import ComoPipeline

    pipe_dir = OUT / "pipeline"
    pipe_traj = pipe_dir / "synthetic.txt"
    pipe_traj.unlink(missing_ok=True)
    pipe_inserts = []

    def pipe_add_keyframe(self, *a):
        pipe_inserts.append(a[-1])
        add_kf_orig(self, *a)

    Mapping.add_keyframe = pipe_add_keyframe
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as pipe_stdout:
            eng_pl = cli.main(["--dataset_type", "synthetic:clutter", "--runtime", "pipeline",
                               "--max_frames", "60", "--save_traj", str(pipe_dir)])
    finally:
        Mapping.add_keyframe = add_kf_orig
    pipe_seconds = time.perf_counter() - t0
    pipe_launches, pipe_by_shape = read_launches()
    pipe_line = pipe_stdout.getvalue().strip().splitlines()[-1]
    fps_p = re.search(r"\(([0-9.]+) FPS\)", pipe_line)
    if not pipe_traj.is_file() or fps_p is None:
        raise SystemExit(f"the pipeline CLI wrote no trajectory or no summary line: {pipe_line!r}")
    p_ts, p_poses = load_traj(pipe_traj)
    p_idx = np.round(p_ts * ds.fps).astype(int)
    pipe_finite = bool(np.isfinite(p_poses).all())
    pipe_ate = ate_rmse(p_poses, ds.poses[p_idx], with_scale=True) if pipe_finite else None
    mp = eng_pl.mapping
    threads_ended = not any(t.is_alive() for t in eng_pl._threads)
    on_card = bool(eng_pl.tracking.T_curr_kf.is_cuda and eng_pl.tracking.levels[-1].vals.is_cuda
                   and mp.state.kf_pose.is_cuda)
    emit("pipeline", output_line=pipe_line, trajectory=str(pipe_traj.relative_to(HERE)),
         engine=type(eng_pl).__name__, queue=type(eng_pl.rgb_q).__name__, frames=60,
         frames_with_pose=len(p_ts), frames_tracked=eng_pl.frames_tracked,
         poses_dropped=eng_pl.poses_dropped, num_kf=mp.num_kf, num_ow=mp.num_ow,
         kf_insertions=len(pipe_inserts), total_gn_iters=mp.total_iters, ate_m=pipe_ate,
         fps=float(fps_p.group(1)), fps_cli_seq=float(fps_m.group(1)), fps_main_path=fps,
         seconds_with_setup=pipe_seconds,
         stage_cpu_and_wall_seconds={k: list(v) for k, v in eng_pl.stage_seconds.items()},
         stage_cpu_share={k: v[0] / v[1] for k, v in eng_pl.stage_seconds.items()},
         stage_devices=[str(eng_pl.track_dev), str(eng_pl.map_dev)],
         threads_ended=threads_ended, tensors_on_card=on_card, launches=pipe_launches,
         cross_covariance_launches_per_shape=pipe_by_shape, poses_finite=pipe_finite)
    if not isinstance(eng_pl, ComoPipeline) or type(eng_pl.rgb_q).__name__ != "NativeQueue":
        raise SystemExit("--runtime pipeline did not run ComoPipeline over the native ring")
    if not (threads_ended and on_card and len(eng_pl.stage_seconds) == 2):
        raise SystemExit("the stage threads did not both run on the card and end")
    if not pipe_finite:
        raise SystemExit("the pipeline's trajectory holds non-finite poses")
    if len(p_ts) < 40:
        raise SystemExit(f"the pipeline's trajectory holds {len(p_ts)} of 60 frames")
    if not 3 <= mp.num_kf <= 8:
        raise SystemExit(f"the pipeline run ended with {mp.num_kf} keyframes, expected 3 to 8")
    if min(pipe_launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched in the pipeline phase: {pipe_launches}")
    if not pipe_ate < 0.5:      # a lost-tracker check, as on the main path
        raise SystemExit(f"pipeline ATE {pipe_ate:.4f} m exceeds 0.5 m: the tracker is lost")
    del eng_pl, mp

    # ---- 8c. pipeline_plane: the pipeline's accuracy guard --------------------
    eng_pp = ComoPipeline(cfg, ds_p.intrinsics, (H, W))
    eng_pp.setup()
    reset_launches()
    t0 = time.perf_counter()
    for i in range(len(ds_p)):
        ts, rgb = ds_p[i]
        eng_pp.step(float(ts), rgb)
    eng_pp.shutdown(timeout=120.0)
    torch.cuda.synchronize()
    pp_seconds = time.perf_counter() - t0
    pp_ate = ate_m(eng_pp, ds_p)
    pp_launches, _ = read_launches()
    emit("pipeline_plane", frames=len(ds_p), frames_with_pose=len(eng_pp.timestamps),
         frames_tracked=eng_pp.frames_tracked, poses_dropped=eng_pp.poses_dropped,
         num_kf=eng_pp.mapping.num_kf, num_ow=eng_pp.mapping.num_ow,
         total_gn_iters=eng_pp.mapping.total_iters, ate_m=pp_ate, guard_m=PLANE_ATE_GUARD_M,
         ate_m_plane_seq=plane_ate, launches=pp_launches, seconds=pp_seconds,
         stage_cpu_share={k: v[0] / v[1] for k, v in eng_pp.stage_seconds.items()})
    if min(pp_launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched in the pipeline_plane phase: {pp_launches}")
    if len(eng_pp.timestamps) < 10:
        raise SystemExit(f"pipeline_plane recorded only {len(eng_pp.timestamps)} poses")
    if not pp_ate < PLANE_ATE_GUARD_M:
        raise SystemExit(f"pipeline_plane ATE {pp_ate:.4f} m exceeds the "
                         f"{PLANE_ATE_GUARD_M} m guard")
    del eng_pp

    # ---- 8d. runtimes: ComoSeq's batched, strided and split dispatch ----------
    frame_ts = [float(ds_p[i][0]) for i in range(len(ds_p))]
    rt_launches, rt_report = {}, {}
    for name, overrides, repeats in (
            ("batched", {"dispatch_depth": 2, "frame_batch": 2}, 2),
            ("strided", {"dispatch_depth": 2, "resolve_stride": 2}, 2),
            ("split", {"tracking": {"device": "cuda:0"}, "mapping": {"device": "cuda:1"}}, 1)):
        cfg_rt = load_config(str(HERE / "configs" / "como.yml"), overrides)
        outs = []
        for _ in range(repeats):
            eng_rt = ComoSeq(cfg_rt, ds_p.intrinsics, (H, W), device="cuda")
            eng_rt.setup()
            reset_launches()
            t0 = time.perf_counter()
            eng_rt.run(ds_p)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rt_launches[name], _ = read_launches()
            outs.append((list(eng_rt.timestamps), eng_rt.poses_numpy()))
        rt_ts, rt_poses = outs[0]
        rt_ate = ate_m(eng_rt, ds_p)
        one_pose_per_frame = rt_ts == frame_ts[len(frame_ts) - len(rt_ts):]
        repeat_equal = all(o[0] == rt_ts and np.array_equal(o[1], rt_poses) for o in outs[1:])
        rt_report[name] = dict(
            frames_tracked=len(rt_ts), num_kf=eng_rt.mapping.num_kf,
            num_ow=eng_rt.mapping.num_ow, total_gn_iters=eng_rt.mapping.total_iters,
            ate_m=rt_ate, seconds=seconds, fps=len(ds_p) / seconds,
            one_pose_per_frame=one_pose_per_frame, runs=repeats,
            repeat_bitwise_equal=repeat_equal if repeats > 1 else None,
            split_devices=eng_rt.split_devices,
            stage_devices=[str(eng_rt.track_dev), str(eng_rt.map_dev)],
            launches=rt_launches[name])
        if name == "split":
            rt_report[name]["equals_plane_phase_bitwise"] = bool(
                rt_ts == plane_ts and np.array_equal(rt_poses, plane_poses))
        del eng_rt
    emit("runtimes", guard_m=PLANE_ATE_GUARD_M, frames=len(ds_p), ate_m_plane_seq=plane_ate,
         **rt_report)
    for name, r in rt_report.items():
        if min(r["launches"].values()) <= 0:
            raise SystemExit(f"a kernel was not launched in the {name} run: {r['launches']}")
        if not r["ate_m"] < PLANE_ATE_GUARD_M:
            raise SystemExit(f"{name} ATE {r['ate_m']:.4f} m exceeds the guard")
        if not r["one_pose_per_frame"] or r["frames_tracked"] < 15:
            raise SystemExit(f"{name}: not one pose per frame from the bootstrap on")
        if r["repeat_bitwise_equal"] is False:
            raise SystemExit(f"two {name} runs differ")
    if not rt_report["split"]["split_devices"]:
        raise SystemExit("the split configuration ran the fused step")
    if not rt_report["split"]["equals_plane_phase_bitwise"]:
        raise SystemExit("the unfused step's poses differ from the fused plane phase's")
    del ds_p

    # ---- 8e. viz: the CLI's --viz through the snapshot viewer ------------------
    # cli.main --viz in this process, no --device, in a working directory under
    # chiprun_out/ (the viewer writes results/viz/ there).  open3d's import is
    # blocked for the call: on a headless machine the snapshot viewer is the
    # viewer, installed or not.  Its period is set to 0, so every call of the
    # engine's viz_listener writes one PNG.
    import importlib.util
    import os
    import shutil

    from como_tpu_torch.viz import viewer as viz_viewer
    from como_tpu_torch.viz.png import read_png

    viz_cwd = OUT / "viz"
    shutil.rmtree(viz_cwd, ignore_errors=True)
    viz_cwd.mkdir(parents=True)
    snap_init, snap_call = viz_viewer.SnapshotViewer.__init__, viz_viewer.SnapshotViewer.__call__
    snap_ms = []

    def snap_init_every_call(self, engine, out_dir="results/viz", period_s=1.0, follow=True):
        snap_init(self, engine, out_dir, 0.0, follow)

    def snap_call_timed(self, viz):
        torch.cuda.synchronize()
        t = time.perf_counter()
        snap_call(self, viz)
        torch.cuda.synchronize()
        snap_ms.append((time.perf_counter() - t) * 1e3)

    open3d_found = importlib.util.find_spec("open3d") is not None
    saved_o3d = sys.modules.get("open3d", "absent")
    viz_viewer.SnapshotViewer.__init__ = snap_init_every_call
    viz_viewer.SnapshotViewer.__call__ = snap_call_timed
    sys.modules["open3d"] = None
    reset_launches()
    t0 = time.perf_counter()
    try:
        os.chdir(viz_cwd)
        with contextlib.redirect_stdout(io.StringIO()) as viz_stdout:
            eng_v = cli.main(["--dataset_type", "synthetic:plane", "--viz", "--max_frames", "15",
                              "--save_traj", "traj"])
    finally:
        os.chdir(HERE)
        viz_viewer.SnapshotViewer.__init__, viz_viewer.SnapshotViewer.__call__ = (
            snap_init, snap_call)
        if saved_o3d == "absent":
            del sys.modules["open3d"]
        else:
            sys.modules["open3d"] = saved_o3d
    viz_seconds = time.perf_counter() - t0
    viz_launches, _ = read_launches()
    viewer = eng_v.viz_listener
    pngs = sorted((viz_cwd / "results" / "viz").glob("map_*.png"))
    shapes, overlay = [], []
    for f in pngs:
        a = read_png(f)
        shapes.append(list(a.shape))
        overlay.append(int((a == np.array([40, 230, 70])).all(-1).sum()
                           + (a == np.array([235, 60, 60])).all(-1).sum()))
    render = render_case(m.get_kf_viz_data(), m.K, dev)
    emit("viz", output_line=viz_stdout.getvalue().strip().splitlines()[-1],
         viewer=type(viewer).__name__, open3d_installed=open3d_found,
         listener_calls=len(snap_ms), pngs=len(pngs), failures=viewer.failures,
         png_shapes_ok=all(sh == [384, 512, 3] for sh in shapes),
         overlay_pixels=overlay, snapshot_ms_median=statistics.median(snap_ms) if snap_ms
         else None, engine_device=str(eng_v.device), frames_tracked=len(eng_v.timestamps),
         num_kf=eng_v.mapping.num_kf, launches=viz_launches, seconds_with_setup=viz_seconds,
         render_main_path_window=render, depth_rtol=VIZ_DEPTH_RTOL,
         colour_share_allowed=VIZ_COLOUR_SHARE)
    if not isinstance(viewer, viz_viewer.SnapshotViewer) or eng_v.device.type != "cuda":
        raise SystemExit("--viz did not attach the snapshot viewer to an engine on the card")
    if viewer.failures or not snap_ms or len(pngs) != len(snap_ms):
        raise SystemExit(f"--viz wrote {len(pngs)} PNGs for {len(snap_ms)} viewer calls, "
                         f"{viewer.failures} failed")
    if not all(sh == [384, 512, 3] for sh in shapes) or overlay[-1] <= 0:
        raise SystemExit(f"the snapshots are not 384x512x3 with an overlay: {shapes} {overlay}")
    if min(viz_launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched in the viz phase: {viz_launches}")
    if not render["ok"]:
        raise SystemExit(f"render_map on the card disagrees with the CPU: {render}")
    del eng_v, viewer

    # ---- 9. layers: on the final full-size window, one GN iteration and one
    # frame's tracking
    gn_args = (m.state, *m._pairs, m.K, m.dims, m.sigmas, m.damping)
    gn_ms = time_ms(lambda: _gn_step_impl(*gn_args), n=20)
    gn_dev_ms, gn_kernels, gn_prof = device_ms(lambda: _gn_step_impl(*gn_args), n=5,
                                               label="GN step")
    tr = eng.tracking

    def track_once():
        track_frame(tr.levels, frames[-1][1], tr.T_curr_kf, tr.aff_curr_kf, tr.T_w_kf,
                    tr.term, tr.cfg.pyr.start_level, tr.cfg.pyr.end_level, (H, W),
                    tr.cfg.color)

    track_ms = time_ms(track_once, n=3, warmup=1)
    track_dev_ms, track_kernels, track_prof = device_ms(track_once, n=1, warmup=0,
                                                        label="track frame")
    emit("layers", gn_iter_ms_median=gn_ms, gn_iter_device_ms=gn_dev_ms,
         gn_iter_kernels=gn_kernels, gn_iter_device_profile=gn_prof,
         track_frame_ms_median=track_ms, track_frame_device_ms=track_dev_ms,
         track_frame_kernels=track_kernels, track_frame_device_profile=track_prof)

    # ---- 10. profile: device kernel time by name over two more frames,
    # against the unprofiled median frame time.  CUDA activities only: with
    # CPU activities too, recording ~48,000 operators per frame took most of
    # this phase's 151 s (for four frames; H100 host at 1.5 s per frame).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof_frames = [(float(ts) + 10.0 + k / ds.fps, rgb) for k, (ts, rgb)
                   in enumerate(frames[-2:])]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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

    # ---- 11. determinism: two GN steps on the same full-size state ----------
    s1, g1 = _gn_step_impl(*gn_args)
    s2, g2 = _gn_step_impl(*gn_args)
    same = all(torch.equal(getattr(s1, f), getattr(s2, f)) for f in s1.fields()) \
        and all(torch.equal(a, b) for a, b in zip(g1, g2))
    emit("determinism", gn_steps_bitwise_equal=same, dims=list(m.dims))
    if not same:
        raise SystemExit("two GN steps on the same state differ")

    # ---- 12. mesh: the sharded GN step over shards of this card --------------
    from como_tpu_torch.odom.window import make_dims
    from como_tpu_torch.utils.demo import make_demo_state

    reset_launches()
    main_cases = [mesh_case(dev, m.state, m._pairs, m.K, m.dims, m.sigmas, m.damping, n,
                            MESH_TOL) for n in (2, 8)]
    mesh_step_launches, _ = read_launches()     # the step reaches neither kernel
    sd = make_dims(num_kf=18, num_ow=48, M=64, img_size=(H, W))
    sd = sd._replace(P=-(-sd.P // 8) * 8)      # invalid pairs pad 130 to 136
    s_state, s_pairs, s_K = make_demo_state(sd, num_kf=18, num_ow=8, device=dev)
    stress_cases = [mesh_case(dev, s_state, s_pairs, s_K, sd, m.sigmas, m.damping, n,
                              MESH_STRESS_TOL) for n in (2, 8)]
    del s_state
    cfg_mesh = load_config(str(HERE / "configs" / "como.yml"), {"mapping": {"mesh_devices": 2}})
    engine = {}
    if torch.cuda.device_count() < 2:
        try:
            ComoSeq(cfg_mesh, ds.intrinsics, (H, W), device="cuda")
        except RuntimeError as e:
            if "mesh_devices" not in str(e):
                raise
            engine = dict(ran=False, raised=str(e))
        else:
            raise SystemExit("mapping.mesh_devices: 2 built an engine on a one-card host")
    else:
        ds_m = SyntheticDataset(n_frames=25, img_size=(H, W), seed=0, scene="plane",
                                step=0.012, device=dev)
        eng_m = ComoSeq(cfg_mesh, ds_m.intrinsics, (H, W), device="cuda")
        eng_m.setup()
        reset_launches()
        t0 = time.perf_counter()
        eng_m.run(ds_m)
        torch.cuda.synchronize()
        engine = dict(ran=True, mesh=[str(d) for d in eng_m.mapping.mesh],
                      frames_tracked=len(eng_m.timestamps), num_kf=eng_m.mapping.num_kf,
                      total_gn_iters=eng_m.mapping.total_iters, ate_m=ate_m(eng_m, ds_m),
                      guard_m=PLANE_ATE_GUARD_M, launches=read_launches()[0],
                      seconds=time.perf_counter() - t0)
        del eng_m
    emit("mesh", tol=list(MESH_TOL), stress_tol=list(MESH_STRESS_TOL), main_window=main_cases,
         stress_window=dict(dims=list(sd), cases=stress_cases),
         launches_in_the_steps=mesh_step_launches, cards=torch.cuda.device_count(),
         engine_mesh_devices_2=engine)
    for c in main_cases + stress_cases:
        if not c["ok"]:
            raise SystemExit(f"the sharded GN step disagrees with the single step: {c}")
    if engine.get("ran") and not (engine["ate_m"] < PLANE_ATE_GUARD_M
                                  and min(engine["launches"].values()) > 0):
        raise SystemExit(f"the mesh engine failed the plane guard: {engine}")

    # ---- 13. entry_points: the measurement entry points at a small depth -----
    entry = entry_points(cfg, plane_ate)
    emit("entry_points", seconds={k: v["seconds"] for k, v in entry.items()}, **entry)

    emit("total", seconds=time.perf_counter() - t_script, profiles_lost=PROFILES_LOST)
    # the cross-covariance entry's own keys are those of its full-size shape;
    # "shapes" holds every timed shape class with its main-path launches
    for sh in cc_shapes:
        sh["launches"] = by_shape.get("{}x{}".format(*sh["shape"]), 0)
    by_path = {"train": train_launches, "plane": plane_launches, "main_path": launches,
               "cli": cli_launches,
               "rgb": rgb_launches, "pipeline": pipe_launches, "pipeline_plane": pp_launches,
               **{f"runtimes_{k}": v for k, v in rt_launches.items()}, "viz": viz_launches,
               **{f"entry_points_{k}": v["launches"] for k, v in entry.items()}}
    full = cc_shapes[0]
    table = [
        dict(name="cross_covariance", route="cuda", source="como_tpu_torch/csrc/gp_kernels.cu",
             replaces="como_tpu/gp/kernels_pallas.py:95", launches=launches["cross_covariance"],
             max_abs_err=full["max_abs_err"], ms=full["ms"], plain_ms=full["plain_ms"],
             bound_ms=full["bound_ms"], bound_by=full["bound_by"], library_ms=None,
             shapes=cc_shapes, launches_per_shape=by_shape,
             launches_by_path={k: v["cross_covariance"] for k, v in by_path.items()}),
        dict(name="cross_covariance_bwd", route="cuda",
             source="como_tpu_torch/csrc/gp_kernels.cu",
             replaces="como_tpu/gp/kernels_pallas.py:95",
             replaces_note="the gradient of that kernel; como_tpu has no Pallas backward "
                           "(JAX differentiates the XLA twin, como_tpu/gp/kernels.py)",
             launches=train_launches["cross_covariance_bwd"],
             max_abs_err=bwd_shapes[1]["max_abs_err"], ms=bwd_shapes[1]["ms"],
             plain_ms=bwd_shapes[1]["plain_ms"], bound_ms=bwd_shapes[1]["bound_ms"],
             bound_by=bwd_shapes[1]["bound_by"], library_ms=None, shapes=bwd_shapes,
             launches_per_shape=bwd_by_shape, launches_by_path={"train": train_launches[
                 "cross_covariance_bwd"]}),
        dict(name="sampler_downdate", route="cuda",
             source="como_tpu_torch/csrc/sampler_kernels.cu",
             replaces="como_tpu/gp/sampler_pallas.py:96", launches=launches["sampler_downdate"],
             max_abs_err=dd_abs, ms=dd_ms, plain_ms=dd_plain_ms, bound_ms=dd_bound,
             bound_by=dd_by, library_ms=None,
             launches_by_path={k: v["sampler_downdate"] for k, v in by_path.items()
                               if "sampler_downdate" in v}),
    ]
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
