"""What the measurement entry points share (como_tpu_torch/bench.py and the
tools under como_tpu_torch/tools/): the device a tool runs on, the card
line written beside every number, synchronizing an engine's devices, the
timed frame loop of the end-to-end runs and the scale-aligned ATE.

A tool runs on the card unless it is given `--device cpu`; without a CUDA
device it raises before doing any work.  It never carries on on the CPU.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from como_tpu_torch.utils.io import ate_rmse


def tool_device(name: str) -> torch.device:
    """The torch device of a tool's `--device`; raises for a CUDA device on
    a host without one."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    return dev


def card_line(dev: torch.device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the card the tool ran on,
    or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return lines[dev.index or 0] if len(lines) > (dev.index or 0) else lines[0]


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def synchronize(*devices) -> None:
    """Wait for the work queued on each CUDA device (nothing on the CPU)."""
    for d in set(torch.device(d) for d in devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def end_run(eng) -> None:
    """Resolve what the engine has in flight (ComoSeq.finish,
    ComoPipeline.shutdown) and wait for both of its stage devices, as the
    CLI does before it stops its clock."""
    if hasattr(eng, "finish"):
        eng.finish()
    if hasattr(eng, "shutdown"):
        eng.shutdown()
    synchronize(eng.track_dev, eng.map_dev)


def timed_frames(eng, frames, warm: int = 20):
    """Step `eng` through `frames` ((ts, rgb) pairs) and end the run.

    The clock restarts after frame `warm`, so the steady window is the
    frames after it.  Latency is per *resolved* frame: a step's wall time is
    split over the frames whose decisions it resolved, so a step that only
    stashes a frame (frame_batch 2) adds nothing, and a pair step adds two
    halves.  Returns (steady seconds, latencies in s of the steady window,
    warm-up seconds)."""
    t0 = time.perf_counter()
    warm_s = None
    lat = []
    for i, (ts, rgb) in enumerate(frames):
        n_before = len(eng.timestamps)
        s = time.perf_counter()
        eng.step(float(ts), rgb)
        dt = time.perf_counter() - s
        n_res = len(eng.timestamps) - n_before
        if n_res:
            lat.extend([dt / n_res] * n_res)
        if i == warm:
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            lat = []
    end_run(eng)
    return time.perf_counter() - t0, lat, warm_s


def engine_ate(eng, gt_poses, fps: float = 30.0) -> float:
    """Scale-aligned ATE (m) of an engine's poses against ground truth
    indexed by round(ts * fps)."""
    ts = np.asarray(eng.timestamps)
    idx = (ts * fps).round().astype(int)
    return float(ate_rmse(eng.poses_numpy(), np.asarray(gt_poses)[idx], with_scale=True))


def path_length(poses) -> float:
    """Length (m) of a ground-truth trajectory's camera path."""
    p = np.asarray(poses)[:, :3, 3]
    return float(np.sum(np.linalg.norm(np.diff(p, axis=0), axis=-1)))


def render_frames(ds, device) -> list:
    """Every frame of a dataset rendered up front ((ts, rgb) pairs), with
    the device's queue drained: input acquisition stays off the clock."""
    frames = [ds[i] for i in range(len(ds))]
    synchronize(device)
    return frames
