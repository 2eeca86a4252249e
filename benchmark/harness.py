"""One run of one cell: set-up, warm-up, the measured window, the metrics
and the check of what the window produced.

`execute` is the whole run after the look for a chip (benchmark/run.py
makes that look); the tests call it on the CPU at a small size with
`config_override`, and with `fault` to break the timed path underneath.
"""

from __future__ import annotations

import copy
import gc
import math
import os
import time

import numpy as np
import torch

from benchmark import drive, hooks, spec
from benchmark.stream import Stream


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) over all values, linear between ranks;
    inf where a value is inf (a pose that never came back)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return math.nan
    pos = (v.size - 1) * q / 100.0
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if v[hi] == math.inf:
        return math.inf
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def end_to_end(window: dict, setup_s: float) -> dict:
    """fps: poses that came back to the caller inside the window over the
    window's seconds; frame_latency_p50_ms: the median over every frame
    handed over in the window; setup_s."""
    span = window["t1"] - window["t0"]
    return {"fps": {"value": window["received_in_window"] / span, "unit": "frames/s"},
            "frame_latency_p50_ms": {"value": 1e3 * percentile(window["latency_s"], 50),
                                     "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}


def device_info(device, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def steady_window() -> None:
    """The levers that made windows steadier on the card (PERF.md): what
    set-up left is frozen out of the collector's full passes, and the
    calling thread (the one that feeds the engine) runs on one CPU, the
    second of the process's set, for the rest of the run."""
    gc.collect()
    gc.freeze()
    if hasattr(os, "sched_setaffinity"):
        cpus = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cpus[1 % len(cpus)]})


def frames_needed(traffic: dict, seconds: float) -> int:
    """The warm-up's most frames plus the camera's frames over the window
    and ten seconds more (the pipeline's drain)."""
    return int(traffic["warmup"]["max_frames"]) + int(math.ceil(
        float(traffic["camera_hz"]) * (seconds + 10.0)))


def execute(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device,
            t_process: float, config_override: dict | None = None, fault: str | None = None,
            control: bool = False, pre_parts: dict | None = None):
    """Returns (result dict, text of the compared numbers).  With `control`
    the result also holds `control_checks`: the same numbers with the
    reference, one precision lower, in the program's place."""
    from benchmark import check, layers

    config = spec.load_config(cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    if config_override:
        config = copy.deepcopy(config)
        hooks.merge(config["config"], config_override)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    img = tuple(config["config"]["img_size"])
    parts = dict(pre_parts or {}, before_s=time.perf_counter() - t_process)
    t = time.perf_counter()
    stream = Stream(traffic, img, seed, frames_needed(traffic, seconds), dev)
    drive.synchronize(dev)
    parts["render_s"] = time.perf_counter() - t
    t = time.perf_counter()
    eng = drive.build_engine(config, stream.K, dev.type)
    parts["engine_s"] = time.perf_counter() - t
    probe = hooks.Hooks(eng, spans=trace,
                        rng=np.random.default_rng([seed % 2 ** 63, 2]), fault=fault)
    tracer = layers.DeviceTrace(dev) if trace and dev.type == "cuda" else None
    try:
        probe.install()
        t = time.perf_counter()
        start = drive.warm_up(eng, stream, traffic["warmup"])
        parts["warmup_s"], parts["warmup_frames"] = time.perf_counter() - t, start
        if tracer is not None:
            tracer.warm()
        steady_window()
        probe.begin_window(tracer)
        drive.synchronize(dev)
        setup_s = time.perf_counter() - t_process
        window = drive.FEEDS[drive.feed_of(config, traffic)](
            eng, stream, start, seconds, dev, tick=tracer.tick if tracer is not None else None)
        window["calls"] = dict(probe.counts)
        t = time.perf_counter()
        drive.until_exercised(eng, stream, window["next_frame"], probe.exercised)
        after = {"drain_s": window.get("drain_s", 0.0), "exercise_s": time.perf_counter() - t}
        if tracer is not None:
            tracer.close()
        probe.end_window()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finally:
        t = time.perf_counter()
        drive.stop_engine(eng)
        probe.uninstall()
    after["stop_s"] = time.perf_counter() - t
    captured = probe.captured
    parts["window_calls"] = window["calls"]
    del eng, probe
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    if trace:
        metrics, breakdown, busy = layers.per_layer(bench, cell["name"], window,
                                                    captured, tracer)
    else:
        metrics = {m["name"]: end_to_end(window, setup_s)[m["name"]]
                   for m in spec.metrics_of(bench, cell["name"], "end_to_end")}
    after["read_s"] = time.perf_counter() - t
    t = time.perf_counter()
    required = check.required_of(traffic)
    correct, checks = check.judge(captured, stream, config, cell["name"], dev, seed,
                                  required=required)
    after["check_s"] = time.perf_counter() - t
    result = {"correct": bool(correct),
              "attempted": len(window["frames"]),
              "failed": int(sum(1 for ok in window["ok"] if not ok)),
              "metrics": metrics, "device": device_info(dev, peak)}
    if trace:
        result["device"].update(busy)
        if breakdown:
            result["breakdown"] = breakdown
        result["sessions"] = layers.sessions_of(captured, tracer)
    if control:
        result["control_correct"], result["control_checks"] = check.judge(
            captured, stream, config, cell["name"], dev, seed, required=required,
            control=True)
    lat_ms = 1e3 * np.asarray(window["latency_s"])
    parts["latency_ms_quartiles"] = [percentile(lat_ms, q) for q in (10, 25, 50, 75, 90)]
    result["setup_parts"] = parts
    # after the window: the untimed drain and frames until an insertion and
    # a GN step ran, the engine's stop, the readers, the check; the whole
    # run from the process's start; window frames whose pose the pose
    # queue dropped as stale (counted among `failed`)
    result["after_parts"] = dict(after, total_s=time.perf_counter() - t_process,
                                 dropped=window.get("dropped", 0))
    result["checks"] = checks
    text = "\n".join(f"check {k}: {v['value']!r} limit {v['limit']!r}"
                     for k, v in checks.items())
    return result, text
