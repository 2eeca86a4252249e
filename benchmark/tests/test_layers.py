"""The traced run's readings on a made-up device trace: kernels belong to
the call whose host span holds their launch on the same thread, busy time
is the union of the device's operations, and a roofline share is the
least time over the device time of the call's kernels."""

import pytest

from benchmark import layers, peaks, spec

H100 = "NVIDIA H100 80GB HBM3"
MS = 1_000_000


def _run(spans, calls, kernels, launches, t0=0, t1=100 * MS):
    class Tracer:
        sessions = [dict(label="frames", t0=t0, t1=t1, ops=kernels, kernels=kernels,
                         launches=launches)]

    bench = spec.load_benchmark()
    cell = bench["workloads"][0]["name"]
    captured = {"spans": spans, "calls": calls}
    window = {"frames": list(range(4)), "latency_s": [1.0] * 4}
    return layers.TracedRun(bench, cell, window, captured, Tracer(), H100)


def test_kernels_belong_to_the_span_of_their_launch_on_the_same_thread():
    spans = [("tracking", (11, -5), 10 * MS, 20 * MS, True, None)]
    kernels = [(12 * MS, 13 * MS, "k_a", 1), (15 * MS, 16 * MS, "k_b", 2),
               (30 * MS, 31 * MS, "k_c", 3)]
    launches = {1: (11 * MS, 11), 2: (19 * MS, 12), 3: (19 * MS, -5)}
    run = _run(spans, [], kernels, launches)
    got = run.kernels_in(spans, run.session("frames"))
    assert [k[2] for k in got] == ["k_a", "k_c"]


def test_busy_is_the_union_of_device_operations():
    kernels = [(10 * MS, 20 * MS, "a", 1), (15 * MS, 25 * MS, "b", 2), (50 * MS, 60 * MS, "c", 3)]
    run = _run([], [], kernels, {})
    busy, window, _ = run.busy(run.session("frames"))
    assert busy == pytest.approx(0.025)
    assert window == pytest.approx(0.1)


def test_roofline_share_is_least_time_over_the_calls_kernel_time():
    mod = spec.load_module("rooflines", "cross_cov")
    shape = {"N": 49152, "M": 64}
    need = peaks.bound_s(mod.nbytes(**shape), mod.nops(**shape), H100)
    calls = [("cross_cov", (7, 7), 10 * MS, 11 * MS, shape)]
    kernels = [(12 * MS, 12 * MS + 8000, "kern", 1), (13 * MS, 13 * MS + 2000, "other", 2)]
    launches = {1: (int(10.5 * MS), 7), 2: (12 * MS, 7)}
    run = _run([], calls, kernels, launches)
    assert run.roofline_share("cross_cov") == pytest.approx(100 * need / 8e-6)
    assert run.roofline_share("downdate") is None


def test_breakdown_names_idle_gaps_by_the_open_span():
    spans = [("tracking", (1, 1), 0, 50 * MS, True, None)]
    kernels = [(10 * MS, 20 * MS, "a", 1)]
    run = _run(spans, [], kernels, {1: (5 * MS, 1)})
    bd = layers.breakdown(run)
    assert bd["device_ops"] == [["a", pytest.approx(0.01)]]
    names = dict(bd["idle_gaps"])
    assert names["tracking"] == pytest.approx(0.04)
    assert names["harness"] == pytest.approx(0.05)


class _Event:
    def __init__(self, name, corr, start, dur=0, tid=0, device=False):
        self._name, self._corr, self._start, self._dur = name, corr, start, dur
        self._tid, self._device = tid, device

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self._device else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False

    def name(self):
        return self._name

    def correlation_id(self):
        return self._corr

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_resource_id(self):
        return self._tid


@pytest.mark.parametrize("launch", ["cudaGraphLaunch", "cudaGraphLaunch_v10000",
                                    "cudaLaunchKernel"])
def test_every_kernel_of_a_launch_is_counted_and_belongs_to_its_span(launch):
    """A graph replay is one runtime call whose correlation id all the
    graph's kernels carry: each kernel counts, in the span of the replay."""
    events = [_Event(launch, 9, 11 * MS, tid=4),
              _Event("cudaMemcpyAsync", 10, 12 * MS, tid=4)]
    events += [_Event(f"k{i}", 9, (13 + i) * MS, MS // 2, device=True) for i in range(5)]
    events += [_Event("Memcpy DtoH", 10, 19 * MS, MS // 2, device=True)]
    ops, kernels, launches = layers.split_events(events)
    assert len(ops) == 6 and [k[2] for k in kernels] == [f"k{i}" for i in range(5)]
    spans = [("tracking", (4, 4), 10 * MS, 20 * MS, True, None)]
    run = _run(spans, [], kernels, launches)
    run.sessions[0]["ops"] = ops
    assert len(run.kernels_in(spans, run.session("frames"))) == 5
    reader = spec.load_module("metrics", "tracking.launches_per_frame")
    assert reader.read(run) == 5


def test_frame_mfu_counts_from_the_configuration_s_shapes():
    """One tracked frame and one GN step in a 100 ms session: the counted
    operations (192x256 over 3 levels, D = 8 x 9 + 8 x 24 + 3 x 9 x 64)
    over 100 ms of the f32 peak."""
    mfu = spec.load_module("metrics", "device.frame_mfu")
    spans = [("tracking", (1, 1), 10 * MS, 20 * MS, True, None),
             ("gn", (1, 1), 20 * MS, 30 * MS, True, None)]
    run = _run(spans, [], [], {})
    D = 8 * 9 + 8 * 24 + 3 * 9 * 64
    ops = 203 * (192 * 256 + 96 * 128 + 48 * 64) + D ** 3 / 3 + 2 * D ** 2
    assert mfu.read(run) == pytest.approx(100 * ops / (0.1 * 67e12))
