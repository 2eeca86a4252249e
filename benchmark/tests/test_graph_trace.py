"""On the card: the device trace counts every kernel of a CUDA graph's
replays, in the host span that replays it, as many as the same work
launches one by one.  Needs the card (skips without one, decided inside
the test):

    python3 -m pytest benchmark/tests/test_graph_trace.py -m cuda
"""

import time

import pytest
import torch

from benchmark import layers, spec

REPLAYS = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _body(x):
    x.add_(1.0)
    x.mul_(0.5)
    x.sub_(0.25)
    x.abs_()
    x.sqrt_()


def _traced(tracer, work):
    """Kernels launched inside one host span around `work`, and the
    per-frame reader's count for that span."""
    tracer.start("frames")
    t0 = time.time_ns()
    work()
    t1 = time.time_ns()
    tracer.stop()
    sess = tracer.sessions.pop()
    span = ("tracking", layers.thread_keys(), t0, t1, True, None)
    bench = spec.load_benchmark()

    class One:
        sessions = [sess]

    run = layers.TracedRun(bench, bench["workloads"][0]["name"], {"frames": [], "latency_s": []},
                           {"spans": [span], "calls": []}, One(), "cuda")
    reader = spec.load_module("metrics", "tracking.launches_per_frame")
    return len(run.kernels_in([span], sess)), reader.read(run)


@pytest.mark.cuda
def test_graph_replays_count_every_kernel(cuda_device):
    x = torch.ones(1 << 16, device=cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        for _ in range(3):
            _body(x)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _body(x)
    torch.cuda.synchronize(cuda_device)

    tracer = layers.DeviceTrace(cuda_device)
    tracer.warm()
    eager, _ = _traced(tracer, lambda: _body(x))
    replayed, per_frame = _traced(tracer, lambda: [graph.replay() for _ in range(REPLAYS)])
    print(f"eager kernels {eager}, {REPLAYS} replays {replayed}")
    assert eager == 5
    assert replayed == REPLAYS * eager
    assert per_frame == REPLAYS * eager
