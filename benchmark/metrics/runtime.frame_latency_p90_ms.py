"""runtime: the 90th percentile of the window's frame latencies (host
clock, every frame handed over in the traced window), in ms."""

from benchmark.harness import percentile


def read(run):
    lat = run.window["latency_s"]
    return 1e3 * percentile(lat, 90) if len(lat) >= 10 else None
