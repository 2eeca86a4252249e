"""The end-to-end statistics are over every frame of the window."""

import math

import pytest

from benchmark import harness


def test_fps_is_poses_received_over_the_window_seconds():
    window = dict(t0=10.0, t1=14.0, frames=list(range(5)), latency_s=[1.0] * 5,
                  ok=[True] * 5, received_in_window=5)
    m = harness.end_to_end(window, 20.0)
    assert m["fps"]["value"] == pytest.approx(5 / 4.0)
    assert m["setup_s"]["value"] == 20.0


def test_median_is_over_all_frames():
    lat = [0.9, 1.0, 1.1, 5.0, 1.05, 0.95, 1.2]
    window = dict(t0=0.0, t1=10.0, frames=list(range(7)), latency_s=lat, ok=[True] * 7,
                  received_in_window=7)
    assert harness.end_to_end(window, 1.0)["frame_latency_p50_ms"]["value"] == \
        pytest.approx(1050.0)


def test_a_pose_that_never_came_back_counts_as_missing():
    assert harness.percentile([1.0, 2.0, math.inf], 50) == 2.0
    assert harness.percentile([1.0, math.inf, math.inf], 50) == math.inf
    assert harness.percentile([1.0, 2.0, 3.0, 4.0], 90) == pytest.approx(3.7)
