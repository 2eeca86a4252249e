"""Shared set-up of the port's CPU tests (tests/test_torch_*.py import it).

One intra-op thread for PyTorch: the tests run several worker processes
side by side, at sizes (48x64 windows, thousands of tiny ops per frame)
where a thread pool only adds spinning; with PyTorch's default of one
thread per core in each worker, the engine tests took ten times as long.
"""

import numpy as np
import torch

torch.set_num_threads(1)


def render_scene(seed, n=3, hw=(48, 64)):
    """render_map's inputs (numpy): keyframes of wavy depth seen from a
    camera behind the last one: overlapping, occluding splats, some outside
    the view (tests/test_torch_viz.py, tests/test_torch_cuda.py)."""
    from como_tpu_torch.geometry.lie import se3_exp

    rng = np.random.default_rng(seed)
    H, W = hw
    K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]], np.float32)
    rgbs = rng.uniform(size=(n, 3, H, W)).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    depths = np.stack([1.5 + 0.3 * np.sin(xs / 7.0 + k) + 0.2 * np.cos(ys / 5.0)
                       + 0.05 * rng.standard_normal((H, W)) for k in range(n)])
    xi = rng.normal(scale=[0.05, 0.05, 0.05, 0.1, 0.05, 0.1], size=(n, 6))
    poses = se3_exp(torch.from_numpy(xi.astype(np.float32))).numpy()
    T_view = poses[-1] @ se3_exp(torch.tensor([0.25, 0, 0, 0, -0.15, -0.8])).numpy()
    valid = np.arange(n) >= seed % 2          # seed 1: the first keyframe is invalid
    return rgbs, depths[:, None].astype(np.float32), poses, valid, K, T_view
