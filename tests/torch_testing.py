"""Shared set-up of the port's CPU tests (tests/test_torch_*.py import it).

One intra-op thread for PyTorch: the tests run several worker processes
side by side, at sizes (48x64 windows, thousands of tiny ops per frame)
where a thread pool only adds spinning; with PyTorch's default of one
thread per core in each worker, the engine tests took ten times as long.
"""

import torch

torch.set_num_threads(1)
