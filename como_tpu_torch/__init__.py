"""como_tpu_torch — the PyTorch/CUDA port of como_tpu.

Mirrors como_tpu's layout (geometry/, ops/, gp/, net/, odom/, runtime/,
data/, utils/) so each module's counterpart is found by path.  It imports
torch, numpy, yaml, and `cv2` only inside data/datasets.py when present
(tests/test_torch_imports.py enforces it) — never jax, flax or como_tpu.
The product surface is `python -m como_tpu_torch.cli`.

Device policy: every entry point takes `device` (default "cuda").  Only an
explicit device="cpu" runs on the CPU; nothing falls back quietly.  The two
TPU kernels of como_tpu (gp/kernels_pallas.py, gp/sampler_pallas.py) are
hand-written CUDA C++ here (csrc/), each beside a plain PyTorch twin that
only CPU tensors reach.

Precision: f32 everywhere, with TF32 off for matmuls and convolutions
(the counterpart of como_tpu's "highest" default matmul precision and of
the f64 rejection in config.py).  The one exception is como_tpu's own: the
UNet prior's block convolutions run in bf16 with f32 parameters
(net/unet.py).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
