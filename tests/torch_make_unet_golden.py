#!/usr/bin/env python3
"""Write tests/data/unet_golden.npz: the JAX package's UNet prior on one
fixed image, for the GPU check of the port (chip_smoke.py, phase `unet`).

    JAX_PLATFORMS=cpu python tests/torch_make_unet_golden.py

Run by hand when como_tpu/net/unet.py or models/depthcov.msgpack changes;
pytest does not collect it.  The file holds the input's recipe (seed, shape
and the SHA-256 of its bytes; golden_image below rebuilds it with exact f32
arithmetic, so any numpy gives the same bytes) and the finest-level output
(3, H, W) of como_tpu's DepthCovPrior("unet"), sub-sampled every 8th pixel,
for f32 and for bf16 convolutions.
"""

import hashlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, SHAPE, STRIDE = 7, (192, 256), 8


def golden_image(seed: int, hw) -> np.ndarray:
    """(1, 3, H, W) f32 in [0, 1): 8x8 blocks of coarse noise plus fine
    noise.  chip_smoke.py carries the same function."""
    rng = np.random.default_rng(seed)
    h, w = hw
    coarse = rng.random((3, h // 8, w // 8), dtype=np.float32)
    fine = rng.random((3, h, w), dtype=np.float32)
    blocks = np.kron(coarse, np.ones((1, 8, 8), np.float32))
    return (np.float32(0.8) * blocks + np.float32(0.2) * fine)[None]


def main():
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from como_tpu.net.depthcov import DepthCovPrior
    from como_tpu.net.unet import UNet

    rgb = golden_image(SEED, SHAPE)
    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        prior = DepthCovPrior("unet", os.path.join(ROOT, "models", "depthcov.msgpack"))
        prior._unet = UNet(compute_dtype=dt)
        cov = np.asarray(prior.cov_params(jnp.asarray(rgb)))
        assert cov.shape == (3,) + SHAPE and np.all(np.isfinite(cov))
        out[name] = cov[:, ::STRIDE, ::STRIDE].astype(np.float32)
    path = os.path.join(ROOT, "tests", "data", "unet_golden.npz")
    np.savez_compressed(
        path, seed=SEED, shape=np.array(SHAPE), stride=STRIDE,
        input_sha256=hashlib.sha256(rgb.tobytes()).hexdigest(),
        f32=out["f32"], bf16=out["bf16"])
    d = np.abs(out["bf16"] - out["f32"])
    print(f"wrote {path} ({os.path.getsize(path)} bytes); output range "
          f"[{out['f32'].min():.4g}, {out['f32'].max():.4g}]; bf16 - f32: max abs "
          f"{d.max():.4g}, median rel {np.median(d / np.abs(out['f32'])):.4g}")


if __name__ == "__main__":
    main()
