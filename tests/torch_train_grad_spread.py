"""How far apart computations of the DepthCov training loss and gradient are
on tests/test_torch_train.py's small case (2-level UNet, 32x32, M = 16
anchors, 64 test sites), at a finest-head bias b (the head's bias is
(b, b, 0); 0 is a random UNet's length scales, -3 the tests' default):

  jit    JAX's jitted value_and_grad of scripts/train_depthcov.make_loss, f32
  eager  the same op by op (about a minute for the first case on a CPU)
  port   como_tpu_torch.train.loss under torch autograd on the CPU, f32
  f64    make_loss jitted in f64 (a worker process with x64 on; the UNet,
         its GroupNorm and heads and the GP in f64, fed the f32 site draws)

For each pair, the largest |difference| over all gradient leaves divided by
the largest |g| of the f64 run (`grad_rel`), and the loss's abs
difference (`loss_abs`).  One JSON line per (seed, bias).  Run by path,
not collected:

    JAX_PLATFORMS=cpu python tests/torch_train_grad_spread.py [--seeds 0 1 2] [--biases 0 -3] [--no-eager]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def _jax_setup(x64: bool = False) -> None:
    """JAX as the tests configure it (tests/conftest.py): the CPU, highest
    matmul precision."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    jax.config.update("jax_enable_x64", x64)


class _F64:
    """A stand-in for a module's `jnp` whose float32 is float64."""

    def __init__(self, jnp):
        self._jnp = jnp

    def __getattr__(self, name):
        return self._jnp.float64 if name == "float32" else getattr(self._jnp, name)


def _jax_script():
    """scripts/train_depthcov.py, imported by path."""
    spec = importlib.util.spec_from_file_location("jax_train_depthcov",
                                                  HERE.parent / "scripts" / "train_depthcov.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f64_worker(inp: str, out: str) -> None:
    """make_loss in f64 on the case pickled at `inp`; the loss and the
    gradient leaves to the npz `out`."""
    _jax_setup(x64=True)
    import jax
    import jax.numpy as jnp

    import test_torch_train as T
    from como_tpu.net import unet as junet

    jtrain = _jax_script()
    with open(inp, "rb") as f:
        params, rgb, depth, key = pickle.load(f)
    junet.jnp = jtrain.jnp = _F64(jnp)
    uniform = jax.random.uniform
    jax.random.uniform = lambda k, shape: uniform(k, shape, jnp.float32).astype(jnp.float64)
    model = junet.UNet(num_levels=2, compute_dtype=jnp.float64)
    fn = jax.jit(jax.value_and_grad(jtrain.make_loss(model, M=T.M, n_test=T.N_TEST,
                                                     nll_weight=0.1)))
    p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    val, g = fn(p64, jnp.asarray(rgb, jnp.float64), jnp.asarray(depth, jnp.float64),
                jnp.asarray(key))
    leaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(g)]
    np.savez(out, val=np.asarray(val), **{f"g{i}": v for i, v in enumerate(leaves)})


def _case_line(T, jtrain, seed: int, bias: float, eager: bool) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from como_tpu.net import unet as junet
    from como_tpu_torch.net import unet as tunet
    from como_tpu_torch.train import loss as tloss

    model = junet.UNet(num_levels=2, compute_dtype=jnp.float32)
    params, rgb, depth, key, rc_m, rc_n = T._case(model, seed, bias)
    vg = jax.value_and_grad(jtrain.make_loss(model, M=T.M, n_test=T.N_TEST, nll_weight=0.1))
    args = (params, jnp.array(rgb), jnp.array(depth), key)
    runs = {}
    val, g = jax.jit(vg)(*args)
    runs["jit"] = (float(val), T._leaves(g))
    if eager:
        t = time.perf_counter()
        with jax.disable_jit():
            val, g = vg(*args)
        runs["eager"] = (float(val), T._leaves(g))
        eager_s = time.perf_counter() - t
    net = T._port_net(params)
    loss = tloss.depthcov_loss(net, torch.from_numpy(rgb), torch.from_numpy(depth),
                               torch.from_numpy(rc_m), torch.from_numpy(rc_n))
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in net.named_parameters()}
    runs["port"] = (loss.item(), T._leaves(tunet.flax_tree_from_unet_state_dict(grads)))
    with tempfile.TemporaryDirectory() as d:
        inp, out = os.path.join(d, "case.pkl"), os.path.join(d, "f64.npz")
        with open(inp, "wb") as f:
            pickle.dump((params, rgb, depth, np.asarray(key)), f)
        subprocess.run([sys.executable, __file__, "--f64-worker", inp, out], check=True,
                       stdout=subprocess.DEVNULL)
        z = np.load(out)
        runs["f64"] = (float(z["val"]), [z[f"g{i}"] for i in range(len(z.files) - 1)])
    gmax = max(float(np.abs(v).max()) for v in runs["f64"][1])
    line = dict(seed=seed, head_bias=bias, gmax_f64=gmax)
    names = list(runs)
    for a_i, a in enumerate(names):
        for b in names[a_i + 1:]:
            worst = max(float(np.abs(x - y).max()) for x, y in zip(runs[a][1], runs[b][1]))
            line[f"{a}_vs_{b}"] = dict(grad_rel=worst / gmax,
                                       loss_abs=abs(runs[a][0] - runs[b][0]))
    if eager:
        line["eager_s"] = eager_s
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--biases", type=float, nargs="+", default=[0.0, -3.0])
    p.add_argument("--no-eager", action="store_true")
    p.add_argument("--f64-worker", nargs=2, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.f64_worker:
        _f64_worker(*args.f64_worker)
        return 0
    _jax_setup()
    import test_torch_train as T
    jtrain = _jax_script()
    for bias in args.biases:
        for seed in args.seeds:
            print(json.dumps(_case_line(T, jtrain, seed, bias, not args.no_eager)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
