"""Port parity: the DepthCov UNet and the learned prior of como_tpu_torch
against como_tpu's flax UNet with the shipped weights
(models/depthcov.msgpack), CPU.  The network always runs at 192x256."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from como_tpu.net import unet as junet
from como_tpu.net.depthcov import DepthCovPrior as JPrior
from como_tpu.net.depthcov import load_params as jload
from como_tpu_torch.net import unet as tunet
from como_tpu_torch.net.depthcov import DepthCovPrior as TPrior
from como_tpu_torch.net.depthcov import load_params as tload
from como_tpu_torch.utils import flax_msgpack
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

CKPT = os.path.join(os.path.dirname(__file__), "..", "models", "depthcov.msgpack")
NET = (192, 256)


def _image(seed, hw=NET):
    """Smooth random image in [0, 1], (1, 3, H, W) f32."""
    rng = np.random.default_rng(seed)
    h, w = hw
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img = np.zeros((3, h, w))
    for c in range(3):
        for _ in range(6):
            fy, fx, ph = rng.uniform(1, 25), rng.uniform(1, 25), rng.uniform(0, 6.28)
            img[c] += rng.uniform(0.05, 0.2) * np.sin(fy * ys + fx * xs + ph)
    img += 0.02 * rng.normal(size=img.shape)
    return np.clip(0.5 + img, 0.0, 1.0).astype(np.float32)[None]


@pytest.fixture(scope="module")
def flax_params():
    return jload(CKPT)


@pytest.fixture(scope="module")
def jax_outs(flax_params):
    """flax UNet outputs (NCHW numpy, coarse -> fine) on image 0, for f32 and
    for bf16 convolutions."""
    x = jnp.transpose(jnp.asarray(_image(0)), (0, 2, 3, 1))
    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        outs = jax.jit(junet.UNet(compute_dtype=dt).apply)(flax_params, x)
        out[name] = [np.transpose(np.asarray(o), (0, 3, 1, 2)) for o in outs]
    return out


def _torch_unet(dtype):
    net = tunet.UNet(compute_dtype=dtype)
    net.load_state_dict(tload(CKPT, "cpu"), strict=True)
    return net.eval()


def test_state_dict_from_flax_is_complete():
    """strict=True load; every flax leaf is consumed exactly once and keeps
    its values (kernels HWIO -> OIHW)."""
    tree = flax_msgpack.load(CKPT)
    sd = tunet.unet_state_dict_from_flax(tree)
    leaves = jax.tree_util.tree_leaves(tree)
    assert len(sd) == len(leaves) == 108
    assert sum(v.numel() for v in sd.values()) == sum(a.size for a in leaves)
    net = tunet.UNet()
    res = net.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    k = tree["params"]["down2"]["conv1"]["kernel"]
    np.testing.assert_array_equal(net.down2.conv1.weight.detach().numpy(),
                                  np.transpose(k, (3, 2, 0, 1)))
    np.testing.assert_array_equal(net.up3_block.norm.weight.detach().numpy(),
                                  tree["params"]["up3_block"]["norm"]["scale"])
    assert all(p.dtype == torch.float32 for p in net.parameters())
    bad = {"params": {"base": {"kernel": k}}}
    with pytest.raises(ValueError):
        tunet.unet_state_dict_from_flax(bad)


def test_unet_f32_matches_flax(jax_outs):
    """f32 convolutions on both sides, all five levels: 1e-4 abs + 1e-4 rel
    (observed ~2e-5 abs on outputs that range to ~9)."""
    with torch.no_grad():
        outs = _torch_unet(torch.float32)(torch.from_numpy(_image(0)))
    assert len(outs) == 5
    for lvl, (got, want) in enumerate(zip(outs, jax_outs["f32"])):
        assert got.shape == want.shape == (1, 3, NET[0] >> (4 - lvl), NET[1] >> (4 - lvl))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4,
                                   err_msg=f"level {lvl}")


def test_unet_bf16_within_bf16_floor(jax_outs):
    """bf16 convolutions on both sides (the default).  The bound is the
    bf16 floor, not a port error: flax-bf16 differs from flax-f32 by as
    much as the port's bf16 differs from flax-bf16 (both asserted)."""
    with torch.no_grad():
        got = _torch_unet(torch.bfloat16)(torch.from_numpy(_image(0)))[-1].numpy()
    assert got.dtype == np.float32

    def dist(a, b):
        d = np.abs(a - b)
        return float(np.median(d / np.maximum(np.abs(b), 1e-12))), float(d.max())

    med_port, max_port = dist(got, jax_outs["bf16"][-1])
    med_floor, max_floor = dist(jax_outs["bf16"][-1], jax_outs["f32"][-1])
    assert med_port <= 2e-2 and max_port <= 0.5, (med_port, max_port)
    assert med_floor <= 2e-2 and max_floor <= 0.5, (med_floor, max_floor)
    assert med_port <= 3 * med_floor


def test_cov_activation_hard_inputs():
    """Beyond both clip bounds, saturated tanh, and x*z below the
    determinant guard (reachable only with a guard above the clip floor's
    1e-6, so it is also run at det_eps = 1e-5): 1e-6 relative."""
    rng = np.random.default_rng(3)
    p = rng.normal(size=(64, 3)).astype(np.float32) * 3
    p[:8, 0], p[8:16, 1] = -20.0, 30.0                     # beyond log(1e-3), log(1e4)
    p[16:24, 2], p[24:32, 2] = 40.0, -40.0                 # |tanh| -> 1
    p[32:40, :2] = np.log(1e-3) - 1.0                      # both clipped: x*z = 1e-6
    for eps in (1e-8, 1e-5):
        want = np.asarray(junet.cov_activation(jnp.asarray(p), det_eps=eps))
        got = tunet.cov_activation(torch.from_numpy(p), det_eps=eps).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
        assert np.all(np.isfinite(got))
    assert (got[32:40, 2] == 0).all()                      # guarded at det_eps = 1e-5
    assert (got[:8, 0] == np.float32(np.exp(np.float32(np.log(1e-3))))).all()
    got1 = tunet.cov_activation(torch.from_numpy(p.T.copy()), det_eps=1e-5, dim=0).numpy()
    np.testing.assert_array_equal(got1.T, got)


@pytest.mark.parametrize("hw", [(192, 256), (48, 64)], ids=["192x256", "48x64"])
def test_prior_unet_cov_params(hw, flax_params):
    """DepthCovPrior("unet").cov_params against the JAX prior with f32
    convolutions, at network size and at 48x64 (both resizes): 1e-4."""
    jp = JPrior("unet", CKPT)
    jp._unet = junet.UNet(compute_dtype=jnp.float32)
    rgb = _image(1, hw)
    want = np.asarray(jp._cov_params_impl(jnp.asarray(rgb), hw))
    tp = TPrior("unet", CKPT, device="cpu", compute_dtype=torch.float32)
    got = tp.cov_params(torch.from_numpy(rgb))
    assert got.shape == (3,) + hw and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_prior_unet_rejects_bad_network_size():
    with pytest.raises(ValueError, match="divisible by 32"):
        TPrior("unet", CKPT, network_size=(100, 130), device="cpu")
    with pytest.raises(ValueError, match="divisible by 32"):
        tunet.UNet()(torch.zeros(1, 3, 48, 64))
    with pytest.raises(ValueError):
        TPrior("resnet", device="cpu")


def test_prior_unet_random_init_is_seeded():
    a = TPrior("unet", device="cpu", seed=3)
    b = TPrior("unet", device="cpu", seed=3)
    c = TPrior("unet", device="cpu", seed=4)
    wa, wb, wc = (p.unet.down0.conv1.weight for p in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    cov = a.cov_params(torch.from_numpy(_image(2)))
    assert cov.shape == (3,) + NET and bool(torch.isfinite(cov).all())
    assert bool((cov[0] * cov[1] - cov[2] ** 2 > 0).all())


def test_model_path_resolves_against_repo_root(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sd = tload("models/depthcov.msgpack", "cpu")
    assert len(sd) == 108
    with pytest.raises(FileNotFoundError):
        tload("models/no_such_file.msgpack", "cpu")


@pytest.mark.parametrize("name,dtype", [("f32", torch.float32), ("bf16", torch.bfloat16)])
def test_golden_file_matches_port(name, dtype):
    """tests/data/unet_golden.npz (written by the JAX package through
    tests/torch_make_unet_golden.py) against the port on the CPU, with the
    input rebuilt from its seed and the check chip_smoke.py applies on the
    GPU."""
    import hashlib

    import chip_smoke

    gold = np.load(os.path.join(os.path.dirname(__file__), "data", "unet_golden.npz"))
    hw, stride = tuple(int(v) for v in gold["shape"]), int(gold["stride"])
    rgb = chip_smoke.golden_image(int(gold["seed"]), hw)
    assert rgb.shape == (1, 3) + NET and rgb.dtype == np.float32
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == str(gold["input_sha256"])
    cov = TPrior("unet", CKPT, device="cpu", compute_dtype=dtype).cov_params(
        torch.from_numpy(rgb)).numpy()
    err = chip_smoke.unet_golden_errors(cov[:, ::stride, ::stride], gold[name], f32=name == "f32")
    assert err["ok"], err
    # the check is not vacuous: the other dtype's golden fails the f32 tolerance
    other = gold["bf16" if name == "f32" else "f32"]
    assert not chip_smoke.unet_golden_errors(other, gold[name], f32=True)["ok"]
