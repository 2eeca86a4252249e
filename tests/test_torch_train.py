"""Port parity of the DepthCov training path (como_tpu_torch/train/, and
net/depthcov.save_params, gp/kernels_cuda's gradient) against the JAX
package and scripts/train_depthcov.py on the CPU, from the same numpy
inputs.

The loss and gradient tests use a small UNet (2 levels, base 16, f32
convolutions on both sides), 32x32 images, M = 16 anchors and 64 test
sites; JAX's side is jitted.  The finest head's bias is set to (-3, -3, 0):
kernels whose length scale is the anchors' spacing, as a trained prior
gives.  At bias 0 (a random UNet's output, length scales of half the
image) K_mm is so ill-conditioned that any two f32 computations of the
gradient differ by about 1e-3 of the largest |g|, JAX's own jit and eager
runs too (tests/torch_train_grad_spread.py prints the readings, against
an f64 run); there the GP part of the loss is held against JAX in f64."""

import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from como_tpu.gp import kernels as jkernels
from como_tpu.net import unet as junet
from como_tpu.net.depthcov import load_params as jload
from como_tpu.net.depthcov import save_params as jsave
from como_tpu_torch.gp import kernels_cuda
from como_tpu_torch.net import depthcov as tdepthcov
from como_tpu_torch.net import unet as tunet
from como_tpu_torch.train import data as tdata
from como_tpu_torch.train import loss as tloss
from como_tpu_torch.train.optim import Trainer, cosine_decay
from como_tpu_torch.utils.profiling import RECORDER
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

ROOT = Path(__file__).resolve().parents[1]
HW, M, N_TEST = (32, 32), 16, 64


@pytest.fixture(scope="module")
def jtrain():
    """scripts/train_depthcov.py, imported by path."""
    spec = importlib.util.spec_from_file_location("jax_train_depthcov",
                                                  ROOT / "scripts" / "train_depthcov.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small(jtrain):
    """(flax model, jitted value_and_grad of make_loss for nll 0.1 and 0)."""
    model = junet.UNet(num_levels=2, compute_dtype=jnp.float32)
    fns = {w: jax.jit(jax.value_and_grad(jtrain.make_loss(model, M=M, n_test=N_TEST,
                                                          nll_weight=w)))
           for w in (0.1, 0.0)}
    return model, fns


def _case(model, seed, head_bias=-3.0):
    """flax params (numpy tree; the finest head's bias (b, b, 0)), rgb,
    depth (a smooth surface with an invalid corner), the JAX key and its
    site draws as make_loss makes them."""
    H, W = HW
    params = jax.tree.map(np.array, model.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3))))
    params["params"]["head0"]["bias"] = np.array([head_bias, head_bias, 0.0], np.float32)
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(1, 3, H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    depth = (1.5 + 0.3 * np.sin(xx / 5.0 + seed) + 0.2 * np.cos(yy / 4.0)).astype(np.float32)
    depth = depth[None, None].copy()
    depth[0, 0, :4, :6] = 0.0
    key = jax.random.PRNGKey(seed + 10)
    k1, k2 = jax.random.split(key)
    span = jnp.array([H - 1, W - 1])
    rc_m = np.array(jax.random.uniform(k1, (M, 2)) * span)
    rc_n = np.array(jax.random.uniform(k2, (N_TEST, 2)) * span)
    return params, rgb, depth, key, rc_m, rc_n


def _port_net(params):
    net = tunet.UNet(num_levels=2, compute_dtype=torch.float32)
    net.load_state_dict(tunet.unet_state_dict_from_flax(params))
    return net


def _leaves(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_and_gradients_match_make_loss(small, seed):
    """One step's loss within 1e-4 abs of make_loss (its mse and nll terms
    cancel, so a relative bound means nothing); every parameter gradient
    within 1e-4 of the largest |g| over all leaves (conv biases in front of
    a GroupNorm have a true gradient of 0 and carry only rounding); the
    unused coarse head's gradient exactly 0 in both."""
    model, fns = small
    params, rgb, depth, key, rc_m, rc_n = _case(model, seed)
    val, g = fns[0.1](params, jnp.array(rgb), jnp.array(depth), key)
    net = _port_net(params)
    loss = tloss.depthcov_loss(net, torch.from_numpy(rgb), torch.from_numpy(depth),
                               torch.from_numpy(rc_m), torch.from_numpy(rc_n))
    loss.backward()
    assert abs(loss.item() - float(val)) <= 1e-4
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in net.named_parameters()}
    got = tunet.flax_tree_from_unet_state_dict(grads)
    want = jax.tree.map(np.asarray, g)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    gmax = max(float(np.abs(v).max()) for v in _leaves(want))
    worst = max(float(np.abs(a - b).max()) for a, b in zip(_leaves(got), _leaves(want)))
    assert worst <= 1e-4 * gmax, (worst, gmax)
    assert net.head1.weight.grad is None
    assert not np.any(want["params"]["head1"]["kernel"]) and not np.any(
        want["params"]["head1"]["bias"])


class _CovStub:
    """A model whose `apply` returns its parameter `cov` as the finest
    level: make_loss's GP part alone, differentiated w.r.t. the map."""

    def apply(self, params, x):
        return [params["cov"][None]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gp_loss_at_a_random_unets_length_scales_matches_in_f64(jtrain, seed):
    """At head bias 0 (the cov map of a random UNet) the port's GP loss and
    its gradient w.r.t. the cov map, both in f64, against make_loss's GP
    part in f64 (x64 on, the same key): the loss within 1e-10 abs, the
    gradient within 1e-9 of its largest |g| (measured: 2.1e-11 at most)."""
    model = junet.UNet(num_levels=2, compute_dtype=jnp.float32)
    params, rgb, depth, key, _, _ = _case(model, seed, head_bias=0.0)
    x = jnp.transpose(jnp.array(rgb), (0, 2, 3, 1))
    cov = np.asarray(model.apply(params, x)[-1][0], np.float64)           # (h, w, 3)
    with jax.enable_x64(True):
        vg = jax.jit(jax.value_and_grad(jtrain.make_loss(_CovStub(), M=M, n_test=N_TEST,
                                                         nll_weight=0.1)))
        val, g = vg({"cov": jnp.asarray(cov)}, jnp.asarray(rgb, jnp.float64),
                    jnp.asarray(depth, jnp.float64), key)
        k1, k2 = jax.random.split(key)
        span = jnp.array([HW[0] - 1, HW[1] - 1])
        rc_m = np.array(jax.random.uniform(k1, (M, 2)) * span)
        rc_n = np.array(jax.random.uniform(k2, (N_TEST, 2)) * span)
        val, want = float(val), np.asarray(g["cov"]).transpose(2, 0, 1)
    assert rc_m.dtype == np.float64 and want.dtype == np.float64
    c = torch.tensor(cov.transpose(2, 0, 1), requires_grad=True)
    loss = tloss.gp_loss(c, torch.from_numpy(depth.astype(np.float64)), torch.from_numpy(rc_m),
                         torch.from_numpy(rc_n))
    loss.backward()
    assert loss.dtype == torch.float64 and abs(loss.item() - val) <= 1e-10
    assert np.abs(c.grad.numpy() - want).max() <= 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("seed", [0, 1])
def test_mse_only_loss_matches(small, seed):
    """nll_weight 0 (the validation loss) within 1e-5 relative."""
    model, fns = small
    params, rgb, depth, key, rc_m, rc_n = _case(model, seed)
    val, _ = fns[0.0](params, jnp.array(rgb), jnp.array(depth), key)
    with torch.no_grad():
        got = tloss.depthcov_loss(_port_net(params), torch.from_numpy(rgb),
                                  torch.from_numpy(depth), torch.from_numpy(rc_m),
                                  torch.from_numpy(rc_n), nll_weight=0.0)
    assert abs(float(got) / float(val) - 1.0) <= 1e-5


def test_draw_sites_shapes_and_range():
    g = torch.Generator().manual_seed(0)
    rc_m, rc_n = tloss.draw_sites(g, 64, 1024, (96, 128))
    assert rc_m.shape == (64, 2) and rc_n.shape == (1024, 2)
    for rc in (rc_m, rc_n):
        assert float(rc.min()) >= 0 and float(rc[:, 0].max()) <= 95 and float(
            rc[:, 1].max()) <= 127
    again = tloss.draw_sites(torch.Generator().manual_seed(0), 64, 1024, (96, 128))
    assert torch.equal(rc_m, again[0]) and torch.equal(rc_n, again[1])


# --- the optimizer chain ---------------------------------------------------------------

def test_optimizer_chain_matches_optax():
    """Three updates (the first clipped) plus the EMA on fixed gradients
    against clip_by_global_norm(1) + adam(cosine_decay_schedule) and
    train_depthcov's EMA, within 1e-6."""
    rng = np.random.default_rng(0)
    p0 = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(7,)).astype(np.float32)]
    grads = [[rng.normal(size=a.shape).astype(np.float32) * s for a in p0]
             for s in (2.0, 0.1, 0.5)]
    steps, lr = 10, 3e-4
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.03)))
    params = [jnp.array(a) for a in p0]
    state, ema = tx.init(params), params
    for g in grads:
        upd, state = tx.update([jnp.array(x) for x in g], state)
        params = optax.apply_updates(params, upd)
        ema = jax.tree.map(lambda e, p: 0.999 * e + (1.0 - 0.999) * p, ema, params)
    tp = [torch.tensor(a, requires_grad=True) for a in p0]
    tr = Trainer(tp, lr, steps)
    norms = []
    for g in grads:
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        norms.append(float(tr.step()))
    assert norms[0] > 1.0 > norms[1]          # the first update was clipped
    for a, b in zip(params, tp):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=0, atol=1e-6)
    for a, b in zip(ema, tr.ema):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_cosine_schedule_matches_optax():
    sched, ref = cosine_decay(3e-4, 50, 0.03), optax.cosine_decay_schedule(3e-4, 50, alpha=0.03)
    for c in (0, 1, 7, 25, 49, 50, 60):
        assert abs(sched(c) - float(ref(c))) <= 1e-10


def test_trainer_gives_missing_grads_zeros_and_keeps_ema_in_given_tensors():
    a = torch.ones(3, requires_grad=True)
    b = torch.ones(2, requires_grad=True)
    ema = [torch.zeros(3), torch.zeros(2)]
    tr = Trainer([a, b], 1e-2, 5, ema=ema)
    assert torch.equal(ema[0], a.detach())
    a.grad = torch.ones(3)
    tr.step()
    assert torch.equal(b.grad, torch.zeros(2)) and torch.equal(b.detach(), torch.ones(2))
    assert float(a[0]) < 1.0 and tr.ema[0].data_ptr() == ema[0].data_ptr()
    assert float(ema[0][0]) < 1.0


# --- the cross-covariance's gradient ---------------------------------------------------

def _sites(rng, n):
    x = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    e = rng.uniform(0.1, 0.4, size=(n, 3)).astype(np.float32)
    e[:, 2] = rng.uniform(-0.05, 0.05, size=n)
    return x, e


def _bwd_reassociated(grad, x_n, e_n, x_m, e_m, scale):
    """The backward kernel's arithmetic (csrc/gp_kernels.cu), step by step in f32:
    per output dL/dd, dL/ds and G dK/dC C from the recomputed pair terms,
    summed over anchors and over sites."""
    rn = torch.sqrt(torch.sqrt(e_n[:, 0] * e_n[:, 1] - e_n[:, 2] * e_n[:, 2]))[:, None]
    rm = torch.sqrt(torch.sqrt(e_m[:, 0] * e_m[:, 1] - e_m[:, 2] * e_m[:, 2]))[None, :]
    d0 = x_n[:, None, 0] - x_m[None, :, 0]
    d1 = x_n[:, None, 1] - x_m[None, :, 1]
    s00 = e_n[:, None, 0] + e_m[None, :, 0]
    s11 = e_n[:, None, 1] + e_m[None, :, 1]
    s01 = e_n[:, None, 2] + e_m[None, :, 2]
    inv = 1.0 / (s00 * s11 - s01 * s01)
    quad = s11 * d0 * d0 - 2.0 * s01 * d0 * d1 + s00 * d1 * d1
    t = kernels_cuda.SQRT3 * torch.sqrt(0.5 * inv * quad + kernels_cuda._EPS)
    ex = torch.exp(-t)
    h = torch.sqrt(torch.clamp(inv, min=0.0) + kernels_cuda._EPS)
    C = 2.0 * rn * rm * h
    gQ = -1.5 * scale * C * ex * grad
    gC = scale * (1.0 + t) * ex * grad
    g_quad = 0.5 * inv * gQ
    g_inv = 0.5 * quad * gQ + torch.where(inv > 0.0, gC * rn * rm / h, torch.zeros_like(h))
    g_det = -g_inv * inv * inv
    v = torch.stack([2.0 * g_quad * (s11 * d0 - s01 * d1),
                     2.0 * g_quad * (s00 * d1 - s01 * d0),
                     g_quad * d1 * d1 + g_det * s11,
                     g_quad * d0 * d0 + g_det * s00,
                     -2.0 * (g_quad * d0 * d1 + g_det * s01),
                     gC * C], -1)                      # (N, M, 6)

    def finish(s, e):
        g_d = s[:, 5] / (4.0 * (e[:, 0] * e[:, 1] - e[:, 2] * e[:, 2]))
        return s[:, :2], torch.stack([s[:, 2] + g_d * e[:, 1], s[:, 3] + g_d * e[:, 0],
                                      s[:, 4] - 2.0 * g_d * e[:, 2]], -1)

    g_xn, g_en = finish(v.sum(1), e_n)
    g_xm, g_em = finish(v.sum(0), e_m)
    return g_xn, g_en, -g_xm, g_em


@pytest.mark.parametrize("N,M,same", [(50, 16, False), (16, 16, True), (1, 7, False)])
def test_cross_covariance_vjp_matches_jax(N, M, same):
    """The plain VJP (the backward kernel's reference), and the kernel's own
    arithmetic in plain PyTorch, against jax.vjp of the JAX package's
    cross_covariance; `same`: K_mm with one anchor set on both sides, the
    two grads summed."""
    rng = np.random.default_rng(N + M)
    x_n, e_n = _sites(rng, N)
    x_m, e_m = (x_n, e_n) if same else _sites(rng, M)
    G = rng.normal(size=(N, M)).astype(np.float32)
    if same:
        fn, ins = (lambda x, e: jkernels.cross_covariance(x, e, x, e, 1.3)), (x_n, e_n)
    else:
        fn, ins = (lambda *a: jkernels.cross_covariance(*a, 1.3)), (x_n, e_n, x_m, e_m)
    want = [np.asarray(v) for v in
            jax.jit(lambda g, *a: jax.vjp(fn, *a)[1](g))(jnp.array(G), *ins)]
    t = [torch.from_numpy(a) for a in (G, x_n, e_n, x_m, e_m)]
    for fn in (kernels_cuda.cross_covariance_bwd, _bwd_reassociated):
        got = [v.numpy() for v in fn(*t, 1.3)]
        if same:
            got = [got[0] + got[2], got[1] + got[3]]
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 + 1e-4 * np.abs(b).max())


def test_cross_covariance_on_cpu_keeps_autograd_and_launches_nothing():
    rng = np.random.default_rng(3)
    x_n, e_n = (torch.from_numpy(a).requires_grad_(True) for a in _sites(rng, 9))
    x_m, e_m = (torch.from_numpy(a) for a in _sites(rng, 4))
    n0 = RECORDER.counter("kernels.cross_covariance_bwd")
    K = kernels_cuda.cross_covariance(x_n, e_n, x_m, e_m, 1.0)
    assert K.grad_fn is not None
    K.sum().backward()
    assert e_n.grad is not None and bool(torch.isfinite(e_n.grad).all())
    assert RECORDER.counter("kernels.cross_covariance_bwd") == n0
    assert RECORDER.by_key("kernels.cross_covariance_bwd") == {}


# --- the checkpoint ----------------------------------------------------------------------

def test_save_params_round_trip_through_both_packages(tmp_path):
    """save_params of a randomly initialised port UNet: JAX's load_params
    reads exactly its arrays, the port's load_params reads them bitwise, and
    the file is byte for byte what JAX's save_params writes for them."""
    net = tunet.UNet()
    tunet.init_unet_(net, torch.Generator().manual_seed(4))
    path = tmp_path / "ck.msgpack"
    tdepthcov.save_params(net, str(path))
    tree = tunet.flax_tree_from_unet_state_dict(net.state_dict())
    loaded = jax.tree.map(np.asarray, jload(str(path)))
    assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(tree)
    for a, b in zip(_leaves(loaded), _leaves(tree)):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    back = tdepthcov.load_params(str(path), "cpu")
    for k, v in net.state_dict().items():
        assert torch.equal(back[k], v), k
    jsave(tree, str(tmp_path / "jax.msgpack"))
    assert path.read_bytes() == (tmp_path / "jax.msgpack").read_bytes()


def test_save_params_of_the_shipped_checkpoint_is_the_file():
    sd = tdepthcov.load_params(str(ROOT / "models" / "depthcov.msgpack"), "cpu")
    tree = tunet.flax_tree_from_unet_state_dict(sd)
    from como_tpu_torch.utils import flax_msgpack

    assert flax_msgpack.packb(tree) == (ROOT / "models" / "depthcov.msgpack").read_bytes()


def test_flax_tree_rejects_unknown_parameters():
    with pytest.raises(ValueError, match="not a UNet parameter"):
        tunet.flax_tree_from_unet_state_dict({"base.conv1.running_mean": torch.zeros(3)})


# --- the data ----------------------------------------------------------------------------

@pytest.mark.parametrize("key_seed", [0, 5])
def test_synthetic_batch_matches_jax(jtrain, key_seed):
    """The view JAX's synthetic_batch renders for a key is the port's
    synthetic_view of the same integer draw (scene, view and jitter)."""
    key = jax.random.PRNGKey(key_seed)
    seed = int(jax.random.randint(key, (), 0, 1 << 20))
    rgb_j, depth_j = jtrain.synthetic_batch(key, (32, 64))
    rgb_t, depth_t = tdata.synthetic_view(seed, (32, 64), device="cpu")
    atol = 5e-5 if seed % 12 % 6 in (1, 4, 5) else 1e-5
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=atol)
    np.testing.assert_allclose(depth_t.numpy(), np.asarray(depth_j), rtol=1e-4)


def test_synthetic_batch_covers_the_six_kinds():
    rng = np.random.default_rng(0)
    rgb, depth = tdata.synthetic_batch(rng, (32, 64), device="cpu")
    assert rgb.shape == (1, 3, 32, 64) and depth.shape == (1, 1, 32, 64)
    kinds = {type(tdata._make_scene(s, (32, 64), "cpu")).__name__ for s in range(6)}
    assert kinds == {"PlaneScene", "ClutterScene"}
    assert tdata._make_scene(3, (32, 64), "cpu").chroma and tdata._make_scene(
        4, (32, 64), "cpu").chroma


def _write_tum(root: Path, n=4):
    import cv2

    rng = np.random.default_rng(0)
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb_lines, dep_lines = ["# rgb"], ["# depth"]
    for i in range(n):
        t = 1.0 + 0.1 * i
        cv2.imwrite(str(root / "rgb" / f"{i}.png"),
                    rng.integers(0, 255, size=(60, 80, 3), dtype=np.uint8))
        cv2.imwrite(str(root / "depth" / f"{i}.png"),
                    rng.integers(0, 30000, size=(60, 80), dtype=np.uint16))
        rgb_lines.append(f"{t:.4f} rgb/{i}.png")
        dep_lines.append(f"{t + 0.01:.4f} depth/{i}.png")
    dep_lines.append("9.0 depth/0.png")                 # far from every rgb stamp
    (root / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("\n".join(dep_lines) + "\n")


def test_rgbd_folder_matches_jax(jtrain, tmp_path):
    """TUM and ScanNet-style folders: the same pairs, and sample() gives
    JAX's arrays for the same generator state."""
    import cv2

    _write_tum(tmp_path / "tum")
    sc = tmp_path / "scannet"
    (sc / "color").mkdir(parents=True)
    (sc / "depth").mkdir()
    rng = np.random.default_rng(1)
    for i in (0, 2, 3):
        cv2.imwrite(str(sc / "color" / f"{i}.jpg"),
                    rng.integers(0, 255, size=(40, 48, 3), dtype=np.uint8))
    for i in (0, 1, 2):
        cv2.imwrite(str(sc / "depth" / f"{i}.png"),
                    rng.integers(0, 5000, size=(40, 48), dtype=np.uint16))
    for root in (tmp_path / "tum", sc):
        j = jtrain.RgbdFolder(str(root), (24, 32))
        t = tdata.RgbdFolder(str(root), (24, 32), device="cpu")
        assert t.pairs == j.pairs and t.depth_scale == j.depth_scale
        rj, rt = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(3):
            (a, b), (c, d) = j.sample(rj), t.sample(rt)
            np.testing.assert_array_equal(c.numpy(), np.asarray(a))
            np.testing.assert_array_equal(d.numpy(), np.asarray(b))
    assert len(tdata.RgbdFolder(str(tmp_path / "tum"), (24, 32), device="cpu").pairs) == 4
    with pytest.raises(FileNotFoundError):
        tdata.RgbdFolder(str(tmp_path), (24, 32), device="cpu")


def test_rgbd_folder_names_cv2_when_missing(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        tdata.RgbdFolder(str(tmp_path), (24, 32), device="cpu")


def test_train_package_has_no_scripts_dependency():
    """The port's trainer lives in como_tpu_torch/train/, not scripts/."""
    files = sorted(p.name for p in (ROOT / "como_tpu_torch" / "train").glob("*.py"))
    assert files == ["__init__.py", "data.py", "loss.py", "optim.py", "select_checkpoint.py",
                     "train_depthcov.py"]
    assert os.path.exists(ROOT / "scripts" / "train_depthcov.py")
