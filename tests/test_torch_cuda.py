"""The hand-written CUDA kernels of como_tpu_torch against their plain
PyTorch versions on the card (marker `cuda`; they skip without a GPU).

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py   # on the GPU machine

(`--noconftest` skips tests/conftest.py's JAX set-up, which these tests do
not need.)

Tolerance 1e-5 abs / 1e-4 rel, the JAX package's Pallas-vs-XLA bound.
The downdate kernel uses plain sqrtf/expf/division and differs from its
plain version only in operation order and FMA contraction; the
cross-covariance kernel also splits the fourth root and uses the
rcp/sqrt/ex2 approximations (a few ulp each, ~1e-6 abs on K <= ~1)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from como_tpu_torch.utils.profiling import RECORDER

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _sites(g, n, dev):
    x = torch.rand((n, 2), generator=g) * 2 - 1
    e = torch.rand((n, 3), generator=g) * 0.3 + 0.1
    e[:, 2] = (torch.rand(n, generator=g) - 0.5) * 0.1
    return x.to(dev), e.to(dev)


def _offset_view(t):
    """The same values at an address 4 bytes past a 16-byte boundary
    (contiguous, but not aligned for vector loads)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


@pytest.mark.parametrize("N,M,offset", [
    (49152, 64, False), (700, 20, False), (1, 64, False), (64, 64, False), (37, 33, False),
    (49152, 62, False), (5, 4, False), (3, 1, False), (0, 64, False),
    (130, 64, True), (130, 63, True)])
def test_cross_covariance_kernel(cuda, N, M, offset):
    """Full tiles, ragged tiles, rows that are not 16-byte aligned
    (M % 4 != 0), inputs that are not 16-byte aligned, and the empty case."""
    from como_tpu_torch.gp import kernels_cuda

    g = torch.Generator().manual_seed(N + M)
    x_n, e_n = _sites(g, N, cuda)
    x_m, e_m = _sites(g, M, cuda)
    if offset:
        x_n, e_n, x_m, e_m = map(_offset_view, (x_n, e_n, x_m, e_m))
        assert x_n.data_ptr() % 16 == 4 and x_n.is_contiguous()
    n0 = RECORDER.counter("kernels.cross_covariance")
    got = kernels_cuda.cross_covariance(x_n, e_n, x_m, e_m, 1.3)
    torch.cuda.synchronize()
    assert RECORDER.counter("kernels.cross_covariance") == n0 + (1 if N * M else 0)
    assert got.shape == (N, M)
    want = kernels_cuda.cross_covariance_plain(x_n, e_n, x_m, e_m, 1.3)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("N,M", [(49152, 64), (37, 33)])
def test_cross_covariance_kernel_bitwise_repeatable(cuda, N, M):
    from como_tpu_torch.gp import kernels_cuda

    g = torch.Generator().manual_seed(1)
    args = (*_sites(g, N, cuda), *_sites(g, M, cuda), 0.7)
    a = kernels_cuda.cross_covariance(*args)
    b = kernels_cuda.cross_covariance(*args)
    assert torch.equal(a, b)


def test_cross_covariance_singular_and_unselected_anchors(cuda):
    """det(E_n + E_m) = 0 gives NaN as in the plain version; an all-zero
    (unselected) anchor against a proper site gives exactly 0."""
    from como_tpu_torch.gp import kernels_cuda

    z2, z3 = torch.zeros((1, 2), device=cuda), torch.zeros((1, 3), device=cuda)
    assert torch.isnan(kernels_cuda.cross_covariance(z2, z3, z2, z3, 1.0)).all()
    g = torch.Generator().manual_seed(2)
    x_n, e_n = _sites(g, 9, cuda)
    k = kernels_cuda.cross_covariance(x_n, e_n, z2.expand(5, 2), z3.expand(5, 3), 1.0)
    assert torch.equal(k, torch.zeros((9, 5), device=cuda))


def test_launches_by_shape_records_the_shape(cuda):
    from como_tpu_torch.gp import kernels_cuda

    g = torch.Generator().manual_seed(3)
    args = (*_sites(g, 11, cuda), *_sites(g, 6, cuda), 1.0)
    before = RECORDER.counter("kernels.cross_covariance", key=(11, 6))
    total = RECORDER.counter("kernels.cross_covariance")
    kernels_cuda.cross_covariance(*args)
    kernels_cuda.cross_covariance(*args)
    assert RECORDER.counter("kernels.cross_covariance", key=(11, 6)) == before + 2
    assert RECORDER.counter("kernels.cross_covariance") == total + 2
    assert sum(RECORDER.by_key("kernels.cross_covariance").values()) \
        == RECORDER.counter("kernels.cross_covariance")


def test_sampler_kernel_vs_plain(cuda):
    """A 64-step sampler call over a 192x256 domain: identical selections,
    obs_info / var within tolerance."""
    from como_tpu_torch.gp import sampler, sampler_cuda

    g = torch.Generator().manual_seed(0)
    D, S = 192 * 256, 64
    dom, e = _sites(g, D, cuda)
    valid = torch.ones(D, dtype=torch.bool, device=cuda)
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=cuda)  # noqa: E731
    args = (dom, e, valid, z(S, 2), z(S, 3), z(S, dt=torch.bool), z(S), 1.0, 0.0,
            1e-2, 0.1, S, False)
    rk, ok, vk, mk = sampler.greedy_entropy_loop(*args)
    rp, op, vp, mp = sampler.greedy_entropy_loop(*args,
                                                 downdate=sampler_cuda.downdate_step_plain)
    assert torch.equal(rk.domain_inds, rp.domain_inds)
    torch.testing.assert_close(ok, op, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(vk, vp, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mk, mp)


def test_kernel_wrappers_reject_bad_inputs(cuda):
    from como_tpu_torch.gp import kernels_cuda

    x = torch.zeros((4, 2), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):
        kernels_cuda.cross_covariance(x, x, x, x, 1.0)
    with pytest.raises(TypeError):
        xf = x.float()
        kernels_cuda.cross_covariance(xf, torch.zeros((4, 3), device=cuda), xf,
                                      torch.zeros((4, 3), device=cuda),
                                      torch.tensor(1.0, device=cuda))


def test_gn_step_bitwise_repeatable(cuda):
    from como_tpu_torch.odom import window as win
    from como_tpu_torch.odom.backend import gn_step

    dims = win.make_dims(num_kf=4, num_ow=3, M=16, img_size=(48, 64))
    st = win.empty_state(dims, device=cuda)
    g = torch.Generator().manual_seed(0)
    st.kf_valid[:3] = True
    st.lm_valid[:48] = True
    st.P_lm.copy_((torch.rand((dims.L, 3), generator=g) + torch.tensor([0, 0, 1.5])).to(cuda))
    st.anchor_lm[:3] = torch.arange(48, device=cuda).reshape(3, 16)
    st.kf_img.copy_(torch.rand(st.kf_img.shape, generator=g).to(cuda))
    st.dense_knm.copy_(torch.rand(st.dense_knm.shape, generator=g).to(cuda) / 16)
    K = torch.tensor([[57.6, 0, 31.5], [0, 57.6, 23.5], [0, 0, 1]], device=cuda)
    ref = torch.tensor(np.r_[[0, 1, 1, 2], np.zeros(10)], dtype=torch.int64, device=cuda)
    tgt = torch.tensor(np.r_[[1, 0, 2, 1], np.zeros(10)], dtype=torch.int64, device=cuda)
    val = torch.arange(14, device=cuda) < 4
    a, sa = gn_step._gn_step_impl(st, ref, tgt, val, K, dims, gn_step.SigmaStatic())
    b, sb = gn_step._gn_step_impl(st, ref, tgt, val, K, dims, gn_step.SigmaStatic())
    for f in a.fields():
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_gn_step_on_the_card_matches_the_cpu_step(cuda):
    """The GN system and step on the card against the CPU's on the same
    window (test_torch_gn_step's demo window, built on the CPU), at that
    test's JAX parity tolerances: the Jacobi-scaled system within 1e-4,
    poses and affine within 1e-4.  Landmarks move along the window's weak
    directions (Jacobi-scaled condition ~2e6), where two f32 solves agree
    only to ~cond * eps ~ 1e-1 of the step (test_torch_gn_step); the card's
    Cholesky, matmuls and cross-covariance kernel round differently from
    the CPU's, so they are held to a tenth of the CPU's largest landmark
    step."""
    from como_tpu_torch.odom import window as win
    from como_tpu_torch.odom.backend import gn_step as gs
    from como_tpu_torch.utils.demo import make_demo_state

    dims = win.make_dims(num_kf=4, num_ow=3, M=16, img_size=(48, 64))
    st, pairs, K = make_demo_state(dims, num_kf=3, num_ow=2, device="cpu")
    sig = gs.SigmaStatic(occlusion_thresh=0.1)
    st_c = st.replace(**{f: getattr(st, f).to(cuda) for f in st.fields()})
    args_c = (*(a.to(cuda) for a in pairs), K.to(cuda), dims, sig)
    H, g, e = gs.gn_system(st, *pairs, K, dims, sig)
    Hc, gc, ec = (t.cpu() for t in gs.gn_system(st_c, *args_c))
    d = torch.sqrt(torch.clamp(torch.diagonal(H).abs(), min=1e-20))
    np.testing.assert_allclose((Hc / d[:, None] / d).numpy(), (H / d[:, None] / d).numpy(),
                               atol=1e-4)
    np.testing.assert_allclose((gc / d).numpy(), (g / d).numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(float(ec), float(e), rtol=1e-4)
    s_cpu, g_cpu = gs._gn_step_impl(st, *pairs, K, dims, sig)
    s_gpu, g_gpu = gs._gn_step_impl(st_c, *args_c)
    for f in ("kf_pose", "ow_pose", "kf_aff"):
        np.testing.assert_allclose(getattr(s_gpu, f).cpu().numpy(),
                                   getattr(s_cpu, f).numpy(), atol=1e-4, err_msg=f)
    lm_step = float((s_cpu.P_lm - st.P_lm).abs().max())
    np.testing.assert_allclose(s_gpu.P_lm.cpu().numpy(), s_cpu.P_lm.numpy(),
                               atol=0.1 * lm_step)
    for a, b in zip(g_gpu, g_cpu):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-2, atol=1e-6)


# --- the runtimes on the card (48x64, 4 KF / 4 OW / 16 anchors) -----------------------

def _small_cfg(**top):
    from como_tpu_torch.config import ComoConfig

    cfg = ComoConfig()
    cfg.img_size = [48, 64]
    cfg.mapping.graph.num_keyframes = 4
    cfg.mapping.graph.num_one_way_frames = 4
    cfg.mapping.sampling.max_num_coords = 16
    cfg.mapping.sampling.border = 2
    for k, v in top.items():
        setattr(cfg, k, v)
    return cfg.validate()


def _plane(cuda, n=25, step=0.02):
    from como_tpu_torch.data.synthetic import SyntheticDataset

    return SyntheticDataset(n_frames=n, img_size=(48, 64), seed=0, step=step, device=cuda)


def _seq_run(cuda, cfg):
    from como_tpu_torch.runtime.seq import ComoSeq

    ds = _plane(cuda)
    eng = ComoSeq(cfg, ds.intrinsics, (48, 64), device="cuda")
    eng.setup()
    ts, est = eng.run(ds)
    return eng, ts, est


def test_split_specs_on_one_card_equal_the_fused_step(cuda):
    """tracking.device cuda:0 / mapping.device cuda:1 on a host with one
    card: both stages on cuda:0, the unfused step, the fused trajectory
    bit for bit."""
    fe, fts, fest = _seq_run(cuda, _small_cfg())
    cfg = _small_cfg()
    cfg.tracking.device, cfg.mapping.device = "cuda:0", "cuda:1"
    se, sts, sest = _seq_run(cuda, cfg)
    assert se.split_devices and se.track_dev.type == se.map_dev.type == "cuda"
    if torch.cuda.device_count() == 1:
        assert se.track_dev == se.map_dev == torch.device("cuda", 0)
        np.testing.assert_array_equal(sts, fts)
        np.testing.assert_array_equal(sest, fest)
    else:   # two cards: the same decisions, poses to f32 rounding
        assert se.map_dev == torch.device("cuda", 1)
        assert se.mapping.state.kf_pose.device == se.map_dev
        assert se.tracking.T_curr_kf.device == se.track_dev
        np.testing.assert_array_equal(sts, fts)
        np.testing.assert_allclose(sest, fest, atol=1e-3)


@pytest.mark.parametrize("option", ["frame_batch", "resolve_stride"])
def test_seq_options_repeat_bitwise_on_the_card(cuda, option):
    cfg = _small_cfg(dispatch_depth=2, **{option: 2})
    _, ts1, est1 = _seq_run(cuda, cfg)
    _, ts2, est2 = _seq_run(cuda, cfg)
    assert len(ts1) >= 15 and np.all(np.isfinite(est1))
    np.testing.assert_array_equal(ts1, ts2)
    np.testing.assert_array_equal(est1, est2)


def test_pipeline_on_the_card(cuda):
    """ComoPipeline over the native ring with both stages on the card:
    initialised, finite poses, threads gone; a stage that raises reaches
    the caller."""
    from como_tpu_torch.runtime.pipeline import ComoPipeline

    ds = _plane(cuda, 20, 0.012)
    eng = ComoPipeline(_small_cfg(), ds.intrinsics, (48, 64))
    assert type(eng.rgb_q).__name__ == "NativeQueue"
    eng.setup()
    for i in range(len(ds)):
        ts, rgb = ds[i]
        eng.step(float(ts), rgb)
    eng.shutdown(timeout=120.0)
    assert eng.mapping.is_init and len(eng.est_poses) > 5
    assert np.all(np.isfinite(eng.poses_numpy()))
    assert eng.mapping.state.kf_pose.is_cuda and eng.tracking.T_curr_kf.is_cuda
    assert not any(t.is_alive() for t in eng._threads)

    bad = ComoPipeline(_small_cfg(), ds.intrinsics, (48, 64))

    def boom(*a):
        raise ValueError("mapping broke")

    bad.mapping.attempt_two_frame_init = boom
    bad.setup()
    with pytest.raises(RuntimeError, match="mapping broke"):
        for i in range(len(ds)):
            bad.step(*ds[i])
        bad.shutdown(timeout=10.0)


def test_kernels_launch_on_their_tensors_device(cuda):
    """With two cards: a launch for tensors on cuda:1 while cuda:0 is the
    current device (the wrappers make the tensors' device current)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from como_tpu_torch.gp import kernels_cuda

    dev1 = torch.device("cuda", 1)
    g = torch.Generator().manual_seed(5)
    args = (*_sites(g, 700, dev1), *_sites(g, 20, dev1), 1.0)
    with torch.cuda.device(0):
        got = kernels_cuda.cross_covariance(*args)
    assert got.device == dev1
    torch.testing.assert_close(got, kernels_cuda.cross_covariance_plain(*args),
                               rtol=1e-4, atol=1e-5)


# --- multi-device mapping BA and the viewers on the card -------------------------------

def test_mesh_devices_beyond_the_visible_cards_raise(cuda):
    """A CUDA engine with more mesh devices than cards raises, naming
    mapping.mesh_devices; it never shares a card or falls back to the CPU."""
    from como_tpu_torch.runtime.seq import ComoSeq

    cfg = _small_cfg()
    cfg.mapping.mesh_devices = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match="mesh_devices"):
        ComoSeq(cfg.validate(), np.eye(3, dtype=np.float32), (48, 64), device="cuda")


@pytest.mark.parametrize("n", [2, 7])
def test_sharded_step_on_the_card(cuda, n):
    """The sharded step over n shards of cuda:0 on the demo window: the
    single step's sigma bit for bit, its update to tests/test_multichip.py's
    tolerances, and two sharded steps bitwise equal."""
    from como_tpu_torch.odom import window as win
    from como_tpu_torch.odom.backend import gn_step as gs
    from como_tpu_torch.parallel import sharded
    from como_tpu_torch.utils.demo import make_demo_state

    dims = win.make_dims(num_kf=4, num_ow=4, M=16, img_size=(48, 64))
    st, pairs, K = make_demo_state(dims, num_kf=3, num_ow=2, device=cuda)
    sig = gs.SigmaStatic()
    sc = gs._scaffold(st, K, dims)
    dn = gs._dense_points(st.replace(P_lm=sc["P_lm_new"]), sc, K, dims)
    res = [gs._photo_residual(st, sc, dn, *(a[s:s + 14 // n] for a in pairs), K, dims, 0.1)
           for s in range(0, 14, 14 // n)]
    whole = gs._photo_residual(st, sc, dn, *pairs, K, dims, 0.1)
    assert torch.equal(gs.photo_sigma(res, cuda), gs.photo_sigma([whole], cuda))
    st1, stats1 = gs._gn_step_impl(st, *pairs, K, dims, sig)
    step = sharded.make_sharded_gn_step([cuda] * n, dims, sig)
    st2, stats2 = step(st, *pairs, K)
    st3, stats3 = step(st, *pairs, K)
    torch.testing.assert_close(stats2.total_err, stats1.total_err, rtol=1e-3, atol=0)
    torch.testing.assert_close(st2.kf_pose, st1.kf_pose, atol=1e-4, rtol=0)
    torch.testing.assert_close(st2.P_lm, st1.P_lm, atol=1e-3, rtol=0)
    assert all(torch.equal(getattr(st2, f), getattr(st3, f)) for f in st2.fields())


def test_render_map_on_the_card(cuda):
    """render_map on the card against the same call on the CPU: depth
    within 1e-5 relative where both are set, colours within 1e-5 (the
    shading's convolutions sum in another order) on all but a few pixels
    (a projection's truncation can flip at the ulp level), two calls
    bitwise equal."""
    from como_tpu_torch.viz.renderer import render_map
    from torch_testing import render_scene

    args = [torch.from_numpy(np.array(a)) for a in render_scene(0)]
    rgb_c, depth_c = render_map(*args, out_size=(96, 128))
    rgb_g, depth_g = render_map(*(a.to(cuda) for a in args), out_size=(96, 128))
    rgb_2, depth_2 = render_map(*(a.to(cuda) for a in args), out_size=(96, 128))
    assert torch.equal(rgb_g, rgb_2) and torch.equal(depth_g, depth_2)
    rgb_g, depth_g = rgb_g.cpu(), depth_g.cpu()
    both = (depth_c > 0) & (depth_g > 0)
    torch.testing.assert_close(depth_g[both], depth_c[both], rtol=1e-5, atol=0)
    assert ((rgb_g - rgb_c).abs().amax(-1) > 1e-5).float().mean() < 0.01


# --- the cross-covariance's backward kernel, the trainer on the card -------------------

def _bwd_close(got, want):
    """Within 1e-5 abs + 1e-4 of the largest |grad| of the tensor."""
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 + 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("N,M", [(64, 64), (1024, 64), (49152, 64), (37, 33), (1, 5),
                                 (3000, 96), (49153, 64), (777, 131), (5000, 200)])
def test_cross_covariance_bwd_kernel(cuda, N, M):
    """The backward kernel against autograd of the plain version, twice
    bitwise equal; its launches counted apart from the forward's.  Beside
    the training and full sizes: N not a multiple of a block's sites (37,
    3,000, 49,153, 777, 5,000) and M not a multiple of 32.  The cases with
    more than one cluster take the ticket and the sum over clusters: 49,152
    and 49,153 x 64 (R = 48, 128 and 130 blocks in clusters of 2 on the
    H100), 3,000 x 96, 777 x 131 and 5,000 x 200; the last two (M > 128)
    walk two panels of anchors.  The others are one cluster."""
    from como_tpu_torch.gp import kernels_cuda

    g = torch.Generator().manual_seed(N + M)
    args = (*_sites(g, N, cuda), *_sites(g, M, cuda), 1.3)
    grad = torch.randn((N, M), generator=g).to(cuda)
    fwd = RECORDER.counter("kernels.cross_covariance")
    n0 = RECORDER.counter("kernels.cross_covariance_bwd")
    got = kernels_cuda.cross_covariance_bwd(grad, *args)
    again = kernels_cuda.cross_covariance_bwd(grad, *args)
    torch.cuda.synchronize()
    assert RECORDER.counter("kernels.cross_covariance_bwd") == n0 + 2
    assert RECORDER.counter("kernels.cross_covariance_bwd", key=(N, M)) >= 2
    assert RECORDER.counter("kernels.cross_covariance") == fwd
    _bwd_close(got, kernels_cuda.cross_covariance_vjp_plain(grad, *args))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("N,M", [(64, 64), (1024, 64), (49152, 64), (3000, 96)])
def test_cross_covariance_bwd_is_one_launch(cuda, N, M):
    """One call is one kernel on the card (torch.profiler counts the
    device's kernels: the sum over blocks is in the same launch, and no
    memset), and the ticket counters it uses are zero again after it.  A
    profile that lost events (none at all, or a count that is not a
    multiple of the calls, as seen on an H100 late in a long process) is
    taken again, up to three times, as chip_smoke's device_ms does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from como_tpu_torch.gp import kernels_cuda

    g = torch.Generator().manual_seed(3)
    args = (*_sites(g, N, cuda), *_sites(g, M, cuda), 1.0)
    grad = torch.randn((N, M), generator=g).to(cuda)
    kernels_cuda.cross_covariance_bwd(grad, *args)       # builds, allocates the counters
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                kernels_cuda.cross_covariance_bwd(grad, *args)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        seen.append([(e.key, e.count) for e in kern])
        if sum(e.count for e in kern) % 3 == 0 and kern:
            break
    assert sum(e.count for e in kern) == 3, seen
    assert all(int(c.abs().sum()) == 0 for c in kernels_cuda._BWD_COUNTERS.values())


def test_cross_covariance_grad_through_the_kernel(cuda):
    """With grad-requiring inputs the CUDA wrapper returns a tensor with a
    grad_fn whose backward is the kernel; K_mm passes the same anchors as
    both arguments and autograd sums the two grads (as the plain version's
    autograd does); a non-contiguous upstream grad is taken.  Without grad
    the direct launch stays: no grad_fn, no backward launch."""
    from como_tpu_torch.gp import kernels_cuda

    g = torch.Generator().manual_seed(7)
    x_m, e_m = (t.requires_grad_(True) for t in _sites(g, 64, cuda))
    x_n, e_n = (t.requires_grad_(True) for t in _sites(g, 1024, cuda))
    n_bwd = RECORDER.counter("kernels.cross_covariance_bwd")
    K_mm = kernels_cuda.cross_covariance(x_m, e_m, x_m, e_m, 1.0)
    K_nm = kernels_cuda.cross_covariance(x_n, e_n, x_m, e_m, 1.0)
    assert K_mm.grad_fn is not None and K_nm.grad_fn is not None
    G_mm = torch.randn((64, 64), generator=g).to(cuda).T       # strided
    G_nm = torch.randn((1024, 64), generator=g).to(cuda)
    got = torch.autograd.grad((K_mm * G_mm).sum() + (K_nm * G_nm).sum(), (x_m, e_m, x_n, e_n))
    assert RECORDER.counter("kernels.cross_covariance_bwd") == n_bwd + 2
    ins = [t.detach().requires_grad_(True) for t in (x_m, e_m, x_n, e_n)]
    L = ((kernels_cuda.cross_covariance_plain(ins[0], ins[1], ins[0], ins[1], 1.0) * G_mm).sum()
         + (kernels_cuda.cross_covariance_plain(ins[2], ins[3], ins[0], ins[1], 1.0)
            * G_nm).sum())
    _bwd_close(got, torch.autograd.grad(L, ins))
    n_fwd = RECORDER.counter("kernels.cross_covariance")
    with torch.no_grad():
        K = kernels_cuda.cross_covariance(x_n, e_n, x_m, e_m, 1.0)
    K2 = kernels_cuda.cross_covariance(x_n.detach(), e_n.detach(), x_m.detach(),
                                       e_m.detach(), 1.0)
    assert K.grad_fn is None and K2.grad_fn is None
    assert RECORDER.counter("kernels.cross_covariance") == n_fwd + 2
    assert RECORDER.counter("kernels.cross_covariance_bwd") == n_bwd + 2


def test_train_step_on_the_card(cuda):
    """A few trainer steps at full width with bf16 convolutions: finite
    loss and gradient norm, the backward kernel launched, the EMA saved
    and read back as the UNet prior."""
    from como_tpu_torch.gp import kernels_cuda
    from como_tpu_torch.net.depthcov import DepthCovPrior
    from como_tpu_torch.train import train_depthcov

    n_bwd = RECORDER.counter("kernels.cross_covariance_bwd")
    out = str(Path(__file__).resolve().parents[1] / "chiprun_out" / "test_train.msgpack")
    res = train_depthcov.main(["--steps", "4", "--val_every", "3", "--out", out])
    assert np.all(np.isfinite(res["losses"])) and np.all(np.isfinite(res["grad_norms"]))
    assert res["selected"] == "mse" and np.isfinite(res["best_score"])
    assert RECORDER.counter("kernels.cross_covariance_bwd") >= n_bwd + 2 * 4
    prior = DepthCovPrior("unet", out, device=cuda)
    cov = prior.cov_params(torch.rand((1, 3, 192, 256), device=cuda))
    assert cov.shape == (3, 192, 256) and bool(torch.isfinite(cov).all())


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("window", ["default", "stress"])
def test_sharded_step_bitwise_on_the_card(cuda, n, window):
    """The sharded GN step over n shards of cuda:0 equals the single step
    bit for bit on a full-size demo window (the default's 64 pairs, and
    chip_smoke's 18 KF / 48 OW stress window, 136 pairs in chunks of 46):
    the per-pair blocks do not depend on how many pairs a call gets."""
    from como_tpu_torch.odom import window as win
    from como_tpu_torch.odom.backend import gn_step as gs
    from como_tpu_torch.parallel import sharded
    from como_tpu_torch.utils.demo import make_demo_state

    if window == "default":
        dims, num_kf = win.make_dims(), 9
    else:
        dims, num_kf = win.make_dims(num_kf=18, num_ow=48), 18
        dims = dims._replace(P=-(-dims.P // 8) * 8)
    st, pairs, K = make_demo_state(dims, num_kf=num_kf, num_ow=8, device=cuda)
    sig = gs.SigmaStatic()
    st1, _ = gs._gn_step_impl(st, *pairs, K, dims, sig)
    st2, _ = sharded.make_sharded_gn_step([cuda] * n, dims, sig)(st, *pairs, K)
    for f in ("kf_pose", "ow_pose", "P_lm", "kf_aff", "ow_aff"):
        assert torch.equal(getattr(st2, f), getattr(st1, f)), f
