"""Port parity of the multi-device mapping BA (parallel/sharded.py): the
sharded histogram median, the split photometric linearization, the sharded
GN step against the single-device step and against the JAX package's
shard_map step, and `mapping.mesh_devices` through ComoSeq (CPU, 48x64,
the small_config of tests/test_multichip.py: P = 16 pairs)."""

import jax
import numpy as np
import pytest
import torch

from como_tpu.config import ComoConfig as JConfig
from como_tpu.data.synthetic import SyntheticDataset
from como_tpu.runtime.seq import ComoSeq as JSeq
from como_tpu_torch.config import ComoConfig as TConfig
from como_tpu_torch.odom import window as twin
from como_tpu_torch.odom.backend import gn_step as tgn
from como_tpu_torch.ops import reduce as treduce
from como_tpu_torch.parallel import sharded
from como_tpu_torch.runtime.seq import ComoSeq as TSeq
from como_tpu_torch.utils.demo import make_demo_state
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

IMG = (48, 64)


def small_config(cls, mesh_devices=0):
    """tests/test_multichip.py::small_config, for either package's config."""
    cfg = cls()
    cfg.img_size = list(IMG)
    cfg.mapping.graph.num_keyframes = 4
    cfg.mapping.graph.num_one_way_frames = 5  # P = 6 + 10 = 16 = 8 * 2
    cfg.mapping.sampling.max_num_coords = 16
    cfg.mapping.sampling.border = 2
    cfg.mapping.mesh_devices = mesh_devices
    return cfg.validate()


def _split(x, cuts):
    return [x[:, a:b] for a, b in zip((0,) + cuts, cuts + (x.shape[1],))]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cuts", [(), (300,), (100, 250), (50, 100, 250, 400, 401, 600, 999)],
                         ids=["1", "2", "3", "8"])
def test_histogram_median_shards_bitwise(seed, cuts):
    """The median of data split over shards is bitwise the median of the
    concatenation, whatever the split, shards with no valid sample
    (columns 100-249) included."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, 1000, generator=g) * (seed + 1)
    m = torch.rand(3, 1000, generator=g) > 0.4
    m[:, 100:250] = False                      # a shard with no valid sample
    m[2] = False                               # a row with none at all
    got = treduce.histogram_median_shards(_split(x, cuts), _split(m, cuts), "cpu")
    assert torch.equal(got, treduce.histogram_median_rows(x, m))
    sig = treduce.fast_mad_sigma_shards(_split(x[:2], cuts), _split(m[:2], cuts), "cpu")
    assert torch.equal(sig, treduce.fast_mad_sigma(x[:2], m[:2]))


@pytest.mark.parametrize("P", [64, 136, 288, 17, 130])
def test_pair_einsum_chunks_are_one_einsum(P):
    """The chunked contraction of the per-pair blocks (calls of exactly
    pair_chunk pairs: the last one overlapping, a shard's few pairs padded)
    is the one einsum over all pairs; the chunk is the most even split of
    the default (64), stress (136) and radius (288) windows' pairs."""
    window_P = {17: 136, 130: 130}.get(P, P)
    chunk = tgn.pair_chunk(window_P)
    assert chunk == {64: 64, 136: 46, 288: 58, 130: 44}[window_P]
    g = torch.Generator().manual_seed(P)
    a, b = (torch.randn((P, 2, 5, 8), generator=g, dtype=torch.float64) for _ in range(2))
    for eq, ops in (("pcnk,pcnl->pkl", (a, b)), ("pn,pnm->pm", (a[:, 0, :, 0], a[:, 1]))):
        got = tgn._pair_einsum(eq, chunk, *ops)
        want = torch.einsum(eq, *ops)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("occl", [0.1, 0.0])
def test_split_photo_is_the_inline_photo(occl):
    """_photo (residual half, sigma, per-pair blocks, grids) computes
    bitwise what the inline version did: the sigma of fast_mad_sigma over
    (P, C*ND); and the sigma over the residual halves of 6 pair shards is
    the same value."""
    dims = twin.make_dims(num_kf=4, num_ow=3, M=16, img_size=IMG)
    st, pairs, K = make_demo_state(dims, num_kf=3, num_ow=2, device="cpu")
    sc = tgn._scaffold(st, K, dims)
    st = st.replace(P_lm=sc["P_lm_new"])
    dn = tgn._dense_points(st, sc, K, dims)
    got = tgn._photo(st, sc, dn, *pairs, K, dims, occl_thresh=occl)
    res = tgn._photo_residual(st, sc, dn, *pairs, K, dims, occl)
    P, C, ND = res["r"].shape
    sigma = treduce.fast_mad_sigma(
        res["r"].reshape(P, C * ND), res["valid_c"].expand(res["r"].shape).reshape(P, C * ND)
    ) + 1e-12
    want = tgn._photo_grids(tgn._photo_pair_blocks(res, sigma, K, dims), dims)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert P == 12
    parts = [tgn._photo_residual(st, sc, dn, *(a[s:s + 2] for a in pairs), K, dims, occl)
             for s in range(0, P, 2)]
    assert torch.equal(tgn.photo_sigma(parts, "cpu"), sigma)


@pytest.fixture(scope="module")
def runs():
    """The port's product run with mesh_devices 0 and 8 and the JAX
    package's with mesh_devices 8, on the same frames."""
    ds = SyntheticDataset(n_frames=18, img_size=IMG, seed=0, step=0.012)
    frames = [ds[i] for i in range(len(ds))]
    out = {}
    for name, mesh in (("t1", 0), ("t8", 8)):
        eng = TSeq(small_config(TConfig, mesh), ds.intrinsics, IMG, device="cpu")
        eng.setup()
        ts, est = eng.run(frames)
        out[name] = (eng, np.asarray(ts), np.asarray(est))
    je = JSeq(small_config(JConfig, 8), ds.intrinsics, IMG)
    je.setup()
    ts, est = je.run(frames)
    out["j8"] = (je, np.asarray(ts), np.asarray(est))
    return out


def _close_steps(st1, stats1, st2, stats2):
    """tests/test_multichip.py's tolerances for a sharded step."""
    np.testing.assert_allclose(float(stats2.total_err), float(stats1.total_err), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(st2.kf_pose), np.asarray(st1.kf_pose), atol=1e-4)
    np.testing.assert_allclose(np.asarray(st2.P_lm), np.asarray(st1.P_lm), atol=1e-3)


def test_sharded_matches_single(runs):
    m = runs["t1"][0].mapping
    step = sharded.make_sharded_gn_step(sharded.make_mesh(["cpu"] * 8), m.dims, m.sigmas,
                                        m.cfg.gn_damping)
    st1, stats1 = tgn._gn_step_impl(m.state, *m._pairs, m.K, m.dims, m.sigmas,
                                    m.cfg.gn_damping)
    st2, stats2 = step(m.state, *m._pairs, m.K)
    _close_steps(st1, stats1, st2, stats2)
    # the grids are accumulated once over all pairs, as in the single step:
    # the new window is the single step's bit for bit (only the photometric
    # error is summed per shard)
    assert all(torch.equal(getattr(st1, f), getattr(st2, f)) for f in st1.fields())
    # three steps in a row stay finite, and two steps on one state are
    # bitwise equal (the outputs are summed in shard order)
    st = m.state
    for _ in range(3):
        st, stats = step(st, *m._pairs, m.K)
        assert np.isfinite(float(stats.total_err))
    st3, stats3 = step(m.state, *m._pairs, m.K)
    assert all(torch.equal(getattr(st2, f), getattr(st3, f)) for f in st2.fields())
    assert all(torch.equal(a, b) for a, b in zip(stats2, stats3))
    with pytest.raises(ValueError, match="split"):
        sharded.make_sharded_gn_step(["cpu"] * 3, m.dims, m.sigmas)(m.state, *m._pairs, m.K)


def test_sharded_matches_jax_sharded(runs):
    """The port's sharded step and the JAX package's shard_map step (8
    virtual CPU devices, tests/conftest.py) on the JAX engine's window."""
    jm = runs["j8"][0].mapping
    assert len(jax.devices()) == 8 and jm.uses_mesh
    st_j, stats_j = jm._sharded_step(jm.state, *jm._pairs, jm.K)
    state = twin.state_from_numpy({k: np.asarray(v) for k, v in jm.state._asdict().items()},
                                  "cpu")
    pairs = [torch.from_numpy(np.asarray(a)) for a in jm._pairs]
    pairs[:2] = [a.to(torch.int64) for a in pairs[:2]]
    m = runs["t8"][0].mapping
    assert m.dims == twin.WindowDims(*jm.dims)
    step = sharded.make_sharded_gn_step(sharded.make_mesh(["cpu"] * 8), m.dims, m.sigmas,
                                        m.cfg.gn_damping)
    st_t, stats_t = step(state, *pairs, torch.from_numpy(np.asarray(jm.K)))
    _close_steps(st_j, stats_j, st_t, stats_t)


def test_mesh_product_matches_single_device_and_jax(runs):
    """mapping.mesh_devices: 8 drives ComoSeq -> Mapping.iterate -> the
    sharded step: the single-device run's decisions, poses within 2e-3
    (test_multichip.py), and the JAX engine's decisions, poses within 5 mm."""
    (e1, ts1, est1), (e8, ts8, est8), (je, tsj, estj) = runs["t1"], runs["t8"], runs["j8"]
    assert e8.mapping.uses_mesh and not e1.mapping.uses_mesh
    assert e8.mapping.total_iters > 0 and len(e8.mapping.mesh) == 8
    np.testing.assert_array_equal(ts1, ts8)
    assert e1.mapping.kf_ts == e8.mapping.kf_ts
    np.testing.assert_allclose(est1, est8, atol=2e-3)
    np.testing.assert_allclose(e1.mapping.state.kf_pose.numpy(),
                               e8.mapping.state.kf_pose.numpy(), atol=2e-3)
    np.testing.assert_allclose(ts8, tsj, atol=1e-6)
    assert e8.mapping.kf_ts == pytest.approx(je.mapping.kf_ts)
    assert e8.mapping.total_iters == je.mapping.total_iters
    assert np.abs(est8[:, :3, 3] - estj[:, :3, 3]).max() < 5e-3


def test_mesh_pair_capacity_rounds_up():
    """A mesh that does not divide the pair capacity gets it rounded up
    (the extra slots are invalid pairs), as in the JAX package."""
    cfg = small_config(TConfig, 3)
    eng = TSeq(cfg, np.eye(3, dtype=np.float32) * 50 + np.diag([0, 0, -49]), IMG,
               device="cpu")
    eng.setup()
    m = eng.mapping
    assert m.uses_mesh and m.mesh == [torch.device("cpu")] * 3
    m._rebuild_pairs()
    assert m.dims.P == 18 and all(a.shape == (18,) for a in m._pairs)
    assert eng.track_dev == eng.map_dev == torch.device("cpu") and not eng.split_devices
    # the pipeline's stages, too, share the engine's default device
    from como_tpu_torch.runtime.pipeline import ComoPipeline

    cfg.tracking.device, cfg.mapping.device = "cpu:0", "cpu:1"
    pipe = ComoPipeline(cfg.validate(), np.eye(3, dtype=np.float32), IMG, device="cpu")
    assert pipe.track_dev == pipe.map_dev == torch.device("cpu") and pipe.mapping.uses_mesh
