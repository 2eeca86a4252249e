"""sampling.mode "random_uniform" in como_tpu_torch: the sampler
(gp/sampler.py::random_uniform_sample, the counterpart of como_tpu's
Gumbel-top-k) and the mapping paths that call it.  The draws are not JAX's
(another PRNG); the properties and the distribution are held."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from como_tpu.gp.sampler import random_uniform_sample as jrandom
from como_tpu_torch.config import ComoConfig
from como_tpu_torch.data.synthetic import SyntheticDataset
from como_tpu_torch.gp.sampler import random_uniform_sample
from como_tpu_torch.odom import mapping as tmap
from como_tpu_torch.runtime.seq import ComoSeq
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

IMG = (48, 64)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_indices_valid_distinct_and_seeded():
    valid = torch.arange(100) % 2 == 0                      # 50 valid sites
    idx, ok = random_uniform_sample(_gen(0), valid, 16)
    assert idx.dtype == torch.int64 and idx.shape == ok.shape == (16,)
    assert bool(ok.all()) and len(set(idx.tolist())) == 16
    assert bool((idx % 2 == 0).all())
    idx2, _ = random_uniform_sample(_gen(0), valid, 16)
    idx3, _ = random_uniform_sample(_gen(1), valid, 16)
    assert torch.equal(idx, idx2) and not torch.equal(idx, idx3)
    idx4, _ = random_uniform_sample(None, valid, 16)        # None: seed 0
    assert torch.equal(idx, idx4)
    # the JAX sampler has the same properties on the same mask
    jidx, jok = jrandom(jax.random.PRNGKey(0), jnp.asarray(valid.numpy()), 16)
    assert bool(jok.all()) and len(set(np.asarray(jidx).tolist())) == 16


def test_more_slots_than_sites():
    valid = torch.zeros(40, dtype=torch.bool)
    valid[[3, 17, 30]] = True
    idx, ok = random_uniform_sample(_gen(5), valid, 8)
    assert ok.tolist() == [True] * 3 + [False] * 5          # valid sites first
    assert sorted(idx[:3].tolist()) == [3, 17, 30]
    jidx, jok = jrandom(jax.random.PRNGKey(5), jnp.asarray(valid.numpy()), 8)
    assert np.asarray(jok).tolist() == ok.tolist()
    assert sorted(np.asarray(jidx)[:3].tolist()) == [3, 17, 30]
    none, ok0 = random_uniform_sample(_gen(5), torch.zeros(10, dtype=torch.bool), 4)
    assert not bool(ok0.any()) and none.shape == (4,)


def test_site_frequencies_are_uniform():
    """2,000 draws of 4 from 20 valid sites (of 30): each valid site is
    drawn with probability 1/5.  Chi-square over the 20 sites, 19 degrees
    of freedom: below 43.8 (p = 0.001); invalid sites are never drawn."""
    valid = torch.ones(30, dtype=torch.bool)
    valid[::3] = False
    g = _gen(123)
    counts = np.zeros(30)
    n = 2000
    for _ in range(n):
        idx, ok = random_uniform_sample(g, valid, 4)
        assert bool(ok.all())
        counts[idx.numpy()] += 1
    assert counts[~valid.numpy()].sum() == 0
    obs = counts[valid.numpy()]
    exp = n * 4 / 20
    # sampling without replacement shrinks the variance of a site's count by
    # (1 - 1/5); the plain statistic is then conservative
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    assert chi2 < 43.8, chi2
    assert obs.min() > 0.8 * exp and obs.max() < 1.2 * exp


def test_sample_initial_anchors_random():
    cov = torch.full((3,) + IMG, 0.1)
    cov[2] = 0.0
    rc = tmap.sample_initial_anchors(cov, 1.0, 16, 4, 0.1, 1e-2, 0.0,
                                     mode="random_uniform", generator=_gen(0))
    assert rc.shape == (16, 2) and len({tuple(r) for r in rc.tolist()}) == 16
    assert bool(((rc[:, 0] >= 4) & (rc[:, 0] < IMG[0] - 4)
                 & (rc[:, 1] >= 4) & (rc[:, 1] < IMG[1] - 4)).all())
    again = tmap.sample_initial_anchors(cov, 1.0, 16, 4, 0.1, 1e-2, 0.0,
                                        mode="random_uniform", generator=_gen(0))
    assert torch.equal(rc, again)


def test_engine_bootstraps_with_random_uniform():
    """Mapping with sampling.mode random_uniform bootstraps at 48x64, takes
    insertions through track_and_init's random path and stays finite."""
    cfg = ComoConfig()
    cfg.img_size = list(IMG)
    cfg.mapping.graph.num_keyframes = 4
    cfg.mapping.graph.num_one_way_frames = 4
    cfg.mapping.sampling.max_num_coords = 16
    cfg.mapping.sampling.border = 2
    cfg.mapping.sampling.mode = "random_uniform"
    cfg.mapping.init.max_iter = 30
    cfg.tracking.term_criteria.max_iter = 30
    ds = SyntheticDataset(n_frames=25, img_size=IMG, seed=0, step=0.012, device="cpu")
    eng = ComoSeq(cfg.validate(), ds.intrinsics, IMG, device="cpu")
    eng.setup()
    ts, poses = eng.run(ds)
    m = eng.mapping
    assert m.is_init and m.num_kf >= 3 and len(ts) >= 15
    assert np.all(np.isfinite(poses))
    st = m.state
    assert bool(torch.isfinite(st.P_lm[st.lm_valid]).all())
    pm = st.pm[:m.num_kf]
    assert bool(((pm[..., 0] >= 0) & (pm[..., 0] <= IMG[1] - 1)
                 & (pm[..., 1] >= 0) & (pm[..., 1] <= IMG[0] - 1)).all())
    # same seeds, same run
    eng2 = ComoSeq(cfg, ds.intrinsics, IMG, device="cpu")
    eng2.setup()
    _, poses2 = eng2.run(ds)
    np.testing.assert_array_equal(poses2, poses)
