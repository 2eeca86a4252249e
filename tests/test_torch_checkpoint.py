"""Mapping-state snapshots cross between the packages: a snapshot written
by como_tpu_torch loads in como_tpu and the reverse, field by field, with
the host bookkeeping, and the port's GN step on a reloaded state is the
step on the original (48x64 plane window, CPU)."""

import inspect

import numpy as np
import pytest
import torch

from como_tpu.config import ComoConfig as JConfig
from como_tpu.odom.mapping import Mapping as JMapping
from como_tpu.utils import checkpoint as jckpt
from como_tpu_torch.config import ComoConfig as TConfig
from como_tpu_torch.data.synthetic import SyntheticDataset
from como_tpu_torch.odom.backend.gn_step import _gn_step_impl
from como_tpu_torch.odom.mapping import Mapping as TMapping
from como_tpu_torch.runtime.seq import ComoSeq
from como_tpu_torch.utils import checkpoint as tckpt
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

IMG = (48, 64)
BOOK = ("kf_ts", "ow_ts", "num_kf", "num_ow", "is_init")


def small_config(cls):
    cfg = cls()
    cfg.img_size = list(IMG)
    cfg.mapping.graph.num_keyframes = 4
    cfg.mapping.graph.num_one_way_frames = 4
    cfg.mapping.sampling.max_num_coords = 16
    cfg.mapping.sampling.border = 2
    cfg.mapping.init.max_iter = 30
    cfg.mapping.warm_start = False
    cfg.tracking.term_criteria.max_iter = 30
    return cfg.validate()


@pytest.fixture(scope="module")
def window(tmp_path_factory):
    """A port mapping after 20 plane frames (keyframes and one-way frames
    in the window), and its snapshot."""
    ds = SyntheticDataset(n_frames=20, img_size=IMG, seed=0, step=0.012, device="cpu")
    eng = ComoSeq(small_config(TConfig), ds.intrinsics, IMG, device="cpu")
    eng.setup()
    eng.run(ds)
    m = eng.mapping
    assert m.is_init and m.num_kf >= 2 and m.num_ow >= 1
    path = str(tmp_path_factory.mktemp("ckpt") / "port.state")
    tckpt.save_mapping_state(m, path)
    return dict(m=m, K=ds.intrinsics.numpy(), path=path)


def _fresh_port(K):
    m = TMapping(small_config(TConfig).mapping, K, IMG, device="cpu")
    m.setup()
    return m


def _same_bookkeeping(a, b):
    for k in BOOK:
        assert getattr(a, k) == getattr(b, k), k
    np.testing.assert_array_equal(np.asarray(a.anchor_lm_host), np.asarray(b.anchor_lm_host))
    np.testing.assert_array_equal(a.alloc.valid, b.alloc.valid)
    assert list(a.alloc.free) == list(b.alloc.free)


def test_port_snapshot_loads_in_jax_and_back(window, tmp_path):
    m = window["m"]
    jm = JMapping(small_config(JConfig).mapping, window["K"], IMG)
    jm.setup()
    jckpt.load_mapping_state(jm, window["path"])
    _same_bookkeeping(jm, m)
    jfields = jm.state._asdict()
    assert sorted(jfields) == sorted(m.state.fields())
    for name in m.state.fields():
        want = getattr(m.state, name).numpy()
        got = np.asarray(jfields[name])
        assert got.shape == want.shape, name
        assert got.dtype == (np.int32 if want.dtype == np.int64 else want.dtype), name
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)
    for a, b in zip(jm._pairs, m._pairs):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    # and back: the JAX package writes, the port reads
    back = str(tmp_path / "jax.state")
    jckpt.save_mapping_state(jm, back)
    m2 = _fresh_port(window["K"])
    assert not m2.is_init
    tckpt.load_mapping_state(m2, back, device="cpu")
    _same_bookkeeping(m2, m)
    for name in m.state.fields():
        a, b = getattr(m2.state, name), getattr(m.state, name)
        assert a.dtype == b.dtype and a.device.type == "cpu", name
        assert torch.equal(a, b), name
    for a, b in zip(m2._pairs, m._pairs):
        assert torch.equal(a, b)


def test_gn_step_after_reload_equals_step_before(window):
    m = window["m"]
    m2 = _fresh_port(window["K"])
    tckpt.load_mapping_state(m2, window["path"], device="cpu")
    s1, g1 = _gn_step_impl(m.state, *m._pairs, m.K, m.dims, m.sigmas, m.damping)
    s2, g2 = _gn_step_impl(m2.state, *m2._pairs, m2.K, m2.dims, m2.sigmas, m2.damping)
    for f in s1.fields():
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert float(g1.delta_norm) > 0.0
    # the reloaded mapping goes on: one more one-way frame and keyframe
    rgb = torch.rand(1, 3, *IMG, generator=torch.Generator().manual_seed(0))
    m2.add_one_way_frame(rgb, m2.state.kf_pose[m2.num_kf - 1].clone(), torch.zeros(2), 9.0)
    assert m2.ow_ts[-1] == 9.0


def test_load_rejects_other_config_and_device(window):
    cfg = small_config(TConfig)
    cfg.mapping.sampling.max_num_coords = 8
    m3 = TMapping(cfg.mapping, window["K"], IMG, device="cpu")
    m3.setup()
    with pytest.raises(ValueError, match="another config"):
        tckpt.load_mapping_state(m3, window["path"], device="cpu")
    with pytest.raises(ValueError, match="Mapping on cpu"):
        tckpt.load_mapping_state(_fresh_port(window["K"]), window["path"])
    assert inspect.signature(tckpt.load_mapping_state).parameters["device"].default == "cuda"
