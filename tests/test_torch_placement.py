"""Stage placement of the port (runtime/placement.py) and the ComoSeq
options that change how a frame is dispatched: split stage devices (the
unfused step, here on one CPU) and resolve_stride 2 against the JAX engine.
48x64, 4 KF / 4 OW / 16 anchors, device="cpu"."""

import inspect
import logging

import numpy as np
import pytest
import torch

from como_tpu_torch.config import ComoConfig as TConfig
from como_tpu_torch.runtime import pipeline, placement, seq
import torch_runtime_cases as cases
from torch_runtime_cases import IMG, plane_frames, small_config


@pytest.mark.parametrize("spec,idx", [("tpu:1", 1), ("cuda:1", 1), ("gpu:1", 1), ("cuda", 0),
                                      ("tpu:0", 0), ("cpu:3", 3), ("", 0), ("default", 0),
                                      (None, 0)])
def test_spec_index(spec, idx):
    """The platform word is ignored; only the index counts."""
    assert placement.spec_index(spec) == idx
    assert placement.resolve_device(spec, "cpu") == torch.device("cpu")


def test_spec_rejects_unknown_platform():
    with pytest.raises(ValueError, match="unknown platform"):
        placement.spec_index("npu:0")
    with pytest.raises(ValueError):
        placement.spec_index("cuda:-1")


def test_stage_devices_on_the_cpu_and_same_index_is_fused():
    a, b = placement.resolve_stage_devices("cuda:0", "cuda:1", "cpu")
    assert a == b == torch.device("cpu")
    K = np.eye(3, dtype=np.float32)
    assert not seq.ComoSeq(small_config(TConfig), K, IMG, device="cpu").split_devices
    cfg = small_config(TConfig)
    cfg.tracking.device, cfg.mapping.device = "gpu:1", "cuda:1"
    assert not seq.ComoSeq(cfg, K, IMG, device="cpu").split_devices     # same index
    cfg.mapping.device = "cuda:0"
    eng = seq.ComoSeq(cfg, K, IMG, device="cpu")
    assert eng.split_devices and eng.track_dev == eng.map_dev == torch.device("cpu")


def test_cuda_engine_never_resolves_to_the_cpu(caplog):
    """Without a CUDA device a cuda engine raises.  By source: the only
    place resolve_device makes a CPU device is under `base.type == "cpu"`;
    an out-of-range index goes to cuda:0 with a warning."""
    src = inspect.getsource(placement.resolve_device)
    assert src.count('torch.device("cpu")') == 1
    assert src.index('if base.type == "cpu":') < src.index('torch.device("cpu")') \
        < src.index('if base.type != "cuda"')
    assert 'return torch.device("cuda", idx)' in src and "log.warning" in src
    for fn in (placement.resolve_device, placement.resolve_stage_devices,
               seq.ComoSeq.__init__, pipeline.ComoPipeline.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            placement.resolve_device("cuda:0")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            seq.ComoSeq(small_config(TConfig), np.eye(3, dtype=np.float32), IMG)
    else:
        with caplog.at_level(logging.WARNING):
            assert placement.resolve_device("cuda:99") == torch.device("cuda", 0)
        assert "out of range" in caplog.text
    for bad in ("meta", "cuda:1"):           # the type only; the specs give the index
        with pytest.raises(ValueError, match="unsupported"):
            placement.resolve_device("cuda:0", bad)


def test_tree_device_put_on_a_mixed_tuple():
    t = torch.arange(3.0)
    arr = np.ones(2)
    msg = ("keyframe", t, [0.1, 0.2], [t[:2], 3], arr, None, 1.5)
    out = placement.tree_device_put(msg, torch.device("cpu"))
    assert isinstance(out, tuple) and len(out) == len(msg)
    assert out[0] == "keyframe" and out[2] == [0.1, 0.2] and out[5] is None and out[6] == 1.5
    assert out[1] is t                       # already there: no copy
    assert out[3][1] == 3 and torch.equal(out[3][0], t[:2])
    assert out[4] is arr                     # host arrays pass through
    moved = placement.tree_device_put((t, "x"), torch.device("meta"))
    assert moved[0].device.type == "meta" and moved[1] == "x"
    with placement.device_scope(torch.device("cpu")):      # a no-op on the CPU
        pass


# --- the unfused (split) step on one device ------------------------------------------

@pytest.fixture(scope="module")
def split_runs():
    frames, K, _ = plane_frames(25, 0.02)
    fused = cases.torch_run(frames, K)

    def split_cfg(**top):
        cfg = small_config(TConfig, **top)
        cfg.tracking.device, cfg.mapping.device = "cuda:0", "cuda:1"
        return cfg

    out = dict(fused=fused)
    for name, top in (("split", {}), ("split_batch", dict(dispatch_depth=2, frame_batch=2))):
        te = seq.ComoSeq(split_cfg(**top), K, IMG, device="cpu")
        te.setup()
        ts, est = te.run(frames)
        out[name] = (te, ts, est)
    out["depth2"] = cases.torch_run(frames, K, dispatch_depth=2)
    return out


def test_unfused_path_equals_the_fused_one_bitwise(split_runs):
    """Tracking.dispatch_frame then Mapping.maybe_iterate run the ops of
    fused_frame in the same order: the same trajectory, bit for bit, the
    same insertions and GN iterations."""
    (fe, fts, fest), (se, sts, sest) = split_runs["fused"], split_runs["split"]
    assert se.split_devices and not fe.split_devices
    np.testing.assert_array_equal(sts, fts)
    np.testing.assert_array_equal(sest, fest)
    assert cases.inserts(se) == cases.inserts(fe) and len(cases.inserts(se)) >= 2
    assert se.mapping.total_iters == fe.mapping.total_iters > 0
    for f in fe.mapping.state.fields():
        assert torch.equal(getattr(se.mapping.state, f), getattr(fe.mapping.state, f)), f


def test_split_devices_take_frames_one_by_one(split_runs):
    """With split stages frame_batch 2 is not used (as in the JAX engine):
    the run is the unbatched one at the same dispatch depth."""
    (se, sts, sest), (de, dts, dest) = split_runs["split_batch"], split_runs["depth2"]
    assert se.frame_batch == 2 and se._stash is None
    np.testing.assert_array_equal(sts, dts)
    np.testing.assert_array_equal(sest, dest)


# --- resolve_stride 2 against the JAX engine ----------------------------------------------

@pytest.fixture(scope="module")
def strided_runs():
    return cases.option_runs("resolve_stride")


@pytest.mark.parametrize("check", cases.OPTION_CHECKS, ids=lambda f: f.__name__)
def test_resolve_stride_2(strided_runs, check):
    check(strided_runs)
