"""The port's own reader/writer of flax's msgpack files
(como_tpu_torch/utils/flax_msgpack.py) against flax.serialization."""

import os
import struct

import jax
import msgpack
import numpy as np
import pytest
from flax import serialization

from como_tpu_torch.utils import flax_msgpack as fm
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

CKPT = os.path.join(os.path.dirname(__file__), "..", "models", "depthcov.msgpack")


def _same_tree(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(y, np.ndarray):
            assert isinstance(x, np.ndarray), path
            assert x.dtype == y.dtype and x.shape == y.shape, path
            assert x.tobytes() == y.tobytes(), path
        else:
            assert type(x) is type(y) and x == y, path


def test_reads_shipped_checkpoint_like_flax():
    with open(CKPT, "rb") as f:
        raw = f.read()
    want = serialization.msgpack_restore(raw)
    got = fm.unpackb(raw)
    _same_tree(got, want)
    assert sorted(got) == ["params"] and len(got["params"]) == 21
    assert got["params"]["base"]["conv1"]["kernel"].shape == (3, 3, 3, 16)
    assert all(a.dtype == np.float32 for a in jax.tree_util.tree_leaves(got))
    assert fm.load(CKPT)["params"]["head4"]["bias"].shape == (3,)


TREE = {
    "f": np.arange(24, dtype=np.float32).reshape(2, 3, 4) / 7,
    "nested": {"i": np.array([-3, 0, 2 ** 31 - 1], np.int32),
               "b": np.array([[True, False], [False, True]]),
               "scalar_arr": np.array(2.5, np.float32),
               "empty_arr": np.zeros((0, 3), np.float32),
               "empty": {}},
    "py_int": 7, "neg": -5, "big": 2 ** 40, "neg_big": -2 ** 40, "py_float": 0.125,
    "t": True, "n": None, "s": "text", "long" + "k" * 40: 1,
    "wide": {f"k{i}": i for i in range(20)},
}


def test_writer_roundtrip_through_flax():
    """Our bytes -> flax restore, flax bytes -> our reader, ours -> ours."""
    ours = fm.packb(TREE)
    _same_tree(serialization.msgpack_restore(ours), TREE)
    _same_tree(fm.unpackb(serialization.msgpack_serialize(TREE)), TREE)
    _same_tree(fm.unpackb(ours), TREE)
    # from_bytes against a target of the same structure, as the JAX package loads
    target = {"a": np.zeros((2, 2), np.float32), "m": np.zeros(3, bool)}
    src = {"a": np.eye(2, dtype=np.float32), "m": np.array([True, False, True])}
    back = serialization.from_bytes(target, fm.packb(src))
    np.testing.assert_array_equal(back["a"], src["a"])
    np.testing.assert_array_equal(back["m"], src["m"])


def test_save_load_file(tmp_path):
    p = str(tmp_path / "t.msgpack")
    fm.save(p, TREE)
    _same_tree(fm.load(p), TREE)


@pytest.mark.parametrize("raw", [
    b"", b"\xc1", b"\x81\xa1a", fm.packb({"a": 1}) + b"\x00",
    msgpack.packb({1: 2}), msgpack.packb({"a": msgpack.ExtType(2, b"xx")}),
    msgpack.packb({"a": msgpack.ExtType(3, b"x" * 16)}),
    msgpack.packb({"a": msgpack.ExtType(1, msgpack.packb(((2,), "float32", b"1234")))}),
    msgpack.packb({"a": msgpack.ExtType(1, msgpack.packb(((1,), "complex64", b"12345678")))}),
    msgpack.packb({"a": msgpack.ExtType(1, msgpack.packb(((1,), "bfloat16", b"12")))}),
    msgpack.packb({"a": msgpack.ExtType(1, msgpack.packb("notatriple"))}),
    msgpack.packb({"__msgpack_chunked_array__": True}),
    b"\x81\xa1a\xcb" + struct.pack(">f", 1.0),
], ids=["empty", "reserved-byte", "truncated-map", "trailing", "int-key", "ext2", "ext3",
        "short-array", "complex", "bfloat16", "not-a-triple", "chunked", "truncated-float"])
def test_reader_rejects(raw):
    with pytest.raises(ValueError):
        fm.unpackb(raw)


@pytest.mark.parametrize("obj", [{"a": object()}, {1: 2}, {"a": np.zeros(2, np.complex64)},
                                 {"a": 2 ** 70}, {"a": {3, 4}}],
                         ids=["object", "int-key", "complex", "huge-int", "set"])
def test_writer_rejects(obj):
    with pytest.raises(ValueError):
        fm.packb(obj)


@pytest.mark.parametrize("value", [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                                   2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                                   -2 ** 31, -2 ** 31 - 1, -2 ** 63])
def test_ints_take_msgpacks_shortest_form(value):
    """Integers are written as msgpack-python writes them (so an array's
    shape, and a whole checkpoint, come out byte for byte as flax's)."""
    assert fm.packb(value) == msgpack.packb(value)
    assert fm.unpackb(fm.packb(value)) == value


def test_checkpoint_written_as_flax_writes_it():
    tree = fm.load(CKPT)
    assert fm.packb(tree) == open(CKPT, "rb").read()
