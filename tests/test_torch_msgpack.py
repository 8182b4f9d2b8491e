"""The port's flax-msgpack codec (train/msgpack_codec.py) against flax's own
msgpack_serialize / msgpack_restore: the same bytes for the same tree, and
flax's tree back (dtypes included) from flax's bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from wav2vec2forbrain_tpu_torch.train import msgpack_codec as codec


def _tree(rng):
    """Nested lists in flax's state-dict encoding, an int epoch, f32 / bf16
    / int32 / uint32 / bool leaves, numpy scalars, strings, floats, None,
    and maps of more than 15 and of 16+ string sizes."""
    layers = [{"w": rng.standard_normal((3, 4)).astype(np.float32),
               "b": rng.standard_normal(4).astype(np.float32)} for _ in range(12)]
    return {
        "params": serialization.to_state_dict({"layers": layers, "nested": [[np.arange(3, dtype=np.int32)], []]}),
        "epoch": 7,
        "big_int": 2**40,
        "negative": [-1, -33, -200, -40000, -2**40],
        "unsigned": [127, 128, 255, 256, 65535, 65536, 2**32],
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((2, 5)), dtype=jnp.bfloat16)),
        "key": np.array([0, 4294967295], dtype=np.uint32),
        "mask": np.array([True, False, True]),
        "scalar_f32": np.float32(1.5),
        "scalar_i64": np.int64(-3),
        "lr": 1e-4,
        "flag": False,
        "none": None,
        "name": "x" * 40,
        "long_name": "y" * 300,
        "empty": np.zeros((0, 3), np.float32),
        "zero_d": np.array(2.5, np.float64),
        "wide_map": {f"k{i}": i for i in range(20)},
        "blob": b"\x00\x01" * 200,
    }


def _assert_same(port, ref, where="/"):
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == list(ref), where
        for k in ref:
            _assert_same(port[k], ref[k], f"{where}{k}/")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), where
        for i, (p, r) in enumerate(zip(port, ref)):
            _assert_same(p, r, f"{where}{i}/")
    elif isinstance(ref, np.ndarray):
        assert isinstance(port, torch.Tensor), where
        assert str(port.dtype).split(".")[1] == ref.dtype.name, (where, port.dtype, ref.dtype)
        assert tuple(port.shape) == ref.shape, where
        assert port.reshape(-1).view(torch.uint8).numpy().tobytes() == ref.tobytes(), where
    elif isinstance(ref, np.generic):
        assert type(port) is type(ref) and port == ref, where
    else:
        assert type(port) is type(ref) and port == ref, (where, port, ref)


def test_writer_gives_flax_bytes():
    tree = _tree(np.random.default_rng(0))
    assert codec.msgpack_serialize(tree) == serialization.msgpack_serialize(tree)


def test_writer_takes_tensors_as_flax_takes_arrays():
    """Torch leaves (bf16 too) are written as flax writes the same values."""
    rng = np.random.default_rng(1)
    f32 = rng.standard_normal((4, 3)).astype(np.float32)
    bf16 = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32)).to(torch.bfloat16)
    ours = {"a": torch.from_numpy(f32), "b": bf16, "c": torch.arange(5, dtype=torch.int32).reshape(5, 1).t()}
    ref = {"a": f32, "b": np.asarray(jnp.asarray(bf16.float().numpy(), dtype=jnp.bfloat16)),
           "c": np.arange(5, dtype=np.int32).reshape(1, 5)}
    assert codec.msgpack_serialize(ours) == serialization.msgpack_serialize(ref)


def test_reader_returns_flax_tree():
    tree = _tree(np.random.default_rng(2))
    data = serialization.msgpack_serialize(tree)
    _assert_same(codec.msgpack_restore(data), serialization.msgpack_restore(data))


def test_chunked_leaves_both_ways(monkeypatch):
    """flax's chunked form of large arrays, at a 64-byte chunk size on both
    sides: a leaf under maps is chunked and read back whole; one in a list
    is not chunked (flax walks maps only)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(3)
    big = rng.standard_normal((7, 9)).astype(np.float32)  # 252 bytes: 4 chunks of 16 floats
    tree = {"params": {"w": big, "small": np.ones(3, np.float32)}, "in_list": [big], "epoch": 2}
    data = serialization.msgpack_serialize(tree)
    assert codec.msgpack_serialize(tree) == data
    assert b"__msgpack_chunked_array__" in data
    got = codec.msgpack_restore(data)
    np.testing.assert_array_equal(got["params"]["w"].numpy(), big)
    np.testing.assert_array_equal(got["in_list"][0].numpy(), big)
    # a leaf flax's own _chunk split, read back by the port
    chunked = serialization.msgpack_serialize({"leaf": serialization._chunk(big)})
    np.testing.assert_array_equal(codec.msgpack_restore(chunked)["leaf"].numpy(), big)


def test_state_dict_lists_round_trip(tmp_path):
    """to_state_dict / relistify: flax's list encoding and the JAX package's
    _relistify; write_msgpack / read_msgpack through a file."""
    from wav2vec2forbrain_tpu.models.pretrained import _relistify

    rng = np.random.default_rng(4)
    tree = {"layers": [{"w": torch.from_numpy(rng.standard_normal(2).astype(np.float32))} for _ in range(11)],
            "gru": {"directions": [[torch.zeros(1)], [torch.ones(1)]]}, "state": {}}
    ours = codec.to_state_dict(tree)
    assert list(ours["layers"]) == [str(i) for i in range(11)]
    ref = serialization.to_state_dict(tree)
    assert codec.msgpack_serialize(ours) == serialization.msgpack_serialize(
        serialization.to_state_dict({"layers": [{"w": t["w"].numpy()} for t in tree["layers"]],
                                     "gru": {"directions": [[np.zeros(1, np.float32)], [np.ones(1, np.float32)]]},
                                     "state": {}}))
    path = str(tmp_path / "tree.msgpack")
    codec.write_msgpack(path, ours)
    back = codec.relistify(codec.read_msgpack(path))
    jax_back = _relistify(serialization.msgpack_restore(open(path, "rb").read()))
    _assert_same(back, jax_back)
    assert isinstance(back["layers"], list) and len(back["layers"]) == 11
    for a, b in zip(back["layers"], tree["layers"]):
        assert torch.equal(a["w"], b["w"])
    assert back["state"] == {} and set(ref) == set(ours)


def test_reader_refuses_what_it_cannot_represent():
    with pytest.raises(ValueError, match="truncated"):
        codec.msgpack_restore(serialization.msgpack_serialize({"w": np.ones(4, np.float32)})[:-3])
    with pytest.raises(ValueError, match="bytes after"):
        codec.msgpack_restore(serialization.msgpack_serialize({}) + b"\xc0")
    with pytest.raises(TypeError, match="cannot serialize"):
        codec.msgpack_serialize({"t": (1, 2)})
