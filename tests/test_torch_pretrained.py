"""Pretrained HF encoders on the port: the offline snapshot reader
(models/hf_snapshot.py) and load_pretrained_encoder with its converted
cache (models/pretrained.py), against transformers and the JAX package's
loader on hand-built hub caches of tiny models (HF_HUB_OFFLINE=1, set by
tests/conftest.py).

The cache layout is transformers': <cache_dir>/models--{org}--{name}/
refs/main -> snapshots/<revision>/ with config.json and the weights as
model.safetensors, a sharded model.safetensors.index.json,
pytorch_model.bin or a sharded pytorch_model.bin.index.json, under the
pos-conv spelling of the hub's files (weight_g / weight_v) or of
transformers 4.57's save_pretrained (parametrizations.weight.original0/1).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu.models import pretrained as jax_pretrained
from wav2vec2forbrain_tpu.models.conformer import ConformerEncoderConfig as JaxConformerConfig
from wav2vec2forbrain_tpu.models.wav2vec2 import Wav2Vec2EncoderConfig as JaxW2VConfig
from wav2vec2forbrain_tpu_torch.models import hf_snapshot, pretrained
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_convert import assert_trees_equal, hf_model, legacy_spelling  # noqa: E402

torch.set_num_threads(2)
W2V_CKPT = "facebook/wav2vec2-base-960h"
CONF_CKPT = "facebook/wav2vec2-conformer-rope-large-960h-ft"
LAYOUTS = ("model.safetensors", "model.safetensors.index.json", "pytorch_model.bin", "pytorch_model.bin.index.json")


def write_snapshot(cache_dir, checkpoint, model, layout, spelling="weight_g", revision="0123abcd"):
    """An HF hub-cache snapshot of `model` in one of the four weight layouts;
    the shards split the keys in three."""
    from safetensors.torch import save_file

    repo = os.path.join(cache_dir, "models--" + checkpoint.replace("/", "--"))
    snap = os.path.join(repo, "snapshots", revision)
    os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(revision)
    model.config.save_pretrained(snap)
    sd = {k: v.detach().clone().contiguous() for k, v in model.state_dict().items()}
    if spelling == "weight_g":
        sd = legacy_spelling(sd)
    safe = layout.startswith("model.safetensors")

    def save(tensors, name):
        if safe:
            save_file(tensors, os.path.join(snap, name), metadata={"format": "pt"})
        else:
            torch.save(tensors, os.path.join(snap, name))

    if not layout.endswith(".index.json"):
        save(sd, layout)
        return snap
    keys = list(sd)
    stem, ext = ("model", "safetensors") if safe else ("pytorch_model", "bin")
    weight_map = {}
    for i in range(3):
        name = f"{stem}-{i + 1:05d}-of-00003.{ext}"
        part = keys[i::3]
        save({k: sd[k] for k in part}, name)
        weight_map.update({k: name for k in part})
    with open(os.path.join(snap, layout), "w") as f:
        json.dump({"metadata": {"total_size": sum(v.numel() * v.element_size() for v in sd.values())},
                   "weight_map": weight_map}, f)
    return snap


def _tiny(checkpoint, conformer_cls, w2v_cls):
    if "conformer" in checkpoint:
        return "conformer", conformer_cls.tiny_test()
    return "wav2vec2", w2v_cls.tiny_test()


@pytest.fixture
def tiny_configs(monkeypatch):
    """Both packages resolve the checkpoint names to the tiny encoders."""
    monkeypatch.setattr(jax_pretrained, "encoder_config_for_checkpoint",
                        lambda c: _tiny(c, JaxConformerConfig, JaxW2VConfig))
    monkeypatch.setattr(pretrained, "encoder_config_for_checkpoint",
                        lambda c: _tiny(c, ConformerEncoderConfig, Wav2Vec2EncoderConfig))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("spelling", ["weight_g", "parametrizations"])
def test_snapshot_reader_equals_the_model(tmp_path, layout, spelling):
    model = hf_model("wav2vec2")
    write_snapshot(str(tmp_path), W2V_CKPT, model, layout, spelling)
    got = hf_snapshot.read_state_dict(W2V_CKPT, str(tmp_path))
    want = model.state_dict()
    if spelling == "weight_g":
        want = legacy_spelling(want)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_snapshot_reader_takes_f16_bf16_f64_and_int_files(tmp_path):
    """Floating tensors come out at f32 (as from_pretrained gives them),
    integer ones unchanged; a local directory is read in place."""
    from safetensors.torch import save_file

    rng = torch.Generator().manual_seed(0)
    tensors = {"h": torch.randn(3, 4, generator=rng).half(), "b": torch.randn(5, generator=rng).bfloat16(),
               "d": torch.randn(2, 2, generator=rng).double(), "i": torch.arange(6).reshape(2, 3),
               "empty": torch.zeros(0, 4)}
    save_file(tensors, str(tmp_path / "model.safetensors"))
    got = hf_snapshot.read_state_dict(str(tmp_path))
    for k, v in tensors.items():
        want = v.float() if v.is_floating_point() else v
        assert got[k].dtype == want.dtype and torch.equal(got[k], want), k


@pytest.mark.parametrize("checkpoint,layout", [(W2V_CKPT, "pytorch_model.bin"),
                                               (CONF_CKPT, "model.safetensors"),
                                               (CONF_CKPT, "pytorch_model.bin.index.json")])
def test_load_pretrained_encoder_equals_jax(tmp_path, tiny_configs, checkpoint, layout):
    """The port's load equals the JAX package's (transformers'
    from_pretrained, then its converter) bitwise, and both write the
    converted cache in the same bytes."""
    family = "conformer" if "conformer" in checkpoint else "wav2vec2"
    jax_cache, port_cache = str(tmp_path / "jax"), str(tmp_path / "port")
    model = hf_model(family)
    for cache in (jax_cache, port_cache):
        write_snapshot(cache, checkpoint, model, layout)
    ref = jax_pretrained.load_pretrained_encoder(checkpoint, jax_cache)
    got = pretrained.load_pretrained_encoder(checkpoint, port_cache)
    for g, r in zip(got, ref):
        assert_trees_equal(g, r)
    assert set(got[2]) == {"encoder"} and (family == "wav2vec2") == (got[2]["encoder"] == {})
    paths = [pretrained.converted_cache_path(checkpoint, c) for c in (jax_cache, port_cache)]
    assert paths[0] == jax_pretrained._converted_cache_path(checkpoint, jax_cache)
    assert paths[1].endswith(os.path.join("converted_encoders", checkpoint.replace("/", "--") + ".msgpack"))
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_converted_cache_crosses_packages(tmp_path, tiny_configs, monkeypatch):
    """A cache written by either package is read by the other to the same
    tree, without touching the snapshot."""
    model = hf_model("conformer")
    write_snapshot(str(tmp_path / "a"), CONF_CKPT, model, "model.safetensors")
    write_snapshot(str(tmp_path / "b"), CONF_CKPT, model, "model.safetensors")
    jax_written = jax_pretrained.load_pretrained_encoder(CONF_CKPT, str(tmp_path / "a"))
    port_written = pretrained.load_pretrained_encoder(CONF_CKPT, str(tmp_path / "b"))

    def refuse(*args, **kwargs):
        raise AssertionError("a cached load converted the snapshot again")

    monkeypatch.setattr(pretrained, "convert_from_hf", refuse)
    monkeypatch.setattr(jax_pretrained, "_convert_from_hf", refuse)
    for g, r in zip(pretrained.load_pretrained_encoder(CONF_CKPT, str(tmp_path / "a")), jax_written):
        assert_trees_equal(g, r)
    for g, r in zip(port_written, jax_pretrained.load_pretrained_encoder(CONF_CKPT, str(tmp_path / "b"))):
        assert_trees_equal(g, r)


def test_second_load_skips_the_snapshot(tmp_path, monkeypatch):
    """tests/test_pretrained_cache.py's check for the port: the conversion
    runs once a checkpoint; distinct checkpoints get distinct files."""
    calls = []

    def fake_convert(checkpoint, cache_dir=None):
        calls.append(checkpoint)
        enc = {"layer_norm": {"scale": torch.ones(4)},
               "layers": [{"w": torch.full((2, 2), float(i))} for i in range(12)]}
        return enc, {"kernel": torch.arange(8.0).reshape(4, 2)}, {"encoder": {}}

    monkeypatch.setattr(pretrained, "convert_from_hf", fake_convert)
    first = pretrained.load_pretrained_encoder("fam/a", str(tmp_path))
    second = pretrained.load_pretrained_encoder("fam/a", str(tmp_path))
    assert calls == ["fam/a"]
    assert isinstance(second[0]["layers"], list) and len(second[0]["layers"]) == 12
    for a, b in zip(first[0]["layers"], second[0]["layers"]):
        assert torch.equal(a["w"], b["w"])
    assert torch.equal(first[1]["kernel"], second[1]["kernel"]) and second[2] == {"encoder": {}}
    pretrained.load_pretrained_encoder("fam/b", str(tmp_path))
    assert sorted(os.listdir(tmp_path / "converted_encoders")) == ["fam--a.msgpack", "fam--b.msgpack"]


def test_a_missing_checkpoint_names_where_it_looked(tmp_path, tiny_configs):
    with pytest.raises(FileNotFoundError, match=r"models--facebook--wav2vec2-base-960h[/\\]refs[/\\]main"):
        pretrained.load_pretrained_encoder(W2V_CKPT, str(tmp_path))
    assert not os.path.exists(tmp_path / "converted_encoders")
    snap = write_snapshot(str(tmp_path), W2V_CKPT, hf_model("wav2vec2"), "pytorch_model.bin")
    os.remove(os.path.join(snap, "pytorch_model.bin"))
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        pretrained.load_pretrained_encoder(W2V_CKPT, str(tmp_path))
    # a snapshot that lacks a key the encoder needs
    model = hf_model("wav2vec2")
    del model.wav2vec2.encoder.layers[1].final_layer_norm
    write_snapshot(str(tmp_path / "partial"), W2V_CKPT, model, "model.safetensors")
    with pytest.raises(KeyError, match=r"wav2vec2\.encoder\.layers\.1\.final_layer_norm\.weight"):
        pretrained.load_pretrained_encoder(W2V_CKPT, str(tmp_path / "partial"))


def test_real_checkpoint_matches_transformers(request):
    """Gated (--real-checkpoint, tests/conftest.py): the port's load of a
    real checkpoint drives its encoder to transformers' output on a fixed
    input, f32, eval mode (tests/test_real_artifacts.py's check for the
    JAX package)."""
    ckpt = request.config.getoption("--real-checkpoint")
    if not ckpt:
        pytest.skip("requires --real-checkpoint (real artifact unavailable here)")
    from transformers import Wav2Vec2ConformerForCTC, Wav2Vec2ForCTC

    from wav2vec2forbrain_tpu_torch.models.conformer import apply_conformer_encoder
    from wav2vec2forbrain_tpu_torch.models.wav2vec2 import apply_lm_head, apply_w2v_encoder

    family, cfg = pretrained.encoder_config_for_checkpoint(ckpt)
    # the default hub cache (or a local directory), as from_pretrained below
    enc, head, state = pretrained.convert_from_hf(ckpt)
    cls = Wav2Vec2ConformerForCTC if family == "conformer" else Wav2Vec2ForCTC
    torch_model = cls.from_pretrained(ckpt).eval()
    torch.manual_seed(0)
    x = torch.randn(2, 13, cfg.hidden_size)
    with torch.no_grad():
        base = torch_model.wav2vec2_conformer if family == "conformer" else torch_model.wav2vec2
        ref = base.encoder(x, return_dict=True)[0]
        ref_logits = torch_model.lm_head(ref)
        if family == "conformer":
            ours, _ = apply_conformer_encoder(enc, state["encoder"], x, cfg, train=False)
        else:
            ours = apply_w2v_encoder(enc, x, cfg, train=False)
        logits = apply_lm_head(head, ours)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=2e-4)
    np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(), atol=2e-4)
