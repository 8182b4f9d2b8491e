"""Checkpoints across the two packages, on CPU (tiny encoders, biGRU 2 x
32, the trainer tests' fixture splits):

- the port's --from_checkpoint=model.msgpack and
  --brain_encoder_path=brain_encoder.msgpack, written by
  wav2vec2forbrain_tpu.train.checkpoint from a per-layer and a
  scan-stacked JAX experiment, give the params bridge.params_from_jax
  gives;
- `python -m wav2vec2forbrain_tpu_torch.convert to-msgpack` writes the
  bytes the JAX package writes for the same trees, which its
  load_checkpoint reads; `to-pt` brings them back bitwise;
- the `hf`, `brain` and `model` commands write the bytes of
  tools/convert_checkpoint.py (and of the JAX loader for `hf`).
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import wav2vec2forbrain_tpu.experiments.impl as jax_impl
from wav2vec2forbrain_tpu.args.yaml_config import YamlConfigModel as JaxYaml
from wav2vec2forbrain_tpu.models import pretrained as jax_pretrained
from wav2vec2forbrain_tpu.train import checkpoint as jax_checkpoint
from wav2vec2forbrain_tpu_torch import bridge, convert
from wav2vec2forbrain_tpu_torch.train import checkpoint
from wav2vec2forbrain_tpu_torch.tree import tree_leaves_with_path

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_convert import hf_model, reference_state_dict  # noqa: E402
from test_torch_pretrained import write_snapshot  # noqa: E402
from test_torch_pretrained_cli import CHECKPOINTS, LAYOUTS, env, fields, port_experiment  # noqa: E402,F401
from test_torch_trainer import config  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location("convert_checkpoint", os.path.join(REPO, "tools",
                                                                                    "convert_checkpoint.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _leaves(tree):
    return dict(tree_leaves_with_path(tree))


def assert_same_tensors(a, b):
    a, b = _leaves(a), _leaves(b)
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for path in a:
        assert a[path].dtype == b[path].dtype and torch.equal(a[path], b[path]), path


def jax_experiment(env, family, **overrides):
    cls = jax_impl.B2TGruAndW2VConformerExperiment if family == "conformer" else jax_impl.B2TGruAndW2VExperiment
    return cls(config(family, **overrides), JaxYaml(**fields(env, "jax_ckpt")))


def _host(tree):
    return jax.device_get(jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree))


@pytest.mark.parametrize("family", ["conformer", "w2v"])
@pytest.mark.parametrize("stacked", [False, True])
def test_from_checkpoint_reads_jax_msgpack(env, tmp_path, family, stacked):
    jexp = jax_experiment(env, family, scan_layers=stacked, results_subdir_name="jax", seed=7)
    params, state = _host((jexp._merged_params(), jexp.model_state))
    assert ("layers_stacked" in params["w2v"]["encoder"]) == stacked
    path = str(tmp_path / "model.msgpack")
    jax_checkpoint.save_checkpoint(path, params, state)
    want_params, want_state = bridge.params_from_jax(params, state, device="cpu")
    exp = port_experiment(env, "port_ckpt", family, from_checkpoint=path, results_subdir_name="from_msgpack")
    assert_same_tensors(exp.params, want_params)
    assert_same_tensors(exp.model_state, want_state)


@pytest.mark.parametrize("stacked", [False, True])
def test_brain_encoder_path_reads_jax_msgpack(env, tmp_path, stacked):
    jexp = jax_experiment(env, "w2v", scan_layers=stacked, results_subdir_name="jax", seed=9)
    params, state = _host((jexp._merged_params(), jexp.model_state))
    path = str(tmp_path / "brain_encoder.msgpack")
    jax_checkpoint.save_subtree(path, params["brain"])
    want = bridge.params_from_jax(params, state, device="cpu")[0]["brain"]
    fresh = port_experiment(env, "port_ckpt", "w2v", results_subdir_name="fresh")
    exp = port_experiment(env, "port_ckpt", "w2v", brain_encoder_path=path, results_subdir_name="brain_msgpack")
    assert_same_tensors(exp.params["brain"], want)
    assert_same_tensors(exp.params["w2v"], fresh.params["w2v"])


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_to_msgpack_and_to_pt_round_trip(env, tmp_path, family):
    exp = port_experiment(env, "port_ckpt", family, results_subdir_name="store", seed=3)
    pt, msgpack, back = (str(tmp_path / n) for n in ("model.pt", "model.msgpack", "back.pt"))
    checkpoint.save_checkpoint(pt, exp.params, exp.model_state)
    convert.main(["to-msgpack", pt, msgpack])
    jparams, jstate = bridge.params_to_jax(exp.params, exp.model_state)
    ref = str(tmp_path / "jax.msgpack")
    jax_checkpoint.save_checkpoint(ref, jparams, jstate)
    with open(msgpack, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    # the JAX package reads it against its own template
    got_params, got_state = jax_checkpoint.load_checkpoint(msgpack, template=serialization.to_state_dict(jparams))
    for x, y in zip(jax.tree_util.tree_leaves(got_params), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(x), y)
    convert.main(["to-pt", msgpack, back])
    params, state = checkpoint.load_checkpoint(back)
    assert_same_tensors(params, checkpoint.to_cpu(exp.params))
    assert_same_tensors(state, checkpoint.to_cpu(exp.model_state))
    # the brain-encoder subtree both ways
    checkpoint.save_subtree(str(tmp_path / "brain_encoder.pt"), exp.params["brain"])
    convert.main(["to-msgpack", str(tmp_path / "brain_encoder.pt"), str(tmp_path / "brain_encoder.msgpack")])
    jax_checkpoint.save_subtree(str(tmp_path / "jax_brain.msgpack"), jparams["brain"])
    with open(tmp_path / "brain_encoder.msgpack", "rb") as a, open(tmp_path / "jax_brain.msgpack", "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(SystemExit):
        convert.main(["to-pt", pt, str(tmp_path / "same.pt")])


def test_a_stacked_msgpack_comes_out_per_layer(env, tmp_path):
    jexp = jax_experiment(env, "conformer", scan_layers=True, results_subdir_name="jax", seed=11)
    params, state = _host((jexp._merged_params(), jexp.model_state))
    jax_checkpoint.save_checkpoint(str(tmp_path / "stacked.msgpack"), params, state)
    convert.main(["to-pt", str(tmp_path / "stacked.msgpack"), str(tmp_path / "model.pt")])
    got_params, got_state = checkpoint.load_checkpoint(str(tmp_path / "model.pt"))
    want_params, want_state = bridge.params_from_jax(params, state, device="cpu")
    assert isinstance(got_params["w2v"]["encoder"]["layers"], list)
    assert_same_tensors(got_params, want_params)
    assert_same_tensors(got_state, want_state)


def test_reference_checkpoint_commands_write_the_tools_bytes(tmp_path):
    """`brain` and `model` on the original reference's .pt files, against
    tools/convert_checkpoint.py, both to .msgpack; and their .pt outputs."""
    tool = _tool()
    brain_pt = str(tmp_path / "ref_brain_encoder.pt")
    torch.save(reference_state_dict(), brain_pt)
    tool.convert_brain(brain_pt, str(tmp_path / "jax_brain.msgpack"))
    convert.main(["brain", brain_pt, str(tmp_path / "brain.msgpack")])
    with open(tmp_path / "brain.msgpack", "rb") as a, open(tmp_path / "jax_brain.msgpack", "rb") as b:
        assert a.read() == b.read()

    sd = {f"brain_encoder.{k}": v for k, v in reference_state_dict().items()}
    sd.update({f"w2v_encoder.{k}": v for k, v in hf_model("conformer").state_dict().items()})
    model_pt = str(tmp_path / "ref_model.pt")
    torch.save(sd, model_pt)
    tool.convert_model(model_pt, str(tmp_path / "jax_model.msgpack"), "conformer", 2)
    convert.main(["model", model_pt, str(tmp_path / "model.msgpack"), "--family", "conformer", "--layers", "2"])
    convert.main(["model", model_pt, str(tmp_path / "model.pt"), "--family", "conformer", "--layers", "2"])
    with open(tmp_path / "model.msgpack", "rb") as a, open(tmp_path / "jax_model.msgpack", "rb") as b:
        assert a.read() == b.read()
    assert_same_tensors(checkpoint.load_bundle(str(tmp_path / "model.pt")),
                        checkpoint.load_bundle(str(tmp_path / "model.msgpack")))


def test_hf_command_writes_the_jax_loaders_bundle(env, tmp_path):
    """`hf` (with the trees' tiny configs) against the JAX loader's trees
    saved by the JAX checkpoint writer, as tools/convert_checkpoint.py
    saves them."""
    cache = fields(env, "hf_cmd")["cache_dir"]
    write_snapshot(cache, CHECKPOINTS["conformer"], hf_model("conformer"), LAYOUTS["conformer"])
    convert.main(["hf", CHECKPOINTS["conformer"], str(tmp_path / "enc.msgpack"), "--cache_dir", cache])
    enc, head, state = jax_pretrained.load_pretrained_encoder(CHECKPOINTS["conformer"], cache)
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax_enc.msgpack"), {"encoder": enc, "lm_head": head}, state)
    with open(tmp_path / "enc.msgpack", "rb") as a, open(tmp_path / "jax_enc.msgpack", "rb") as b:
        assert a.read() == b.read()
