"""The port's CLI with pretrained weights (--w2v_skip_loading_weights=false)
against the JAX experiment, on CPU, for both families: tiny HF encoders in
a hand-built hub cache under each package's config.yaml cache_dir, the
trainer tests' fixture splits (biGRU 2 x 32, batch 3).

- the port's params under "w2v" (and the conformer's BatchNorm state) are
  the loaded ones, bitwise equal to the JAX experiment's;
- with the JAX experiment's brain weights bridged in, the eval loss and
  the logits of one test batch equal the JAX eval step's at f32 within
  1e-4 (relative for the loss, as tests/test_torch_trainer.py; atol and
  rtol for the logits, as tests/test_torch_slice.py);
- under --unfreeze_strategy=brain_encoder an epoch of training leaves
  every "w2v" leaf bitwise as loaded and moves the brain;
- a snapshot whose shapes do not fit the model, or no snapshot, raises.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import wav2vec2forbrain_tpu.experiments.impl as jax_impl
from wav2vec2forbrain_tpu.args.base_args import PRETRAINED_LATENT_SIZES as JAX_LATENT
from wav2vec2forbrain_tpu.args.yaml_config import YamlConfigModel as JaxYaml
from wav2vec2forbrain_tpu.models import pretrained as jax_pretrained
from wav2vec2forbrain_tpu.models.conformer import ConformerEncoderConfig as JaxConformerConfig
from wav2vec2forbrain_tpu.models.wav2vec2 import Wav2Vec2EncoderConfig as JaxW2VConfig
from wav2vec2forbrain_tpu.train.train_loop import Trainer as JaxTrainer
from wav2vec2forbrain_tpu_torch import bridge
from wav2vec2forbrain_tpu_torch.args.flags import PRETRAINED_LATENT_SIZES as PORT_LATENT
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel
from wav2vec2forbrain_tpu_torch.experiments import impl
from wav2vec2forbrain_tpu_torch.models import pretrained
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig
from wav2vec2forbrain_tpu_torch.train.checkpoint import copy_into
from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer
from wav2vec2forbrain_tpu_torch.tree import tree_leaves_with_path

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_convert import hf_model  # noqa: E402
from test_torch_pretrained import write_snapshot  # noqa: E402
from test_torch_trainer import CONF_CKPT, FAMILIES, NO_DROPOUT, W2V_CKPT, config, make_splits, yaml_fields  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-4
CHECKPOINTS = {"conformer": CONF_CKPT, "w2v": W2V_CKPT}
LAYOUTS = {"conformer": "model.safetensors", "w2v": "pytorch_model.bin"}


def _tiny(checkpoint, conformer_cls, w2v_cls):
    if "conformer" in checkpoint:
        return "conformer", conformer_cls.tiny_test(conformer_conv_dropout=0.0, hidden_act="swish", **NO_DROPOUT)
    return "wav2vec2", w2v_cls.tiny_test(**NO_DROPOUT)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Fixture splits, and both packages resolving the checkpoint names to
    tiny encoders (latent 96), whose snapshots `hub` writes."""
    tmp = tmp_path_factory.mktemp("pretrained_cli")
    make_splits(str(tmp / "t12"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_impl, "encoder_config_for_checkpoint", lambda c: _tiny(c, JaxConformerConfig, JaxW2VConfig))
        mp.setattr(jax_pretrained, "encoder_config_for_checkpoint",
                   lambda c: _tiny(c, JaxConformerConfig, JaxW2VConfig))
        mp.setattr(pretrained, "encoder_config_for_checkpoint",
                   lambda c: _tiny(c, ConformerEncoderConfig, Wav2Vec2EncoderConfig))
        for table in (JAX_LATENT, PORT_LATENT):
            mp.setitem(table, W2V_CKPT, 96)
            mp.setitem(table, CONF_CKPT, 96)
        yield tmp


def fields(env, name):
    """config.yaml fields with a cache_dir of its own."""
    return dict(yaml_fields(env), cache_dir=str(env / name))


def hub(env, name, family, model=None):
    """A cache_dir holding the family's tiny HF snapshot; the HF model."""
    model = model if model is not None else hf_model("conformer" if family == "conformer" else "wav2vec2", seed=3)
    write_snapshot(fields(env, name)["cache_dir"], CHECKPOINTS[family], model, LAYOUTS[family])
    return model


def port_experiment(env, name, family, **overrides):
    cls = impl.B2TGruAndW2VConformerExperiment if family == "conformer" else impl.B2TGruAndW2VExperiment
    return cls(config(family, **overrides), YamlConfigModel(**fields(env, name)), device="cpu")


def _leaves(tree):
    return dict(tree_leaves_with_path(tree))


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_pretrained_weights_give_the_jax_eval(env, family):
    model = hub(env, f"jax_{family}", family)
    hub(env, f"port_{family}", family, model)
    flags = dict(w2v_skip_loading_weights=False, compute_dtype="float32")
    jcls = jax_impl.B2TGruAndW2VConformerExperiment if family == "conformer" else jax_impl.B2TGruAndW2VExperiment
    jexp = jcls(config(family, results_subdir_name="jax", **flags), JaxYaml(**fields(env, f"jax_{family}")))
    jparams, jstate = bridge.params_from_jax(
        *jax.device_get(jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                               (jexp._merged_params(), jexp.model_state))), device="cpu")
    exp = port_experiment(env, f"port_{family}", family, results_subdir_name="port", **flags)

    # the loaded encoder, head and BN state, bitwise the JAX experiment's
    cache_dir = fields(env, f"port_{family}")["cache_dir"]
    enc, head, state = pretrained.load_pretrained_encoder(CHECKPOINTS[family], cache_dir)
    for ours, loaded in ((exp.params["w2v"], {"encoder": enc, "lm_head": head}), (exp.model_state, state)):
        ours, loaded = _leaves(ours), _leaves(loaded)
        assert set(ours) == set(loaded) and all(torch.equal(ours[p], loaded[p]) for p in loaded)
    for path, leaf in _leaves(jparams["w2v"]).items():
        assert torch.equal(_leaves(exp.params["w2v"])[path], leaf), path
    for path, leaf in _leaves(jstate).items():
        assert torch.equal(_leaves(exp.model_state)[path], leaf), path
    assert (family == "conformer") == bool(_leaves(exp.model_state))
    w = "wav2vec2_conformer" if family == "conformer" else "wav2vec2"
    assert torch.equal(exp.params["w2v"]["lm_head"]["kernel"], model.lm_head.weight.detach().t())
    assert torch.equal(exp.params["w2v"]["encoder"]["layers"][1]["final_layer_norm"]["scale"],
                       getattr(model, w).encoder.layers[1].final_layer_norm.weight.detach())

    # the same brain weights: one test batch through both eval steps
    copy_into(exp.params["brain"], jparams["brain"])
    jtrainer, trainer = JaxTrainer(jexp), Trainer(exp)
    jhost, host = next(iter(jexp.dataloader_test)), next(iter(exp.dataloader_test))
    np.testing.assert_array_equal(np.asarray(jhost.input), np.asarray(host.input))
    jbatch, _ = jtrainer._put(jhost)
    ref = jax.device_get(jtrainer.eval_step(jtrainer.trainable, jtrainer.frozen, jtrainer.model_state, jbatch))
    batch, _ = trainer._put(host, "test")
    got = trainer.eval_step(trainer.params, trainer.model_state, batch)
    assert abs(float(got[0]) - float(ref[0])) <= TOL * abs(float(ref[0])), (float(got[0]), float(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_frozen_pretrained_encoder_stays_as_loaded(env, family):
    """--unfreeze_strategy=brain_encoder (the frozen sweep): a training run
    leaves the loaded w2v leaves bitwise unchanged and moves the brain."""
    hub(env, f"frozen_{family}", family)
    frozen = dict(unfreeze_strategy="brain_encoder", w2v_learning_rate=None, w2v_warmup_start_step=None,
                  w2v_warmup_steps=None, epochs=1, early_stopping_patience=None, return_best_model=False)
    exp = port_experiment(env, f"frozen_{family}", family, w2v_skip_loading_weights=False,
                          results_subdir_name="frozen", **frozen)
    loaded = {k: v.clone() for k, v in _leaves(exp.params).items()}
    exp.run()
    after = _leaves(exp.params)
    w2v = [p for p in loaded if p.startswith("/w2v/")]
    assert w2v and all(torch.equal(after[p], loaded[p]) for p in w2v)
    moved = [p for p in loaded if p.startswith("/brain/gru/") and not torch.equal(after[p], loaded[p])]
    assert moved, "the brain encoder did not train"


def test_a_snapshot_that_does_not_fit_or_is_missing_raises(env):
    """No fallback to random weights: shapes are checked leaf by leaf, and a
    cache_dir without the snapshot names where it looked."""
    from transformers import Wav2Vec2ForCTC

    from test_torch_convert import hf_config

    wide = hf_config("wav2vec2")
    wide.intermediate_size = 160
    torch.manual_seed(0)
    hub(env, "wide", "w2v", Wav2Vec2ForCTC(wide))
    with pytest.raises(ValueError, match=r"/w2v/encoder/layers/0/feed_forward/intermediate_dense/kernel"):
        port_experiment(env, "wide", "w2v", w2v_skip_loading_weights=False, results_subdir_name="wide")
    with pytest.raises(FileNotFoundError, match="models--facebook--wav2vec2-base-960h"):
        port_experiment(env, "empty", "w2v", w2v_skip_loading_weights=False, results_subdir_name="empty")
    assert FAMILIES["w2v"]["wav2vec_checkpoint"] == W2V_CKPT
