"""The port's experiment lifecycle and Trainer against the JAX package's, on
CPU, for both families (tiny encoders, biGRU 2 x 32, batch 3):

- parity: the JAX experiment and the port's run on the same fixture from the
  same bridged initial weights (bridge.params_from_jax -> adopt_params),
  with noise, dropout and LayerDrop off. Per-epoch train and val losses and
  the test loss agree within 1e-4 relative; WER and CER are equal. The
  train split (4 samples) ends in a ragged batch of 1, padded to 3 rows by
  masked duplicates in both packages; the val split is 3 + 3 + 2.
- early stopping: patience 2 and a delta of 1e9 stop both packages after
  epoch 2 of 3;
- best-model reload: the test loss is the reloaded best model's in both,
  after one more epoch on the val split (--train_on_val_once);
- resume: a port run checkpointed at epoch 1 and resumed with
  --resume_train_state equals a straight 2-epoch port run bitwise
  (histories, test loss, params, Adam moments);
- --only_test --from_checkpoint reproduces the stored model's test loss;
- --store_brain_encoder writes brain_encoder.pt, which --brain_encoder_path
  restores into a new experiment's brain encoder (w2v, whose flags have it);
- the results dir has tests/test_train_e2e.py's layout with .pt for .msgpack.

Adam eps is 1e-4 in the parity runs (as in tests/test_torch_train_step.py),
so a gradient difference of summation order moves a param by at most
lr * d / eps. Every batch is padded to 64 frames and 4 target tokens
(--pad_to_multiple / --target_pad_to_multiple, in both packages), so the JAX
steps compile once. One JAX run per family is shared through a module
fixture.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from scipy.io import savemat

import wav2vec2forbrain_tpu.experiments.impl as jax_impl
from wav2vec2forbrain_tpu.args.base_args import PRETRAINED_LATENT_SIZES as JAX_LATENT
from wav2vec2forbrain_tpu.args.yaml_config import YamlConfigModel as JaxYaml
from wav2vec2forbrain_tpu.models.conformer import ConformerEncoderConfig as JaxConformerConfig
from wav2vec2forbrain_tpu.models.wav2vec2 import Wav2Vec2EncoderConfig as JaxW2VConfig
from wav2vec2forbrain_tpu_torch import bridge
from wav2vec2forbrain_tpu_torch.args.flags import PRETRAINED_LATENT_SIZES as PORT_LATENT
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel
from wav2vec2forbrain_tpu_torch.data.dataset import sessionNames
from wav2vec2forbrain_tpu_torch.experiments import impl
from wav2vec2forbrain_tpu_torch.models import pretrained
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig
from wav2vec2forbrain_tpu_torch.tree import tree_leaves

torch.set_num_threads(2)
W2V_CKPT = "facebook/wav2vec2-base-960h"
CONF_CKPT = "facebook/wav2vec2-conformer-rope-large-960h-ft"
NO_DROPOUT = dict(hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0, final_dropout=0.0, layerdrop=0.0)
REL = 1e-4
SENTENCES = ("A", "I", "HI", "GO", "OK", "AN", "TO", "A I")
FAMILIES = {
    "conformer": dict(experiment_type="b2p2t_gru+w2v_conformer", wav2vec_checkpoint=CONF_CKPT,
                      tokenizer_checkpoint=CONF_CKPT),
    "w2v": dict(experiment_type="b2p2t_gru+w2v", wav2vec_checkpoint=W2V_CKPT, tokenizer_checkpoint=W2V_CKPT),
}


def write_session(path, n_trials, n_blocks, seed):
    """A T12-schema session: 48-64 frames a trial (4-8 frames after the
    unfold), sentences of 1-3 characters (CTC-feasible, so no loss is 0)."""
    rng = np.random.default_rng(seed)
    tx1 = np.empty((1, n_trials), dtype=object)
    spike_pow = np.empty((1, n_trials), dtype=object)
    for i in range(n_trials):
        t = int(rng.integers(48, 65))
        tx1[0, i] = rng.poisson(2.0, size=(t, 256)).astype(np.float64)
        spike_pow[0, i] = rng.gamma(2.0, 1.0, size=(t, 256))
    sentences = [SENTENCES[int(k)] for k in rng.integers(0, len(SENTENCES), n_trials)]
    block_idx = np.array([[float(i * n_blocks // n_trials + 1)] for i in range(n_trials)])
    savemat(path, {"sentenceText": np.asarray(sentences), "tx1": tx1, "spikePow": spike_pow, "blockIdx": block_idx})


def make_splits(root):
    """train/: 2 sessions x 5 trials in 2 blocks -> test 6, train 4;
    test/ (the val split): 2 sessions x 4 trials -> val 8."""
    for split_dir, n_trials in (("train", 5), ("test", 4)):
        os.makedirs(os.path.join(root, split_dir), exist_ok=True)
        for k, name in enumerate(sessionNames[:2]):
            write_session(os.path.join(root, split_dir, f"{name}.mat"), n_trials, 2, 100 * k + n_trials)
    return root


def yaml_fields(tmp):
    return dict(cache_dir=str(tmp / "cache"), fig_dir=str(tmp / "figs"),
                n3gram_lm_model_path=str(tmp / "missing_3gram.arpa"),
                n5gram_lm_model_path=str(tmp / "missing_5gram.arpa"),
                dataset_splits_dir=str(tmp / "t12"), wandb_api_key="offline")


def config(family, **overrides):
    cfg = dict(
        FAMILIES[family], batch_size=3, epochs=3, learning_rate=1e-3, w2v_skip_loading_weights=True,
        encoder_gru_hidden_size=32, encoder_num_gru_layers=2, seed=0, use_wandb=False, mesh_data_parallel=1,
        scan_layers=False, device_data_cache="off", unfreeze_strategy="brain_encoder+w2v",
        w2v_learning_rate=1e-4, w2v_warmup_start_step=0, w2v_warmup_steps=2, optimizer_epsilon=1e-4,
        early_stopping_patience=2, early_stopping_delta=1e9,
        # one (T, U) for every batch: the JAX steps compile once
        pad_to_multiple=64, target_pad_to_multiple=4,
    )
    cfg.update(overrides)
    return cfg


def _tiny(checkpoint, conformer_cls, w2v_cls):
    if "conformer" in checkpoint:
        return "conformer", conformer_cls.tiny_test(conformer_conv_dropout=0.0, hidden_act="swish", **NO_DROPOUT)
    return "wav2vec2", w2v_cls.tiny_test(**NO_DROPOUT)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Both packages resolve the checkpoints to tiny encoders (latent 96)."""
    tmp = tmp_path_factory.mktemp("trainer")
    make_splits(str(tmp / "t12"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_impl, "encoder_config_for_checkpoint",
                   lambda c: _tiny(c, JaxConformerConfig, JaxW2VConfig))
        mp.setattr(pretrained, "encoder_config_for_checkpoint",
                   lambda c: _tiny(c, ConformerEncoderConfig, Wav2Vec2EncoderConfig))
        for table in (JAX_LATENT, PORT_LATENT):
            mp.setitem(table, W2V_CKPT, 96)
            mp.setitem(table, CONF_CKPT, 96)
        yield tmp


def port_run(env, family, params=None, **overrides):
    cls = impl.B2TGruAndW2VConformerExperiment if family == "conformer" else impl.B2TGruAndW2VExperiment
    exp = cls(config(family, **overrides), YamlConfigModel(**yaml_fields(env)), device="cpu")
    if params is not None:
        exp.adopt_params(*params)
    exp.run()
    return exp


def history(exp):
    with open(os.path.join(exp.results_dir, "history.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_run(env):
    """family -> (JAX history, the bridged initial params) of the JAX run,
    made once a family."""
    runs = {}

    def run(family):
        if family not in runs:
            cls = (jax_impl.B2TGruAndW2VConformerExperiment if family == "conformer"
                   else jax_impl.B2TGruAndW2VExperiment)
            exp = cls(config(family, results_subdir_name="jax", train_on_val_once=True), JaxYaml(**yaml_fields(env)))
            tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), (exp._merged_params(), exp.model_state))
            init = bridge.params_from_jax(*jax.device_get(tree), device="cpu")
            exp.run()
            runs[family] = (history(exp), init)
        return runs[family]

    return run


def _close(got, ref):
    assert np.isfinite(got) and got > 0
    assert abs(got - ref) <= REL * abs(ref), (got, ref)


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_trainer_matches_jax(env, jax_run, family):
    """Epoch losses, WER/CER, early stopping, and the test loss of the
    reloaded best model after one more epoch on val (--train_on_val_once)."""
    ref, init = jax_run(family)
    exp = port_run(env, family, params=init, results_subdir_name="port", train_on_val_once=True)
    got = history(exp)
    assert len(ref["epochs"]) == len(got["epochs"]) == 2  # early-stopped after epoch 2 of 3
    for e_got, e_ref in zip(got["epochs"], ref["epochs"]):
        for split in ("train", "val"):
            g, r = e_got[split]["average"], e_ref[split]["average"]
            _close(g["loss"], r["loss"])
            assert g["metrics"] == r["metrics"], (split, g["metrics"], r["metrics"])
            assert len(e_got[split]["history"]) == len(e_ref[split]["history"]) == (2 if split == "train" else 3)
    g, r = got["test"]["average"], ref["test"]["average"]
    _close(g["loss"], r["loss"])
    assert g["metrics"] == r["metrics"]
    assert set(g["metrics"]) == {"word_error_rate", "char_error_rate"}
    # the best model (by val loss) was reloaded before the test evaluation
    best = int(np.argmin([e["val"]["average"]["loss"] for e in got["epochs"]]))
    assert best == int(np.argmin([e["val"]["average"]["loss"] for e in ref["epochs"]]))

    layout = sorted(os.listdir(exp.results_dir))
    assert {"config.json", "history.json", "metrics.jsonl", "model.pt"} <= set(layout)
    try:
        import matplotlib  # noqa: F401

        assert "history.png" in layout
    except ImportError:
        pass
    with open(os.path.join(exp.results_dir, "config.json")) as f:
        assert "repro_cmd" in json.load(f)
    with open(os.path.join(exp.results_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    metric_rows = [r for r in rows if r["_type"] == "metrics"]
    assert any("val_ctc_loss" in r for r in metric_rows) and any("test_ctc_loss" in r for r in metric_rows)
    assert any("train_samples_per_sec" in r for r in metric_rows)

    # --only_test --from_checkpoint reproduces the stored model's test loss
    only = port_run(env, family, only_test=True, from_checkpoint=os.path.join(exp.results_dir, "model.pt"),
                    results_subdir_name="only_test")
    with open(os.path.join(only.results_dir, "test_predictions.json")) as f:
        pred = json.load(f)["average"]
    assert pred["loss"] == got["test"]["average"]["loss"]
    assert pred["metrics"] == got["test"]["average"]["metrics"]
    assert only.checkpoint_history is not None and len(only.checkpoint_history.epochs) == 2


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_resume_train_state_equals_a_straight_run(env, family):
    common = dict(epochs=2, return_best_model=False, early_stopping_patience=None, checkpoint_every_n_epochs=1)
    if family == "w2v":
        common["store_brain_encoder"] = True
    straight = port_run(env, family, results_subdir_name="straight", **common)
    first = port_run(env, family, results_subdir_name="first", **dict(common, epochs=1))
    state_dir = os.path.join(first.results_dir, "train_state")
    assert os.path.exists(os.path.join(state_dir, "state.pt"))
    resumed = port_run(env, family, results_subdir_name="resumed", resume_train_state=state_dir, **common)
    a, b = history(straight), history(resumed)
    assert len(a["epochs"]) == len(b["epochs"]) == 2
    assert a["epochs"] == b["epochs"] and a["test"] == b["test"]
    for x, y in zip(tree_leaves(straight.params) + tree_leaves(straight.opt_state.mu),
                    tree_leaves(resumed.params) + tree_leaves(resumed.opt_state.mu)):
        assert torch.equal(x, y)
    assert straight.opt_state.count == resumed.opt_state.count == 4
    if family == "w2v":  # --store_brain_encoder (a w2v flag) and --brain_encoder_path
        subtree = os.path.join(straight.results_dir, "brain_encoder.pt")
        assert os.path.exists(subtree)
        cls = impl.B2TGruAndW2VExperiment
        fresh = cls(config(family, seed=5, results_subdir_name="brain"), YamlConfigModel(**yaml_fields(env)),
                    device="cpu")
        loaded = cls(config(family, seed=5, results_subdir_name="brain", brain_encoder_path=subtree),
                     YamlConfigModel(**yaml_fields(env)), device="cpu")
        for x, y in zip(tree_leaves(straight.params["brain"]), tree_leaves(loaded.params["brain"])):
            assert torch.equal(x, y)
        for x, y in zip(tree_leaves(fresh.params["w2v"]), tree_leaves(loaded.params["w2v"])):
            assert torch.equal(x, y)
