"""The port's host-side copies against the JAX package's: the evaluators
(greedy decode with and without --greedy_decode_crop_lens, every mode),
the history records (to_dict, from_json of a JAX-written history.json,
plot), the JSONL logger and --use_wandb without wandb, the 18 activations
(f32, 2e-6 absolute and relative: torch and XLA evaluate erf / tanh / exp
with their own polynomials), ModelSpec.from_args and the encoder configs of the supported
checkpoints, the port's torch checkpoints (a strict round trip, the brain-encoder
subtree file), and Trainer._put's rows, widths and --h2d_dtype cast against
the JAX Trainer's host side."""

import builtins
import dataclasses
import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu.experiments.args_models import B2TGruAndW2VArgsModel as JaxArgs
from wav2vec2forbrain_tpu.models import pretrained as jax_pretrained
from wav2vec2forbrain_tpu.models.activations import ACT2FN as JAX_ACT2FN
from wav2vec2forbrain_tpu.models.assembly import ModelSpec as JaxModelSpec
from wav2vec2forbrain_tpu.data.tokenizer import Wav2Vec2CTCTokenizer as JaxTokenizer
from wav2vec2forbrain_tpu.train import evaluator as jax_evaluator
from wav2vec2forbrain_tpu.train import history as jax_history
from wav2vec2forbrain_tpu.train import logger as jax_logger
from wav2vec2forbrain_tpu_torch.args.flags import ACTIVATION_FUNCTION, B2TGruAndW2VArgsModel, validate
from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer
from wav2vec2forbrain_tpu_torch.models import pretrained
from wav2vec2forbrain_tpu_torch.models.activations import ACT2FN
from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec, init_model_params
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.train import checkpoint, evaluator, history, logger
from wav2vec2forbrain_tpu_torch.tree import tree_leaves


def _batches(n=3, b=4, t=12, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        target = rng.integers(5, 32, (b, 6)).astype(np.int32)
        target[:, 4:] = 0
        lens = rng.integers(3, t + 1, b).astype(np.int32)
        preds = {"loss": float(rng.uniform(1, 5)), "pred_ids": rng.integers(0, 32, (b, t)).astype(np.int32),
                 "logit_lens": lens, "metrics": {"ctc_loss": float(rng.uniform())}}
        out.append((preds, B2tBatch(None, target, np.zeros(b, np.int32), lens, np.full(b, 4, np.int32))))
    return out


@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("crop", [False, True])
@pytest.mark.parametrize("track", [False, True])
def test_evaluators_match(mode, crop, track):
    for port_cls, ref_cls in ((evaluator.DefaultEvaluator, jax_evaluator.DefaultEvaluator),
                              (evaluator.EvaluatorWithLMDecoder, jax_evaluator.EvaluatorWithLMDecoder)):
        got = port_cls(Wav2Vec2CTCTokenizer(), mode, track_non_test_predictions=track, crop_lens=crop)
        ref = ref_cls(JaxTokenizer(), mode, track_non_test_predictions=track, crop_lens=crop)
        for preds, batch in _batches():
            got.track_batch(dict(preds), batch)
            ref.track_batch(dict(preds), batch)
        assert got.get_running_loss() == ref.get_running_loss()
        assert got.evaluate().to_dict() == ref.evaluate().to_dict()


def test_lm_decode_raises_naming_the_roadmap():
    """The LM decode is ported (it no longer raises NotImplementedError):
    without a decoder the test evaluator decodes greedily, as the JAX one
    does; with one it raises on a batch that brings no logits."""
    tok = Wav2Vec2CTCTokenizer()
    (preds, batch), = _batches(n=1)
    plain = evaluator.EvaluatorWithLMDecoder(tok, "test", lm_decode_test_predictions=True)
    ref = jax_evaluator.EvaluatorWithLMDecoder(JaxTokenizer(), "test", lm_decode_test_predictions=True)
    assert plain.lm_decoder is None and ref.lm_decoder is None
    plain.track_batch(dict(preds), batch)
    ref.track_batch(dict(preds), batch)
    assert plain.evaluate().to_dict() == ref.evaluate().to_dict()
    with_lm = evaluator.EvaluatorWithLMDecoder(tok, "test", lm_decoder=lambda logits, lens: [""] * len(lens),
                                               lm_decode_test_predictions=True)
    with pytest.raises(ValueError, match="logits"):
        with_lm.track_batch(dict(preds), batch)


def _history(mod, ev_mod, tok):
    epochs = []
    for e in range(2):
        hs = []
        for mode in ("train", "val"):
            ev = ev_mod.EvaluatorWithLMDecoder(tok, mode)
            for preds, batch in _batches(seed=e * 2 + len(hs)):
                ev.track_batch(dict(preds), batch)
            hs.append(ev.evaluate())
        epochs.append(mod.EpochLosses(*hs))
    test = ev_mod.EvaluatorWithLMDecoder(tok, "test")
    for preds, batch in _batches(seed=9):
        test.track_batch(dict(preds), batch)
    return mod.TrainHistory(epochs, test.evaluate())


def test_history_records_match_and_round_trip(tmp_path):
    got = _history(history, evaluator, Wav2Vec2CTCTokenizer())
    ref = _history(jax_history, jax_evaluator, JaxTokenizer())
    assert got.to_dict() == ref.to_dict()
    path = tmp_path / "history.json"
    path.write_text(json.dumps(ref.to_dict(), indent=5))
    loaded = history.TrainHistory.from_json(str(path))
    assert loaded.to_dict() == jax_history.TrainHistory.from_json(str(path)).to_dict() == ref.to_dict()
    assert loaded.epochs[1].val_losses.get_last().loss == ref.epochs[1].val_losses.get_last().loss
    pytest.importorskip("matplotlib")
    got.plot(str(tmp_path / "history.png"))
    assert os.path.getsize(tmp_path / "history.png") > 0


def test_jsonl_logger_and_missing_wandb(tmp_path, monkeypatch):
    rows = [{"val_ctc_loss": 1.5, "val_word_error_rate": 0.5}, {"test_ctc_loss": 2.0}]
    real_import = builtins.__import__

    def no_wandb(name, *args, **kwargs):
        if name == "wandb":
            raise ImportError("no wandb")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_wandb)
    for name, mod in (("port", logger), ("jax", jax_logger)):
        out = mod.make_logger(str(tmp_path / name), {"seed": 1}, use_wandb=True, wandb_api_key="offline")
        for row in rows:
            out.log(row)
        out.finish()
    read = {}
    for name in ("port", "jax"):
        with open(tmp_path / name / "metrics.jsonl") as f:
            read[name] = [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]
    assert read["port"] == read["jax"] and len(read["port"]) == 3


@pytest.mark.parametrize("name", ACTIVATION_FUNCTION.__args__)
def test_activations_match(name):
    assert set(ACT2FN) == set(JAX_ACT2FN) == set(ACTIVATION_FUNCTION.__args__)
    x = np.linspace(-12, 12, 2001, dtype=np.float32)
    got = ACT2FN[name](torch.from_numpy(x)).numpy()
    ref = np.asarray(JAX_ACT2FN[name](jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("checkpoint_name", ["facebook/wav2vec2-base-960h", "facebook/wav2vec2-large-960h",
                                             "facebook/wav2vec2-conformer-rope-large-960h-ft"])
def test_model_spec_from_args_matches(checkpoint_name):
    kw = dict(encoder_gru_hidden_size=64, encoder_num_gru_layers=3, encoder_fc_hidden_sizes=[128],
              encoder_fc_activation_function="mish", gaussian_smooth_width=1.5, encoder_dropout=0.2,
              aux_head_vocab_size=32, additional_loss_weight=0.5, encoder_learnable_inital_state=True)
    family, cfg = pretrained.encoder_config_for_checkpoint(checkpoint_name)
    ref_family, ref_cfg = jax_pretrained.encoder_config_for_checkpoint(checkpoint_name)
    assert family == ref_family
    assert dataclasses.asdict(cfg).items() <= dataclasses.asdict(ref_cfg).items()
    got = ModelSpec.from_args(validate(B2TGruAndW2VArgsModel, kw), 96, family, cfg)
    ref = JaxModelSpec.from_args(JaxArgs(**kw), 96, family, ref_cfg)
    for f in dataclasses.fields(ModelSpec):
        if f.name in ("w2v_cfg", "conformer_cfg", "compute_dtype", "activation_dtype"):
            continue
        if f.name == "remat_policy":  # JAX's acts on its scanned layer loop only: unscanned, nothing is remat'd
            assert not ref.scan_layers and got.remat_policy == "none"
            continue
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


def test_checkpoints_round_trip_strictly(tmp_path):
    spec = ModelSpec(gru_hidden_size=32, latent_size=96, conformer_cfg=ConformerEncoderConfig.tiny_test())
    params, state = init_model_params(torch.Generator().manual_seed(0), spec, "cpu")
    checkpoint.save_checkpoint(str(tmp_path / "model.pt"), params, state)
    checkpoint.save_subtree(str(tmp_path / "brain_encoder.pt"), params["brain"])
    other, other_state = init_model_params(torch.Generator().manual_seed(1), spec, "cpu")
    loaded, loaded_state = checkpoint.load_checkpoint(str(tmp_path / "model.pt"))
    checkpoint.copy_into(other, loaded)
    checkpoint.copy_into(other_state, loaded_state)
    for a, b in zip(tree_leaves(params) + tree_leaves(state), tree_leaves(other) + tree_leaves(other_state)):
        assert torch.equal(a, b)
    brain = checkpoint.load_tree(str(tmp_path / "brain_encoder.pt"))["params"]
    assert set(brain) == {"preproc", "gru", "fc"}
    narrow, _ = init_model_params(torch.Generator().manual_seed(0),
                                  dataclasses.replace(spec, gru_hidden_size=16), "cpu")
    with pytest.raises(ValueError, match="mismatch"):
        checkpoint.copy_into(narrow, loaded)


@pytest.mark.parametrize("wire", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("width", [None, (40, 9)])
def test_trainer_put_matches_the_jax_host_side(wire, width):
    """3 rows padded to batch 5 with masked duplicates, then (with a width)
    padded to the split's (T, U), then the features cast to the wire dtype
    on the host, as the JAX Trainer's _put (and its device cache) does; the
    forward takes them up to f32 again."""
    import ml_dtypes

    from wav2vec2forbrain_tpu.train.train_loop import _pad_batch
    from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 33, 256)).astype(np.float32)
    batch = B2tBatch(x, rng.integers(1, 32, (3, 7)).astype(np.int32), np.arange(3, dtype=np.int32),
                     np.array([33, 20, 31], np.int32), np.array([7, 5, 6], np.int32), np.ones(3, np.float32))
    trainer = Trainer.__new__(Trainer)
    trainer.config = validate(B2TGruAndW2VArgsModel, {"batch_size": 5, "h2d_dtype": wire})
    trainer.device = torch.device("cpu")
    trainer.experiment = SimpleNamespace(batch_widths={} if width is None else {"train": width}, t_buckets={},
                                         time_axis=0, tokenizer=Wav2Vec2CTCTokenizer())
    got, true_b = trainer._put(batch, "train")
    ref = _pad_batch(batch, 5)
    if width is not None:
        ref = ref._replace(input=np.pad(ref.input, ((0, 0), (0, width[0] - 33), (0, 0))),
                           target=np.pad(ref.target, ((0, 0), (0, width[1] - 7))))
    dt = {"float32": np.float32, "float16": np.float16, "bfloat16": ml_dtypes.bfloat16}[wire]
    assert true_b == 3
    np.testing.assert_array_equal(got.input.float().numpy(), ref.input.astype(dt).astype(np.float32))
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), r)
