"""The port's LM-decoding evaluator and the --only_test LM path against the
JAX package's, on the CPU.

- The port's and the JAX EvaluatorWithLMDecoder, each with its own
  package's decoder on the same random 3-gram ARPA (tests/lm_fixtures.py),
  take the same predictions dicts: the `*_lm_decode` metrics (per batch
  and averaged) are equal exactly, the stored `predictions_lm_decoded`
  are equal strings, in batch order, under a pool of 1 and of 3 workers.
  A decoder whose first batch is the slowest keeps the batch order.
- End to end: a tiny conformer and a tiny w2v experiment (the fixture of
  tests/test_torch_trainer.py) run --only_test
  --lm_decode_test_predictions=true --device_data_cache=off in both
  packages from the same bridged initial weights at f32. The two
  test_predictions.json agree: the greedy loss within 1e-5 relative, the
  greedy and LM strings equal, WER and CER (greedy and LM) equal. This
  holds the port's --only_test (at the Trainer's width) to the JAX
  _predict (at the collate's width) where the two widths agree.
"""

import json
import os
import sys
import time

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from lm_fixtures import build_random_arpa  # noqa: E402
from test_torch_trainer import FAMILIES, config, env, yaml_fields  # noqa: E402,F401

import wav2vec2forbrain_tpu.experiments.impl as jax_impl  # noqa: E402
from wav2vec2forbrain_tpu.args.yaml_config import YamlConfigModel as JaxYaml  # noqa: E402
from wav2vec2forbrain_tpu.data.batch import B2tBatch as JaxBatch  # noqa: E402
from wav2vec2forbrain_tpu.data.tokenizer import Wav2Vec2CTCTokenizer as JaxTokenizer  # noqa: E402
from wav2vec2forbrain_tpu.decode import lm_decode as jax_lm  # noqa: E402
from wav2vec2forbrain_tpu.train import evaluator as jax_evaluator  # noqa: E402
from wav2vec2forbrain_tpu_torch import bridge  # noqa: E402
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel  # noqa: E402
from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch  # noqa: E402
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer  # noqa: E402
from wav2vec2forbrain_tpu_torch.decode import lm_decode  # noqa: E402
from wav2vec2forbrain_tpu_torch.experiments import impl  # noqa: E402
from wav2vec2forbrain_tpu_torch.train import evaluator  # noqa: E402

SENTENCES = ["THE CAT SAT", "ON THE MAT", "SO SOON", "NO"]
LM_KNOBS = dict(beam_width=24, beam_prune_logp=-12.0, token_min_logp=-3.0, alpha=0.5, beta=1.0,
                score_boundary=True)


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    return build_random_arpa(str(tmp_path_factory.mktemp("lm") / "lm.arpa"), seed=123)


def _batches(tok, n=5, b=3, t=30, seed=0):
    """n (predictions, batch) pairs: logits that spell the targets under
    noise, so the beam search and the LM both have work."""
    rng = np.random.default_rng(seed)
    vocab = tok.get_vocab_list()
    idx = {c: i for i, c in enumerate(vocab)}
    out = []
    for k in range(n):
        texts = [SENTENCES[int(j)] for j in rng.integers(0, len(SENTENCES), b)]
        ids = [tok.encode(s) for s in texts]
        u = max(len(x) for x in ids)
        target = np.zeros((b, u), np.int32)
        for i, x in enumerate(ids):
            target[i, : len(x)] = x
        logits = rng.normal(0.0, 1.5, size=(b, t, len(vocab))).astype(np.float32)
        for i, s in enumerate(texts):
            for f, ch in enumerate(s.replace(" ", "|")[: t // 2]):
                logits[i, 2 * f, idx[ch]] += rng.uniform(1.0, 4.0)
        lens = rng.integers(t - 8, t + 1, b).astype(np.int32)
        preds = {"loss": float(rng.uniform(1, 5)), "pred_ids": np.argmax(logits, -1).astype(np.int32),
                 "logits": logits, "logit_lens": lens}
        args = (np.zeros((b, 4, 4), np.float32), target, np.zeros(b, np.int32), lens,
                np.asarray([len(x) for x in ids], np.int32), np.ones(b, np.float32))
        out.append((preds, args))
    return out


def _run(ev, batches, batch_cls):
    for preds, args in batches:
        ev.track_batch(dict(preds), batch_cls(*args))
    hist = ev.evaluate()
    ev.clean_up()
    return hist, ev.lm_decoded_batches


@pytest.mark.parametrize("workers", [1, 3])
def test_lm_evaluator_matches_jax(arpa, workers):
    tok, jtok = Wav2Vec2CTCTokenizer(), JaxTokenizer()
    batches = _batches(tok, seed=workers)
    got, got_decoded = _run(evaluator.EvaluatorWithLMDecoder(
        tok, "test", lm_decoder=lm_decode.make_lm_decoder(tok.get_vocab_list(), arpa, **LM_KNOBS),
        lm_decode_test_predictions=True, lm_decode_workers=workers), batches, B2tBatch)
    ref, ref_decoded = _run(jax_evaluator.EvaluatorWithLMDecoder(
        jtok, "test", lm_decoder=jax_lm.make_lm_decoder(jtok.get_vocab_list(), arpa, **LM_KNOBS),
        lm_decode_test_predictions=True, lm_decode_workers=workers), batches, JaxBatch)
    assert got.to_dict() == ref.to_dict()
    assert got_decoded == ref_decoded and len(got_decoded) == len(batches)
    for entry, stored in zip(got.metrics, got.decoded):
        assert {"word_error_rate_lm_decode", "char_error_rate_lm_decode"} <= set(entry.metrics)
        assert len(stored["predictions_lm_decoded"]) == len(stored["predictions"])
    avg, ref_avg = got.get_average(), ref.get_average()
    assert avg.metrics == ref_avg.metrics
    assert any(s for b in got_decoded for s in b)


def test_lm_decode_is_only_on_the_test_split(arpa):
    tok = Wav2Vec2CTCTokenizer()
    hook = lm_decode.make_lm_decoder(tok.get_vocab_list(), arpa)
    for mode in ("train", "val"):
        ev = evaluator.EvaluatorWithLMDecoder(tok, mode, lm_decoder=hook, lm_decode_test_predictions=True)
        assert ev.lm_decoder is None
    assert evaluator.EvaluatorWithLMDecoder(tok, "test", lm_decoder=hook).lm_decoder is None


def test_pool_keeps_the_batch_order_when_the_first_decode_is_slowest():
    tok = Wav2Vec2CTCTokenizer()
    calls = []

    def slow_decoder(logits, logit_lens):
        time.sleep(0.2 if not calls else 0.01)
        calls.append(len(calls))
        return [f"B{int(logit_lens[0])}"] * logits.shape[0]

    batches = _batches(tok, n=6, seed=9)
    hist, decoded = _run(evaluator.EvaluatorWithLMDecoder(tok, "test", lm_decoder=slow_decoder,
                                                          lm_decode_test_predictions=True, lm_decode_workers=3),
                         batches, B2tBatch)
    want = [[f"B{int(p['logit_lens'][0])}"] * 3 for p, _ in batches]
    assert decoded == want
    assert [d["predictions_lm_decoded"] for d in hist.decoded] == want
    assert hist.get_average().loss == pytest.approx(np.mean([p["loss"] for p, _ in batches]), rel=1e-12)


def _predictions(results_dir):
    with open(os.path.join(results_dir, "test_predictions.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_only_test_with_lm_decode_matches_jax(env, arpa, family):  # noqa: F811
    fields = dict(yaml_fields(env), n3gram_lm_model_path=arpa)
    flags = dict(only_test=True, lm_decode_test_predictions=True, device_data_cache="off",
                 lm_decode_beam_width=24, lm_decode_alpha=0.5, lm_decode_beta=1.0, lm_score_boundary=True,
                 compute_dtype="float32")
    cls = jax_impl.B2TGruAndW2VConformerExperiment if family == "conformer" else jax_impl.B2TGruAndW2VExperiment
    ref_exp = cls(config(family, results_subdir_name="lm_jax", **flags), JaxYaml(**fields))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), (ref_exp._merged_params(), ref_exp.model_state))
    ref_exp.run()
    ref = _predictions(ref_exp.results_dir)

    port_cls = impl.B2TGruAndW2VConformerExperiment if family == "conformer" else impl.B2TGruAndW2VExperiment
    exp = port_cls(config(family, results_subdir_name="lm_port", **flags), YamlConfigModel(**fields), device="cpu")
    exp.adopt_params(*bridge.params_from_jax(*jax.device_get(tree), device="cpu"))
    exp.run()
    assert exp.batch_widths == {} and exp.lm_decoder.decoder.lm_order == 3
    got = _predictions(exp.results_dir)

    assert abs(got["average"]["loss"] - ref["average"]["loss"]) <= 1e-5 * abs(ref["average"]["loss"])
    assert got["average"]["metrics"] == ref["average"]["metrics"]
    assert {"word_error_rate", "char_error_rate", "word_error_rate_lm_decode",
            "char_error_rate_lm_decode"} <= set(got["average"]["metrics"])
    assert len(got["history"]) == len(ref["history"]) == 2  # test split: 6 samples, batches of 3
    for g, r in zip(got["history"], ref["history"]):
        assert abs(g["loss"] - r["loss"]) <= 1e-5 * abs(r["loss"])
        assert g["metrics"] == r["metrics"]
        assert g["batch"] == r["batch"]
        assert set(g["batch"]) == {"predictions", "targets", "predictions_lm_decoded"}
