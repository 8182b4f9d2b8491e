"""The wav2vec2-base family (`b2p2t_gru+w2v`) served end to end at a tiny
size: the fft sweep's shape of model (a 3-layer biGRU, no FC hidden layer,
gaussian_smooth_width 1.5) with GRU H=128 and `Wav2Vec2EncoderConfig.
tiny_test()`, B=3, 60 frames (T'=8), f32. The port's eval step against the
JAX package's forward_with_loss(train=False) on the same bridged weights
and batch (its Pallas kernels in interpret mode, the `all` policy), and
predict.py's greedy WER/CER against the JAX evaluator on the same logits.
The train steps of the same model: tests/test_torch_w2v_train_step.py.

Tolerances: logits atol/rtol 1e-4 and loss rtol 1e-5 (three GRU and two
encoder layers of f32 sums in another order); pred_ids equal wherever the
top-2 logit margin exceeds 1e-3."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu.data.tokenizer import Wav2Vec2CTCTokenizer as JaxTokenizer
from wav2vec2forbrain_tpu.models import assembly as jax_assembly
from wav2vec2forbrain_tpu.models.wav2vec2 import Wav2Vec2EncoderConfig as JaxW2VConfig
from wav2vec2forbrain_tpu.ops import select as jax_select
from wav2vec2forbrain_tpu.train.evaluator import EvaluatorWithLMDecoder as JaxEvaluator
from wav2vec2forbrain_tpu_torch import bridge
from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch, to_device
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer
from wav2vec2forbrain_tpu_torch.models import assembly as port_assembly
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig
from wav2vec2forbrain_tpu_torch.predict import predict
from wav2vec2forbrain_tpu_torch.train.steps import build_eval_step
from torch_jax_prng import jax_threefry  # noqa: F401

torch.set_num_threads(1)
SPEC = dict(gru_hidden_size=128, gru_num_layers=3, latent_size=96, gaussian_smooth_width=1.5,
            encoder_family="wav2vec2")
DROPOUT_OFF = dict(hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0, final_dropout=0.0,
                   layerdrop=0.0)
VARIANTS = {
    "dropout_off": dict(cfg=DROPOUT_OFF, gru_dropout=0.0),
    "dropout_on": dict(cfg=dict(layerdrop=0.5), gru_dropout=0.45),
}
SENTENCES = ["HI", "A", "GO", "NO", "OK", "YES"]


def _specs(variant="dropout_off"):
    v = VARIANTS[variant]
    jspec = jax_assembly.ModelSpec(**SPEC, gru_dropout=v["gru_dropout"], w2v_cfg=JaxW2VConfig.tiny_test(**v["cfg"]),
                                   compute_dtype=jnp.float32, use_pallas=True)
    tspec = port_assembly.ModelSpec(**SPEC, gru_dropout=v["gru_dropout"],
                                    w2v_cfg=Wav2Vec2EncoderConfig.tiny_test(**v["cfg"]))
    return jspec, tspec


def _batch(seed, sentences):
    rng = np.random.default_rng(seed)
    b, t = len(sentences), 60
    lens = np.array([60, 52, 44][:b], np.int32)
    x = rng.standard_normal((b, t, 256)).astype(np.float32)
    x[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    tok = Wav2Vec2CTCTokenizer()
    ids = [tok.encode(s) for s in sentences]
    target = np.zeros((b, max(len(i) for i in ids)), np.int32)
    for i, seq in enumerate(ids):
        target[i, : len(seq)] = seq
    return B2tBatch(input=x, target=target, day_idxs=rng.integers(0, 24, b).astype(np.int32),
                    input_lens=lens, target_lens=np.array([len(i) for i in ids], np.int32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def eval_run():
    jspec, tspec = _specs()
    p, s = jax_assembly.init_model_params(jax.random.PRNGKey(0), jspec)
    batch = _batch(0, SENTENCES[:3])
    jax_select.set_kernel_policy("all")
    try:
        fwd = jax.jit(functools.partial(jax_assembly.forward_with_loss, spec=jspec, train=False))
        out = fwd(p, s, x=batch.input, day_idxs=batch.day_idxs, input_lens=batch.input_lens,
                  targets=batch.target, target_lens=batch.target_lens)
    finally:
        jax_select.set_kernel_policy("auto")
    tp, ts = bridge.params_from_jax(_np(p), _np(s), device="cpu")
    got = build_eval_step(tspec)(tp, ts, to_device(batch, "cpu"))
    return out, got, (tp, ts, tspec)


def test_eval_step_matches_jax_forward_with_loss(eval_run):
    ref, (loss, logits, logit_lens, pred_ids, metrics), _ = eval_run
    assert logits.shape == (3, 8, 32) and logits.dtype == torch.float32 and metrics == {}
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref["logits"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(logit_lens.numpy(), [7, 5, 3])
    np.testing.assert_array_equal(logit_lens.numpy(), np.asarray(ref["logit_lens"]))
    assert float(loss) > 0
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=1e-5)
    top2 = np.sort(np.asarray(ref["logits"]), axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert decided.mean() > 0.9
    ref_ids = np.asarray(jnp.argmax(ref["logits"], axis=-1))
    np.testing.assert_array_equal(pred_ids.numpy()[decided], ref_ids[decided])


def test_predict_matches_jax_evaluator_on_the_same_logits(eval_run):
    _, _, (tp, ts, tspec) = eval_run
    batches = [_batch(1, SENTENCES[:3]), _batch(2, SENTENCES[3:])]
    seen = []
    history = predict(tp, ts, tspec, batches, on_batch=lambda i, preds: seen.append(preds))
    jax_eval = JaxEvaluator(JaxTokenizer(), "test", lm_decoder=None)
    for preds, batch in zip(seen, batches):
        jax_eval.track_batch({k: preds[k] for k in ("loss", "pred_ids", "logits", "logit_lens")}, batch)
    got = history.to_dict()
    assert got == jax_eval.evaluate().to_dict()
    assert got["history"][1]["batch"]["targets"] == SENTENCES[3:]
