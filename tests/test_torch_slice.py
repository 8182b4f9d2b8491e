"""The ported serving slice end to end on a tiny conformer: the port's
eval_step against the JAX package's forward_with_loss(train=False) (Pallas
kernels in interpret mode) on the same bridged weights and the same batch,
then predict.py's greedy WER/CER against the JAX evaluator on the same
logits.

Tolerances at f32: logits atol/rtol 1e-4 (two GRU layers and two conformer
layers of f32 sums taken in another order), CTC loss rtol 1e-5, pred_ids
equal wherever the top-2 logit margin exceeds 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu.data.tokenizer import Wav2Vec2CTCTokenizer as JaxTokenizer
from wav2vec2forbrain_tpu.models import assembly as jax_assembly
from wav2vec2forbrain_tpu.models.conformer import ConformerEncoderConfig as JaxConformerConfig
from wav2vec2forbrain_tpu.ops import select as jax_select
from wav2vec2forbrain_tpu.train.evaluator import EvaluatorWithLMDecoder as JaxEvaluator
from wav2vec2forbrain_tpu_torch.bridge import params_from_jax
from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch, to_device
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer
from wav2vec2forbrain_tpu_torch.models import assembly as port_assembly
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.predict import predict
from wav2vec2forbrain_tpu_torch.train.steps import build_eval_step
from torch_jax_prng import jax_threefry  # noqa: F401

torch.set_num_threads(1)
SENTENCES = ["HI", "A CAT", "GO", "NO", "YES", "OK"]


def _specs(compute: str):
    jspec = jax_assembly.ModelSpec(
        gru_hidden_size=128,
        latent_size=96,
        encoder_family="conformer",
        conformer_cfg=JaxConformerConfig.tiny_test(hidden_act="swish"),
        compute_dtype=jnp.dtype(compute),
        use_pallas=True,
    )
    tspec = port_assembly.ModelSpec(
        gru_hidden_size=128,
        latent_size=96,
        conformer_cfg=ConformerEncoderConfig.tiny_test(hidden_act="swish"),
        compute_dtype=getattr(torch, compute),
    )
    return jspec, tspec


def _batch(seed, sentences):
    rng = np.random.default_rng(seed)
    b, t = len(sentences), 96
    lens = np.array([96, 80, 64][:b], np.int32)
    x = rng.standard_normal((b, t, 256)).astype(np.float32)
    x[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    tok = Wav2Vec2CTCTokenizer()
    ids = [tok.encode(s) for s in sentences]
    target = np.zeros((b, max(len(i) for i in ids)), np.int32)
    for i, seq in enumerate(ids):
        target[i, : len(seq)] = seq
    return B2tBatch(
        input=x,
        target=target,
        day_idxs=rng.integers(0, 24, b).astype(np.int32),
        input_lens=lens,
        target_lens=np.array([len(i) for i in ids], np.int32),
    )


def _run_both(compute: str, seed: int = 0):
    jspec, tspec = _specs(compute)
    p, s = jax_assembly.init_model_params(jax.random.PRNGKey(seed), jspec)
    batch = _batch(seed, SENTENCES[:3])
    jax_select.set_kernel_policy("all")
    try:
        out = jax_assembly.forward_with_loss(
            p, s, jspec,
            *(jnp.asarray(a) for a in (batch.input, batch.day_idxs, batch.input_lens,
                                       batch.target, batch.target_lens)),
            train=False,
        )
    finally:
        jax_select.set_kernel_policy("auto")
    jax_out = {
        "loss": float(out["loss"]),
        "logits": np.asarray(out["logits"]),
        "logit_lens": np.asarray(out["logit_lens"]),
        "pred_ids": np.asarray(jnp.argmax(out["logits"], axis=-1)),
    }
    tp, ts = params_from_jax(jax.tree_util.tree_map(np.asarray, p), jax.tree_util.tree_map(np.asarray, s),
                             device="cpu")
    loss, logits, logit_lens, pred_ids, metrics = build_eval_step(tspec)(tp, ts, to_device(batch, "cpu"))
    port_out = {
        "loss": float(loss),
        "logits": logits.numpy(),
        "logit_lens": logit_lens.numpy(),
        "pred_ids": pred_ids.numpy(),
        "metrics": metrics,
    }
    return jax_out, port_out, (tp, ts, tspec)


@pytest.fixture(scope="module")
def f32_run():
    return _run_both("float32")


def test_eval_step_matches_jax_forward_with_loss(f32_run):
    ref, got, _ = f32_run
    assert got["logits"].shape == (3, 17, 32) and got["logits"].dtype == np.float32
    np.testing.assert_allclose(got["logits"], ref["logits"], atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got["logit_lens"], ref["logit_lens"])
    np.testing.assert_array_equal(got["logit_lens"], [16, 12, 8])
    assert got["loss"] > 0 and got["metrics"] == {}
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    top2 = np.sort(ref["logits"], axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got["pred_ids"][decided], ref["pred_ids"][decided])


def test_predict_matches_jax_evaluator_on_the_same_logits(f32_run):
    _, _, (tp, ts, tspec) = f32_run
    batches = [_batch(1, SENTENCES[:3]), _batch(2, SENTENCES[3:])]
    seen = []
    history = predict(tp, ts, tspec, batches, on_batch=lambda i, preds: seen.append(preds))
    jax_eval = JaxEvaluator(JaxTokenizer(), "test", lm_decoder=None)
    for preds, batch in zip(seen, batches):
        jax_eval.track_batch(
            {k: preds[k] for k in ("loss", "pred_ids", "logits", "logit_lens")}, batch
        )
    ref = jax_eval.evaluate().to_dict()
    got = history.to_dict()
    assert got == ref
    avg = got["average"]["metrics"]
    assert set(avg) == {"word_error_rate", "char_error_rate"}
    assert got["history"][0]["batch"]["targets"] == SENTENCES[:3]


def test_bf16_compute_matches_jax_loosely():
    """bf16 compute: bf16 rounds at other places in the two frameworks (XLA
    may keep a fused product's intermediate in f32 where the port rounds it
    and the other way round), and the rounding differences pass through
    four recurrent/encoder layers: logits atol 5e-2, loss rtol 1e-2."""
    ref, got, _ = _run_both("bfloat16", seed=3)
    assert np.isfinite(got["logits"]).all()
    np.testing.assert_allclose(got["logits"], ref["logits"], atol=5e-2, rtol=0)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-2)


def test_train_mode_raises_until_the_training_slice(f32_run):
    """Train mode runs since the training slice, but only with its seed
    streams: without a ForwardRng the forward refuses (the JAX package
    likewise asserts a dropout rng in train mode)."""
    _, _, (tp, ts, tspec) = f32_run
    b = to_device(_batch(0, SENTENCES[:3]), "cpu")
    with pytest.raises(ValueError, match="train mode needs a ForwardRng"):
        port_assembly.forward(tp, ts, tspec, b.input, b.day_idxs, b.input_lens, train=True)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_matches_jax_with_mask_and_infeasible_sample(reduction):
    """The two pieces written out around F.ctc_loss: the feasibility rule
    (sample 1 needs 4 frames for 'AAB', a repeat included, but has 2) and the
    sample_mask mean (sample 2 masked out). rtol 1e-5."""
    from wav2vec2forbrain_tpu.ops.ctc import ctc_loss as jax_ctc
    from wav2vec2forbrain_tpu_torch.ops.ctc import ctc_loss

    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 12, 32)).astype(np.float32)
    logit_lens = np.array([12, 2, 9], np.int32)
    targets = np.array([[5, 6, 7], [7, 7, 24], [9, 9, 0]], np.int32)
    target_lens = np.array([3, 3, 2], np.int32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    ref = np.asarray(jax_ctc(*(jnp.asarray(a) for a in (logits, logit_lens, targets, target_lens)),
                             reduction, sample_mask=jnp.asarray(mask)))
    got = ctc_loss(*(torch.from_numpy(a) for a in (logits, logit_lens, targets, target_lens)),
                   reduction, sample_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    if reduction == "none":
        assert got[1] == 0.0 and got[2] == 0.0 and got[0] > 0


def test_kernel_policy_values():
    from wav2vec2forbrain_tpu_torch.ops import select

    try:
        select.set_kernel_policy("none")
        assert not any(select.kernel_enabled(k) for k in select.KERNELS)
        select.set_kernel_policy("attention, gru")
        assert [k for k in select.KERNELS if select.kernel_enabled(k)] == ["gru", "attention"]
        select.set_kernel_policy("all")
        # kernels not ported yet run their plain version under every policy
        assert [k for k in select.KERNELS if select.kernel_enabled(k)] == [
            k for k in select.KERNELS if k in select.PORTED]
        assert set(select.PORTED) < set(select.KERNELS)
        with pytest.raises(ValueError):
            select.set_kernel_policy("attention,flash")
    finally:
        select.set_kernel_policy("auto")
    assert all(select.kernel_enabled(k) for k in select.PORTED)
