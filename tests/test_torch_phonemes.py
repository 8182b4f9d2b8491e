"""The port's phoneme subsystem (util/phoneme_helper.py,
data/phoneme_dataset.py, train/evaluator.py::B2PEvaluator, the
CTCTextDatasetArgsModel flags) against the JAX package's on the same inputs:

- the ARPAbet inventory and the fallback G2P (the real g2p_en is on neither
  machine, so both sides run `FallbackG2p`);
- get_phoneme_seq on a fixed sentence set (empty text and <s> / </s>
  included) and decode_predicted_phoneme_ids, both id conventions;
- the phoneme dataset's samples and its collated batch, bitwise, on the
  synthetic splits (three splits, pad multiples);
- B2PEvaluator's phoneme error rate and decoded strings on seeded
  prediction ids, for each mode;
- CTCTextDatasetArgsModel's field names and defaults.
Everything is host code on both sides: compared exactly.
"""

import dataclasses

import numpy as np
import pytest

from wav2vec2forbrain_tpu.args import base_args as jax_args
from wav2vec2forbrain_tpu.data.batch import B2tBatch as JaxBatch
from wav2vec2forbrain_tpu.data.phoneme_dataset import Brain2TextWPhonemesDataset as JaxPhonemeDataset
from wav2vec2forbrain_tpu.train.evaluator import B2PEvaluator as JaxB2PEvaluator
from wav2vec2forbrain_tpu.util import phoneme_helper as jax_ph
from wav2vec2forbrain_tpu_torch.args import flags
from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch
from wav2vec2forbrain_tpu_torch.data.phoneme_dataset import Brain2TextWPhonemesDataset
from wav2vec2forbrain_tpu_torch.train.evaluator import B2PEvaluator
from wav2vec2forbrain_tpu_torch.util import phoneme_helper as ph

SENTENCES = [
    "", "HI THERE", "<s>the cat sat on the mat</s>", "  Quick   brown fox!  ", "I can't go, Bob.",
    "Squashed wheat: thoughtful chorus", "x", "ZZZ 123 ok", "<s></s>", "thorough boughs",
]


def test_inventory_matches():
    assert ph.PHONE_DEF == jax_ph.PHONE_DEF and ph.PHONE_DEF_SIL == jax_ph.PHONE_DEF_SIL
    assert ph.SIL_DEF == jax_ph.SIL_DEF and len(ph.PHONE_DEF_SIL) == 40
    assert Brain2TextWPhonemesDataset.vocab == JaxPhonemeDataset.vocab
    assert Brain2TextWPhonemesDataset.vocab_size == JaxPhonemeDataset.vocab_size == 41


@pytest.mark.parametrize("sentence", SENTENCES)
def test_fallback_g2p_and_phoneme_seq_match(sentence):
    assert ph.FallbackG2p()(sentence) == jax_ph.FallbackG2p()(sentence)
    for zero_is_blank in (True, False):
        got = ph.get_phoneme_seq(ph.FallbackG2p(), sentence, zero_is_blank)
        want = jax_ph.get_phoneme_seq(jax_ph.FallbackG2p(), sentence, zero_is_blank)
        assert tuple(got) == tuple(want)
        assert got.phonemes[-1] == "SIL"
    assert type(ph.make_g2p()).__name__ == type(jax_ph.make_g2p()).__name__


def test_decode_predicted_ids_match():
    rng = np.random.default_rng(0)
    for zero_is_blank in (True, False):
        low = 0 if zero_is_blank else -1
        for _ in range(20):
            ids = rng.integers(low, 41 if zero_is_blank else 40, rng.integers(0, 30)).tolist()
            assert ph.decode_predicted_phoneme_ids(ids, zero_is_blank) == \
                jax_ph.decode_predicted_phoneme_ids(ids, zero_is_blank)
    seq = ph.get_phoneme_seq(ph.FallbackG2p(), "CAT")
    assert ph.decode_predicted_phoneme_ids([0, *seq.phoneme_ids, 0]) == " ".join(seq.phonemes)


def _batches_equal(a, b):
    assert type(a).__name__ == type(b).__name__ == "B2tBatch"
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_dataset_and_collate_match(synthetic_splits_dir, split):
    port = Brain2TextWPhonemesDataset(flags.B2TDatasetArgsModel(), synthetic_splits_dir, split)
    ref = JaxPhonemeDataset(jax_args.B2TDatasetArgsModel(), synthetic_splits_dir, split)
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert np.array_equal(a.input, b.input) and a.input.dtype == b.input.dtype
        assert list(a.target) == list(b.target) and a.day_idx == b.day_idx
        assert a.phonemes == b.phonemes and a.transcription == b.transcription
        assert a.phonemes[-1] == "SIL" and len(a.target) == len(a.phonemes)
    for pad, target_pad in ((1, 1), (8, 4)):
        items = list(range(min(3, len(ref))))
        _batches_equal(port.get_phoneme_collate_fn(pad, target_pad)([port[i] for i in items]),
                       ref.get_phoneme_collate_fn(pad, target_pad)([ref[i] for i in items]))


@pytest.mark.parametrize("mode", ["train", "test"])
def test_b2p_evaluator_matches(mode):
    rng = np.random.default_rng(1)
    port, ref = B2PEvaluator(mode), JaxB2PEvaluator(mode)
    for step in range(3):
        b, t, u = 4, 12, 6
        target = rng.integers(1, 41, (b, u)).astype(np.int32)
        lens = rng.integers(1, u + 1, b).astype(np.int32)
        target[np.arange(u)[None, :] >= lens[:, None]] = 0
        fields = dict(input=np.zeros((b, t, 256), np.float32), target=target, day_idxs=np.zeros((b,), np.int32),
                      input_lens=np.full((b,), t, np.int32), target_lens=lens, sample_mask=np.ones((b,), np.float32))
        preds = {"loss": float(step + 0.5), "pred_ids": rng.integers(0, 41, (b, t)).astype(np.int32),
                 "metrics": {"ctc_loss": 1.0}}
        port.track_batch(preds, B2tBatch(**fields))
        ref.track_batch(preds, JaxBatch(**fields))
    got, want = port.evaluate(), ref.evaluate()
    assert got.get_average().metrics == want.get_average().metrics
    assert [m.metrics for m in got.metrics] == [m.metrics for m in want.metrics]
    assert [m.loss for m in got.metrics] == [m.loss for m in want.metrics]
    assert [d if d is None else tuple(d) for d in got.decoded] == [d if d is None else tuple(d) for d in want.decoded]
    assert port.get_running_loss() == ref.get_running_loss()
    assert (got.decoded[0] is None) == (mode == "train")


def test_b2p_evaluator_per_on_a_known_batch():
    """The JAX test's case: target [5, 7, 9], prediction collapsing to [5, 9]."""
    ev = B2PEvaluator("test")
    batch = B2tBatch(input=np.zeros((1, 4, 256), np.float32), target=np.asarray([[5, 7, 9, 0]], np.int32),
                     day_idxs=np.zeros((1,), np.int32), input_lens=np.asarray([4], np.int32),
                     target_lens=np.asarray([3], np.int32), sample_mask=np.ones((1,), np.float32))
    ev.track_batch({"loss": 1.0, "pred_ids": np.asarray([[5, 5, 0, 9]], np.int32)}, batch)
    hist = ev.evaluate()
    assert abs(hist.get_average().metrics["phoneme_error_rate"] - 1 / 3) < 1e-12
    assert hist.decoded[0].predictions[0].split() == [ph.PHONE_DEF_SIL[4], ph.PHONE_DEF_SIL[8]]


def test_ctc_text_dataset_flags_match():
    ref = jax_args.CTCTextDatasetArgsModel.model_fields
    got = {f.name: f.default for f in dataclasses.fields(flags.CTCTextDatasetArgsModel)}
    assert list(got) == list(ref)
    assert got == {name: field.default for name, field in ref.items()}
    assert len(got) == 13
