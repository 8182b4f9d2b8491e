"""Phoneme-target Brain2Text dataset (counterpart of
wav2vec2forbrain_tpu/data/phoneme_dataset.py; ref:
src/datasets/brain2text_w_phonemes.py).

Targets are ARPAbet phoneme id sequences (blank=0, 40 phones+SIL shifted +1)
instead of character tokens. Used by the phoneme analysis/aux experiments;
the two registered experiment types use the character dataset.
"""

from typing import Callable, List, Literal

import numpy as np

from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch
from wav2vec2forbrain_tpu_torch.data.dataset import _PUNCTUATION_RE, B2tSample, Brain2TextDataset, time_axis_of
from wav2vec2forbrain_tpu_torch.util.phoneme_helper import PHONE_DEF_SIL, get_phoneme_seq, make_g2p
from wav2vec2forbrain_tpu_torch.util.seq import round_up


class PhonemeSample(B2tSample):
    __slots__ = ("transcription", "phonemes")


class Brain2TextWPhonemesDataset(Brain2TextDataset):
    vocab_size = len(PHONE_DEF_SIL) + 1
    vocab = ["blank"] + PHONE_DEF_SIL

    def __init__(self, config, dataset_splits_dir: str, split: Literal["train", "val", "test"] = "train") -> None:
        super().__init__(config, dataset_splits_dir, split)
        g2p = make_g2p()
        self.phoneme_seqs = [get_phoneme_seq(g2p, sample.target) for sample in self.samples]

    def __getitem__(self, index: int) -> PhonemeSample:
        base = super().__getitem__(index)
        phoneme_ids, phonemes = self.phoneme_seqs[index]
        transcription = base.target
        if self.config.remove_punctuation:
            transcription = _PUNCTUATION_RE.sub("", transcription)
        sample = PhonemeSample(base.input, phoneme_ids, base.day_idx)
        sample.transcription = transcription
        sample.phonemes = phonemes
        return sample

    def get_phoneme_collate_fn(
        self, pad_to_multiple: int = 1, target_pad_to_multiple: int = 1
    ) -> Callable[[List[PhonemeSample]], B2tBatch]:
        """Collate with phoneme-id targets (ref: brain2text_w_phonemes.py:54-98)
        into a numpy B2tBatch; the transcriptions and phonemes stay on the
        samples (host side only)."""
        time_axis = time_axis_of(self.config.preprocessing)

        def _collate(batch: List[PhonemeSample]) -> B2tBatch:
            max_len = round_up(max(s.input.shape[time_axis] for s in batch), pad_to_multiple)
            inputs = []
            for s in batch:
                pad_widths = [(0, 0)] * s.input.ndim
                pad_widths[time_axis] = (0, max_len - s.input.shape[time_axis])
                inputs.append(np.pad(s.input, pad_widths))
            max_u = round_up(max(len(s.target) for s in batch), target_pad_to_multiple)
            targets = np.zeros((len(batch), max_u), np.int32)
            for i, s in enumerate(batch):
                targets[i, : len(s.target)] = s.target
            return B2tBatch(
                input=np.stack(inputs).astype(np.float32),
                target=targets,
                day_idxs=np.asarray([s.day_idx for s in batch], np.int32),
                input_lens=np.asarray([s.input.shape[time_axis] for s in batch], np.int32),
                target_lens=np.asarray([len(s.target) for s in batch], np.int32),
                sample_mask=np.ones((len(batch),), np.float32),
            )

        return _collate
