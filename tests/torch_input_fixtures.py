"""Synthetic splits for the tests of the port's input path (a helper
module, not collected as tests; it imports no jax, so the `cuda` tests
that read it run where jax is not installed).

`SyntheticSplit` is a dataset of seeded samples with right-skewed lengths
(as T12's), sentences with punctuation to strip and two recording days, in
the standard (T, C) layout or the (2, T, C) one of
seperate_zscoring_2channels; its collate is the port's
(data/dataset.py::Brain2TextDataset.get_collate_fn). `placing_trainer` is
a Trainer that holds only what Trainer._place reads.
"""

from types import SimpleNamespace

import numpy as np
import torch

from wav2vec2forbrain_tpu_torch.data.dataset import MULTICHANNEL, Brain2TextDataset
from wav2vec2forbrain_tpu_torch.data.loader import DataLoader
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer
from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer

SENTENCES = ("A", "HI, GO", "OK!", "TO", "IT'S A", "GO-GO")
LAYOUTS = ("seperate_zscoring", "seperate_zscoring_2channels")


class Sample:
    __slots__ = ("input", "target", "day_idx")

    def __init__(self, x, target, day_idx):
        self.input = x
        self.target = target
        self.day_idx = day_idx


class SyntheticSplit:
    def __init__(self, n: int, seed: int, preprocessing: str = "seperate_zscoring", channels: int = 8,
                 min_len: int = 20, max_len: int = 90):
        rng = np.random.default_rng(seed)
        self.config = SimpleNamespace(preprocessing=preprocessing, remove_punctuation=True)
        lengths = np.clip(rng.gamma(3.0, (max_len - min_len) / 6, n) + min_len, min_len, max_len).astype(int)
        self.samples = []
        for t in lengths:
            shape = (2, int(t), channels) if preprocessing in MULTICHANNEL else (int(t), channels)
            self.samples.append(Sample(rng.standard_normal(shape).astype(np.float32),
                                       SENTENCES[int(rng.integers(len(SENTENCES)))], int(rng.integers(2))))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def get_collate_fn(self, tokenizer, pad_to_multiple=1, target_pad_to_multiple=1):
        return Brain2TextDataset.get_collate_fn(self, tokenizer, pad_to_multiple, target_pad_to_multiple)


def synthetic_splits(seed: int, preprocessing: str = "seperate_zscoring", sizes=(23, 9, 7)) -> dict:
    """{"train", "val", "test": SyntheticSplit} of the given sizes."""
    return {split: SyntheticSplit(n, seed + k, preprocessing)
            for k, (split, n) in enumerate(zip(("train", "val", "test"), sizes))}


def loaders(splits: dict, tokenizer, batch_size: int, pad_to_multiple: int = 1, target_pad_to_multiple: int = 1,
            seed: int = 0) -> dict:
    """{split: DataLoader} over `splits`, the train split shuffled."""
    return {split: DataLoader(ds, batch_size, ds.get_collate_fn(tokenizer, pad_to_multiple, target_pad_to_multiple),
                              shuffle=split == "train", seed=seed)
            for split, ds in splits.items()}


def input_config(**overrides) -> SimpleNamespace:
    """The flags build_split_caches and Trainer._place read."""
    cfg = dict(pad_to_multiple=1, target_pad_to_multiple=1, h2d_dtype="float32", length_buckets="off",
               batch_size=4, preprocessing="seperate_zscoring", remove_punctuation=True)
    cfg.update(overrides)
    return SimpleNamespace(**cfg)


def placing_trainer(cache, split: str, cfg, device="cpu", shard=None) -> Trainer:
    """A Trainer holding only what _place reads, with the split's widths
    (and buckets) as its resident `cache` gives them."""
    trainer = Trainer.__new__(Trainer)
    trainer.config, trainer.device, trainer.shard = cfg, torch.device(device), shard
    trainer.experiment = SimpleNamespace(batch_widths={split: (cache.t_full, cache.u_full)},
                                         t_buckets={split: cache.buckets} if cache.buckets else {},
                                         time_axis=cache.time_axis, tokenizer=Wav2Vec2CTCTokenizer())
    return trainer
