"""Brain2Text dataset: .mat ingest, block-split policy, collation
(counterpart of wav2vec2forbrain_tpu/data/dataset.py).

24 T12 sessions; the split policy reads val from the `test/` dir, carves
test off the first block of each `train/` dir file and trains on the
remaining blocks; 8 preprocessing strategies; upper-cased transcriptions;
optional resampling; a pad-to-batch-max collate (with optional
pad-to-multiple rounding) with regex punctuation stripping and day / length
side info, into numpy `B2tBatch`es.
"""

import os
import re
from pathlib import Path
from typing import Callable, List, Literal

import numpy as np

from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch
from wav2vec2forbrain_tpu_torch.data.preprocessing import PreprocessingFunctions, resample_sample
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer
from wav2vec2forbrain_tpu_torch.util.seq import calc_seq_len, round_up

# The 24 T12 recording sessions.
sessionNames = sorted(
    [
        "t12.2022.04.28", "t12.2022.05.26", "t12.2022.06.21", "t12.2022.07.21",
        "t12.2022.08.13", "t12.2022.05.05", "t12.2022.06.02", "t12.2022.06.23",
        "t12.2022.07.27", "t12.2022.08.18", "t12.2022.05.17", "t12.2022.06.07",
        "t12.2022.06.28", "t12.2022.07.29", "t12.2022.08.23", "t12.2022.05.19",
        "t12.2022.06.14", "t12.2022.07.05", "t12.2022.08.02", "t12.2022.08.25",
        "t12.2022.05.24", "t12.2022.06.16", "t12.2022.07.14", "t12.2022.08.11",
    ]
)

N_DAYS = len(sessionNames)

_PUNCTUATION_RE = re.compile(r'[\,\?\.\!\-\;\:"]')
MULTICHANNEL = ("seperate_zscoring_2channels", "seperate_zscoring_4channels")


def time_axis_of(preprocessing: str) -> int:
    """Time axis within one sample: 1 for the (ch, T, F) multichannel
    layouts, 0 for the standard (T, C) one."""
    return 1 if preprocessing in MULTICHANNEL else 0


def process_label(label: str, remove_punctuation: bool) -> str:
    return _PUNCTUATION_RE.sub("", label) if remove_punctuation else label


def split_pass(dataset, tokenizer, pad_to_multiple: int = 1, target_pad_to_multiple: int = 1):
    """One host pass over a split's samples: (samples, lengths, T, targets),
    the samples as __getitem__ gives them (resampled), each one's frames
    (the collate's input_lens), the longest rounded up to pad_to_multiple,
    and the (N, U) int32 token ids padded with the pad id to the longest
    rounded up to target_pad_to_multiple. None for an empty split. Both
    `dataset_width` and the device data cache's plan
    (train/device_cache.py) read it."""
    n = len(dataset)
    if n == 0:
        return None
    time_axis = time_axis_of(dataset.config.preprocessing)
    samples = [dataset[i] for i in range(n)]
    lengths = [s.input.shape[time_axis] for s in samples]
    t_max = round_up(max(lengths), pad_to_multiple)
    ids = tokenizer([process_label(s.target, dataset.config.remove_punctuation) for s in samples]).input_ids
    u_max = round_up(ids.shape[1], target_pad_to_multiple)
    if u_max > ids.shape[1]:
        ids = np.pad(ids, ((0, 0), (0, u_max - ids.shape[1])), constant_values=tokenizer.pad_token_id)
    return samples, lengths, t_max, ids.astype(np.int32)


def dataset_width(dataset, tokenizer, pad_to_multiple: int = 1, target_pad_to_multiple: int = 1,
                  wire_bytes: int = 4):
    """(T, U, bytes, lengths) of a split's dataset-wide padding bucket, as
    the device data cache plans it (train/device_cache.py): the longest
    sample's frames and the longest target's tokens, rounded up to the
    multiples, the bytes the cache holds, and each sample's frames (after
    resampling, as the collate's input_lens). None for an empty split."""
    split = split_pass(dataset, tokenizer, pad_to_multiple, target_pad_to_multiple)
    if split is None:
        return None
    samples, lengths, t_max, ids = split
    n, u_max = ids.shape
    per_frame = samples[0].input.size // lengths[0]
    return t_max, u_max, n * t_max * per_frame * wire_bytes + n * u_max * 4 + 3 * n * 4, lengths


class B2tSample:
    __slots__ = ("input", "target", "day_idx")

    def __init__(self, input: np.ndarray, target: str, day_idx: int = 0):
        self.input = input
        self.target = target
        self.day_idx = day_idx


class Brain2TextDataset:
    """config: the experiment's flags (preprocessing, competition_mode,
    area, limit_samples, sample_rate, remove_punctuation)."""

    def __init__(self, config, dataset_splits_dir: str, split: Literal["train", "val", "test"] = "train") -> None:
        from scipy.io import loadmat

        self.config = config
        if split == "val":
            data_path = Path(dataset_splits_dir) / "test"
        elif split == "test" and config.competition_mode:
            data_path = Path(dataset_splits_dir) / "competitionHoldOut"
        else:
            data_path = Path(dataset_splits_dir) / "train"
        if not os.path.exists(data_path):
            raise Exception(f"{data_path} does not exist.")

        data_files = [
            (day_idx, loadmat(data_path / f"{file_prefix}.mat"))
            for day_idx, file_prefix in enumerate(sessionNames)
            if os.path.exists(data_path / f"{file_prefix}.mat")
        ]
        preprocess = PreprocessingFunctions[config.preprocessing]
        self.samples: List[B2tSample] = []
        for day_idx, data_file in data_files:
            block_nums = np.squeeze(data_file["blockIdx"])
            block_list = np.unique(block_nums)
            # test = the first block of the train-dir files, train = the rest
            if split == "test" and not config.competition_mode:
                block_list = [block_list[0]]
            if split == "train" and not config.competition_mode:
                block_list = block_list[1:]
            blocks = []
            for b in range(len(block_list)):
                sent_idx = np.argwhere(block_nums == block_list[b])
                blocks.append(sent_idx[:, 0].astype(np.int32))
            input_features, transcriptions = preprocess(data_file, blocks, config.area)
            assert len(input_features) == len(transcriptions), (
                "Length of input features and transcriptions must be equal."
            )
            for i in range(len(input_features)):
                self.samples.append(
                    B2tSample(np.asarray(input_features[i], dtype=np.float32), transcriptions[i].upper(), day_idx)
                )

    def __len__(self) -> int:
        if self.config.limit_samples is None:
            return len(self.samples)
        return min(len(self.samples), self.config.limit_samples)

    def __getitem__(self, index: int) -> B2tSample:
        orig_sample_rate = 50
        target_sample_rate = self.config.sample_rate
        if target_sample_rate % orig_sample_rate != 0:
            print("WARNING: target_sample_rate % orig_sample_rate != 0")
        sample = self.samples[index]
        if target_sample_rate != orig_sample_rate:
            return B2tSample(
                resample_sample(sample.input, target_sample_rate, orig_sample_rate), sample.target, sample.day_idx
            )
        return sample

    def get_collate_fn(
        self, tokenizer: Wav2Vec2CTCTokenizer, pad_to_multiple: int = 1, target_pad_to_multiple: int = 1
    ) -> Callable[[List[B2tSample]], B2tBatch]:
        if tokenizer is None:
            raise ValueError("Tokenizer must be provided for the collate function.")
        time_axis = time_axis_of(self.config.preprocessing)
        remove_punct = self.config.remove_punctuation

        def _collate(batch: List[B2tSample]) -> B2tBatch:
            max_len = round_up(max(s.input.shape[time_axis] for s in batch), pad_to_multiple)
            inputs = []
            for s in batch:
                pad_widths = [(0, 0)] * s.input.ndim
                pad_widths[time_axis] = (0, max_len - s.input.shape[time_axis])
                inputs.append(np.pad(s.input, pad_widths))
            label_ids = tokenizer(
                [process_label(s.target, remove_punct) for s in batch], padding="longest"
            ).input_ids
            if target_pad_to_multiple > 1:
                padded_u = round_up(label_ids.shape[1], target_pad_to_multiple)
                if padded_u > label_ids.shape[1]:
                    label_ids = np.pad(
                        label_ids,
                        ((0, 0), (0, padded_u - label_ids.shape[1])),
                        constant_values=tokenizer.pad_token_id,
                    )
            return B2tBatch(
                input=np.stack(inputs).astype(np.float32),
                target=label_ids.astype(np.int32),
                day_idxs=np.asarray([s.day_idx for s in batch], dtype=np.int32),
                input_lens=np.asarray([s.input.shape[time_axis] for s in batch], dtype=np.int32),
                target_lens=np.asarray([calc_seq_len(row) for row in label_ids], dtype=np.int32),
                sample_mask=np.ones((len(batch),), dtype=np.float32),
            )

        return _collate
