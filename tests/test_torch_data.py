"""The port's host data layer against the JAX package's on one synthetic
T12 fixture (2 sessions, 40-64 frames a trial): the 8 preprocessing
strategies and resampling, the split sizes, the collated batches under
--pad_to_multiple / --target_pad_to_multiple, the loader's index batches
(shuffle, --day_batches, --length_sorted_batches) over several epochs,
the --device_data_cache widths (on: the dataset-wide (T, U) of the JAX
device cache; off: the collate's width) with the Trainer's row padding, and
the port's .mat writer against the JAX writer. Everything is compared
exactly: both sides run the same numpy operations."""

import os
import random

import numpy as np
import pytest
from scipy.io import loadmat

from wav2vec2forbrain_tpu.data import preprocessing as jax_pre
from wav2vec2forbrain_tpu.data.dataset import Brain2TextDataset as JaxDataset
from wav2vec2forbrain_tpu.data.loader import Brain2TextBatchSampler as JaxSampler
from wav2vec2forbrain_tpu.data.loader import DataLoader as JaxLoader
from wav2vec2forbrain_tpu.data.synthetic import make_synthetic_splits_dir as jax_make_splits
from wav2vec2forbrain_tpu.data.tokenizer import Wav2Vec2CTCTokenizer as JaxTokenizer
from wav2vec2forbrain_tpu.experiments.args_models import B2TGruAndW2VArgsModel as JaxArgs
from wav2vec2forbrain_tpu.train.device_cache import DeviceDatasetCache
from wav2vec2forbrain_tpu.train.train_loop import _pad_batch
from wav2vec2forbrain_tpu_torch.args.flags import B2TGruAndW2VArgsModel, validate
from wav2vec2forbrain_tpu_torch.data import preprocessing as port_pre
from wav2vec2forbrain_tpu_torch.data.dataset import Brain2TextDataset, dataset_width, sessionNames
from wav2vec2forbrain_tpu_torch.data.loader import Brain2TextBatchSampler, DataLoader
from wav2vec2forbrain_tpu_torch.data.synthetic import make_synthetic_splits_dir
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer
from wav2vec2forbrain_tpu_torch.train.train_loop import pad_rows, pad_width
from wav2vec2forbrain_tpu_torch.util.seq import calc_seq_len, round_up

SPLITS = ("train", "val", "test")
STRATEGIES = sorted(jax_pre.PreprocessingFunctions)


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("t12_data")
    return jax_make_splits(str(root), n_trials=9, n_blocks=3, seed=3, with_competition_holdout=True,
                           min_frames=40, max_frames=64)


def _configs(**kw):
    return validate(B2TGruAndW2VArgsModel, kw), JaxArgs(**kw)


def _equal_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def test_seq_helpers_match():
    from wav2vec2forbrain_tpu.util import seq as jax_seq

    for row in ([0, 0], [3, 0, 5, 0], [1], []):
        assert calc_seq_len(row) == jax_seq.calc_seq_len(row)
    for n, m in ((5, 1), (5, 4), (8, 4), (0, 3)):
        assert round_up(n, m) == jax_seq.round_up(n, m)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("area", ["6v", "44"])
def test_preprocessing_strategies_match(strategy, area, splits):
    data_file = loadmat(os.path.join(splits, "train", f"{sessionNames[0]}.mat"))
    block_nums = np.squeeze(data_file["blockIdx"])
    blocks = [np.argwhere(block_nums == b)[:, 0].astype(np.int32) for b in np.unique(block_nums)[1:]]
    got_x, got_t = port_pre.PreprocessingFunctions[strategy](data_file, blocks, area)
    ref_x, ref_t = jax_pre.PreprocessingFunctions[strategy](data_file, blocks, area)
    assert got_t == ref_t and len(got_x) == len(ref_x) > 0
    for g, r in zip(got_x, ref_x):
        np.testing.assert_array_equal(g, r)
    x = ref_x[0] if ref_x[0].ndim == 2 else ref_x[0][0]
    for rate in (50, 100, 150):
        np.testing.assert_array_equal(port_pre.resample_sample(x, rate, 50), jax_pre.resample_sample(x, rate, 50))


@pytest.mark.parametrize("kw", [
    {}, {"limit_samples": 5}, {"competition_mode": True}, {"sample_rate": 100}, {"preprocessing": "only_tx_zscored"},
], ids=["default", "limit", "competition", "resample", "tx_only"])
def test_split_sizes_and_samples_match(kw, splits):
    port_cfg, jax_cfg = _configs(**kw)
    for split in SPLITS:
        got, ref = Brain2TextDataset(port_cfg, splits, split), JaxDataset(jax_cfg, splits, split)
        assert len(got) == len(ref) > 0, split
        for i in range(len(ref)):
            g, r = got[i], ref[i]
            assert (g.target, g.day_idx) == (r.target, r.day_idx)
            np.testing.assert_array_equal(g.input, r.input)


@pytest.mark.parametrize("pad,tpad,remove", [(1, 1, True), (16, 8, True), (64, 1, False)])
def test_collate_matches(pad, tpad, remove, splits):
    port_cfg, jax_cfg = _configs(remove_punctuation=remove)
    got_ds, ref_ds = Brain2TextDataset(port_cfg, splits, "train"), JaxDataset(jax_cfg, splits, "train")
    got_c = got_ds.get_collate_fn(Wav2Vec2CTCTokenizer(), pad, tpad)
    ref_c = ref_ds.get_collate_fn(JaxTokenizer(), pad, tpad)
    for idxs in ([0, 1, 2], [3], [4, 0, 5, 1]):
        _equal_batches(got_c([got_ds[i] for i in idxs]), ref_c([ref_ds[i] for i in idxs]))


@pytest.mark.parametrize("mode", ["shuffle", "day_batches", "length_sorted", "day_batches_length_sorted", "eval"])
def test_loader_index_batches_match(mode, splits):
    port_cfg, jax_cfg = _configs()
    got_ds, ref_ds = Brain2TextDataset(port_cfg, splits, "train"), JaxDataset(jax_cfg, splits, "train")
    length_sorted = "length_sorted" in mode
    shuffle = mode != "eval"

    def build(loader_cls, sampler_cls, ds):
        key = (lambda i: ds.samples[i].input.shape[0]) if length_sorted else None
        sampler = (sampler_cls(ds, 4, shuffle=shuffle, rng=random.Random(7), length_key=key)
                   if mode.startswith("day_batches") else None)
        return loader_cls(ds, 4, collate_fn=None, shuffle=shuffle, batch_sampler=sampler, seed=7, length_key=key)

    got, ref = build(DataLoader, Brain2TextBatchSampler, got_ds), build(JaxLoader, JaxSampler, ref_ds)
    assert len(got) == len(ref)
    for _ in range(3):  # epochs draw on
        assert list(got.iter_index_batches()) == list(ref.iter_index_batches())


@pytest.mark.parametrize("cache", ["on", "off"])
@pytest.mark.parametrize("pad,tpad", [(1, 1), (16, 8)])
def test_device_data_cache_widths_match(cache, pad, tpad, splits):
    """Trainer._put's host side (pad_rows, then pad_width to the split's
    dataset_width when the cache is on) against the JAX streaming
    collate + _pad_batch (off) and the JAX device cache's gathered batches
    (on), over an epoch with a ragged last batch."""
    port_cfg, jax_cfg = _configs()
    tok, jtok = Wav2Vec2CTCTokenizer(), JaxTokenizer()
    batch_size = 5
    for split in SPLITS:
        got_ds, ref_ds = Brain2TextDataset(port_cfg, splits, split), JaxDataset(jax_cfg, splits, split)
        collate = got_ds.get_collate_fn(tok, pad, tpad)
        got_loader = DataLoader(got_ds, batch_size, collate, shuffle=split == "train", seed=1)
        ref_loader = JaxLoader(ref_ds, batch_size, ref_ds.get_collate_fn(jtok, pad, tpad),
                               shuffle=split == "train", seed=1)
        width = dataset_width(got_ds, tok, pad, tpad)
        if cache == "on":
            plan = DeviceDatasetCache.plan(ref_ds, jtok, pad_to_multiple=pad, target_pad_to_multiple=tpad)
            assert width[:3] == (plan._t_full, plan._host_targets.shape[1], plan.nbytes)
            ref_batches = [tuple(None if a is None else np.asarray(a) for a in b)
                           for b, _, _ in plan.upload().stream(ref_loader, batch_size)]
        else:
            ref_batches = [_pad_batch(b, batch_size) for b in ref_loader]
        got_batches = []
        for b in got_loader:
            b = pad_rows(b, batch_size)
            if cache == "on":
                b = pad_width(b, *width[:2])
            got_batches.append(b)
        assert len(got_batches) == len(ref_batches) and len(got_ds) % batch_size != 0  # a ragged last batch
        for g, r in zip(got_batches, ref_batches):
            _equal_batches(g, r)


def test_mat_writer_matches_jax(tmp_path):
    kw = dict(n_trials=5, n_blocks=2, seed=11, with_competition_holdout=True, min_frames=40, max_frames=64,
              signal_strength=0.5, length_distribution="t12")
    got = make_synthetic_splits_dir(str(tmp_path / "port"), **kw)
    ref = jax_make_splits(str(tmp_path / "jax"), **kw)
    for split_dir in ("train", "test", "competitionHoldOut"):
        names = sorted(os.listdir(os.path.join(ref, split_dir)))
        assert sorted(os.listdir(os.path.join(got, split_dir))) == names and names
        for name in names:
            g = loadmat(os.path.join(got, split_dir, name))
            r = loadmat(os.path.join(ref, split_dir, name))
            np.testing.assert_array_equal(g["sentenceText"], r["sentenceText"])
            np.testing.assert_array_equal(g["blockIdx"], r["blockIdx"])
            for key in ("tx1", "spikePow"):
                assert g[key].shape == r[key].shape
                for a, b in zip(g[key][0], r[key][0]):
                    np.testing.assert_array_equal(a, b)
