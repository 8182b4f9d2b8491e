"""The port's --length_buckets (train/buckets.py, experiments/impl.py's
width plan, Trainer._put) against the JAX package's bucket grid
(train/device_cache.py::build_split_caches, DeviceDatasetCache.width_for
and reachable_widths), on the CPU.

- widths: for N = 2, 3, 4 and "exact" and two pad multiples, the same
  synthetic splits give the same per-split widths, reachable widths and
  per-batch widths in both packages (the JAX caches built and uploaded on
  the CPU);
- the experiment: a tiny w2v experiment under --device_data_cache=on
  --length_buckets=exact runs each batch of every split at its streaming
  collate's width, and N = 2 at the grid's;
- losses: the tiny w2v experiment (the fixture of
  tests/test_torch_trainer.py, 48-64 frames, --pad_to_multiple=8) under
  exact buckets gives the JAX package's epoch and test losses within 1e-4
  relative from the same bridged weights, and the port's own streaming
  run's within 1e-6.
"""

import json
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_trainer import config, env, yaml_fields  # noqa: E402,F401

import wav2vec2forbrain_tpu.experiments.impl as jax_impl  # noqa: E402
from wav2vec2forbrain_tpu.args.yaml_config import YamlConfigModel as JaxYaml  # noqa: E402
from wav2vec2forbrain_tpu.data.tokenizer import Wav2Vec2CTCTokenizer as JaxTokenizer  # noqa: E402
from wav2vec2forbrain_tpu.train.device_cache import build_split_caches  # noqa: E402
from wav2vec2forbrain_tpu_torch import bridge  # noqa: E402
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel  # noqa: E402
from wav2vec2forbrain_tpu_torch.data.dataset import dataset_width  # noqa: E402
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer  # noqa: E402
from wav2vec2forbrain_tpu_torch.experiments import impl  # noqa: E402
from wav2vec2forbrain_tpu_torch.train import buckets  # noqa: E402
from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer  # noqa: E402

WORDS = ("A", "HI", "GO", "OK", "TO")


class _Sample:
    def __init__(self, t, text, day):
        self.input = np.zeros((t, 4), np.float32)
        self.target = text
        self.day_idx = day


class _Dataset:
    def __init__(self, lengths, seed):
        rng = np.random.default_rng(seed)
        self.config = SimpleNamespace(preprocessing="seperate_zscoring", remove_punctuation=True)
        self.samples = [_Sample(int(t), WORDS[int(rng.integers(len(WORDS)))], int(rng.integers(2)))
                        for t in lengths]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _splits(seed):
    """Right-skewed lengths, as T12's: 40 train, 12 val, 9 test samples."""
    rng = np.random.default_rng(seed)
    return {split: _Dataset(np.clip(rng.gamma(4.0, 60.0, n), 70, 700).astype(int), seed + k)
            for k, (split, n) in enumerate((("train", 40), ("val", 12), ("test", 9)))}


@pytest.mark.parametrize("pad", [1, 32])
@pytest.mark.parametrize("mode", [2, 3, 4, "exact"])
def test_bucket_widths_match_jax(mode, pad):
    splits = _splits(seed=7 + pad)
    cfg = SimpleNamespace(preprocessing="seperate_zscoring", pad_to_multiple=pad, target_pad_to_multiple=1,
                          h2d_dtype="float32", remove_punctuation=True, length_buckets=mode)
    caches = build_split_caches({s: SimpleNamespace(dataset=d) for s, d in splits.items()}, JaxTokenizer(), cfg,
                                verbose=False)
    tok = Wav2Vec2CTCTokenizer()
    plans = {s: dataset_width(d, tok, pad, 1) for s, d in splits.items()}
    lengths = {s: p[3] for s, p in plans.items()}
    t_full = {s: p[0] for s, p in plans.items()}
    got = buckets.plan_buckets(lengths, t_full, mode, pad)
    assert set(got) == set(caches) == set(splits)
    rng = np.random.default_rng(0)
    for split, cache in caches.items():
        assert got[split] == cache._buckets
        assert buckets.reachable_widths(got[split], lengths[split]) == cache.reachable_widths()
        for _ in range(20):
            idxs = rng.choice(len(splits[split]), size=int(rng.integers(1, 6)), replace=False)
            need = max(lengths[split][i] for i in idxs)
            assert buckets.width_for(got[split], need) == cache.width_for(list(idxs))
    if mode == "exact":
        assert all(w % pad == 0 for b in got.values() for w in b)
        assert len(got["train"]) > 4
    else:
        assert all(len(b) <= mode + 1 for b in got.values())  # the grid, and the split's own width


def test_grid_off_and_below_two():
    assert buckets.plan_buckets({"train": [5, 9]}, {"train": 9}, "off", 1) == {}
    assert buckets.plan_buckets({"train": [5, 9]}, {"train": 9}, 1, 1) == {}
    assert buckets.split_buckets([4, 12], 9) == [4, 9]
    assert buckets.split_buckets([4], 9) == [4, 9]


def _port(env, family="w2v", params=None, **overrides):  # noqa: F811
    exp = impl.B2TGruAndW2VExperiment(config(family, **overrides), YamlConfigModel(**yaml_fields(env)),
                                      device="cpu")
    if params is not None:
        exp.adopt_params(*params)
    return exp


@pytest.mark.parametrize("mode", ["exact", 2])
def test_each_batch_runs_at_its_bucket(env, mode):  # noqa: F811
    exp = _port(env, pad_to_multiple=8, device_data_cache="on", length_buckets=mode)
    assert exp.t_buckets and set(exp.t_buckets) == set(exp.batch_widths)
    trainer = Trainer.__new__(Trainer)
    trainer.experiment, trainer.config, trainer.device = exp, exp.base_config, exp.device
    seen = set()
    for split, loader in (("train", exp.dataloader_train), ("val", exp.dataloader_val),
                          ("test", exp.dataloader_test)):
        for host_batch in loader:
            batch, _ = trainer._put(host_batch, split)
            width = batch.input.shape[1]
            seen.add(width)
            assert width in exp.t_buckets[split]
            assert batch.target.shape[1] == exp.batch_widths[split][1]
            if mode == "exact":
                assert width == host_batch.input.shape[1]  # the streaming collate's width
            else:
                assert width == buckets.width_for(exp.t_buckets[split], int(host_batch.input_lens.max()))
    assert len(seen) >= 2


def _history(exp):
    with open(os.path.join(exp.results_dir, "history.json")) as f:
        return json.load(f)


def _losses(h):
    return [e[s]["average"]["loss"] for e in h["epochs"] for s in ("train", "val")] + [h["test"]["average"]["loss"]]


def test_exact_bucket_losses_match_jax(env):  # noqa: F811
    flags = dict(pad_to_multiple=8, device_data_cache="on", length_buckets="exact")
    ref_exp = jax_impl.B2TGruAndW2VExperiment(config("w2v", results_subdir_name="jax_exact", **flags),
                                              JaxYaml(**yaml_fields(env)))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), (ref_exp._merged_params(), ref_exp.model_state))
    init = bridge.params_from_jax(*jax.device_get(tree), device="cpu")
    ref_exp.run()
    ref = _history(ref_exp)

    exact = _port(env, params=init, results_subdir_name="port_exact", **flags)
    assert len({w for b in exact.t_buckets.values() for w in b}) >= 2
    exact.run()
    streamed = _port(env, params=init, results_subdir_name="port_off", pad_to_multiple=8, device_data_cache="off")
    streamed.run()
    got, off = _history(exact), _history(streamed)
    assert len(got["epochs"]) == len(ref["epochs"]) == 2
    for g, r, o in zip(_losses(got), _losses(ref), _losses(off)):
        assert np.isfinite(g) and g > 0
        assert abs(g - r) <= 1e-4 * abs(r), (g, r)
        assert abs(g - o) <= 1e-6 * abs(o), (g, o)
    assert got["test"]["average"]["metrics"] == ref["test"]["average"]["metrics"]
