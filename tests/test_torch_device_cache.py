"""The port's device-resident dataset cache (train/device_cache.py) and
its place in the Trainer, against the JAX package's
(wav2vec2forbrain_tpu/train/device_cache.py) and against the port's own
streamed path (Trainer._place), on the CPU.

- the cache on synthetic splits (tests/torch_input_fixtures.py), in the
  standard and the seperate_zscoring_2channels layouts: the planned
  arrays bitwise against the JAX plan (features at a float32, float16 and
  bfloat16 wire, targets, lengths, days) and `nbytes`, which
  data/dataset.py::dataset_width also gives (the shared host pass);
  `padded_index_row` at data axis 1 and 2 with a ragged last batch;
  `width_for` with and without --length_buckets=4; `device_batch` at the
  split's width and at each bucket width, and `host_batch`, bitwise the
  JAX cache's;
- a gathered epoch bitwise `_place`'s batches of the collated epoch, at
  each wire dtype and with buckets; at dp 2 each rank's rows and
  mask_total, in process without a process group;
- the budget: over --device_data_cache_max_bytes every split streams and
  a line says why; an upload that fails raises with its reason;
- the Trainer (the tiny encoders of tests/test_torch_trainer.py, both
  families, --device_data_cache=on, 2 epochs): the resident run against
  the same experiment with its caches taken away (the streamed path at the
  same widths), every epoch history and the final params bitwise, and
  against the JAX Trainer's cached run at the same flags from the same
  bridged weights (losses within 1e-4 relative, WER and CER equal);
  --multi_step_chunk=2 --length_bucket_order=grouped visits the same
  batches in the same order resident as streamed.
"""

import json
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_trainer import config, env, yaml_fields  # noqa: E402,F401
from torch_input_fixtures import LAYOUTS, input_config, loaders, placing_trainer, synthetic_splits  # noqa: E402

import wav2vec2forbrain_tpu.experiments.impl as jax_impl  # noqa: E402
from wav2vec2forbrain_tpu.args.yaml_config import YamlConfigModel as JaxYaml  # noqa: E402
from wav2vec2forbrain_tpu.data.tokenizer import Wav2Vec2CTCTokenizer as JaxTokenizer  # noqa: E402
from wav2vec2forbrain_tpu.train import device_cache as jax_cache  # noqa: E402
from wav2vec2forbrain_tpu_torch import bridge  # noqa: E402
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel  # noqa: E402
from wav2vec2forbrain_tpu_torch.data.dataset import dataset_width  # noqa: E402
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer  # noqa: E402
from wav2vec2forbrain_tpu_torch.experiments import impl  # noqa: E402
from wav2vec2forbrain_tpu_torch.parallel.mesh import DataShard  # noqa: E402
from wav2vec2forbrain_tpu_torch.train import device_cache  # noqa: E402
from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer  # noqa: E402
from wav2vec2forbrain_tpu_torch.tree import tree_leaves  # noqa: E402

REL = 1e-4
PAD, TPAD = 8, 4
FIELDS = ("input", "target", "day_idxs", "input_lens", "target_lens", "sample_mask")


def _jax_config(**overrides):
    return input_config(pad_to_multiple=PAD, target_pad_to_multiple=TPAD, **overrides)


def _caches(splits, buckets="off", wire="float32"):
    """(the port's caches on the CPU, the JAX package's) of the same splits."""
    cfg = _jax_config(length_buckets=buckets, h2d_dtype=wire,
                      preprocessing=splits["train"].config.preprocessing)
    holders = {s: SimpleNamespace(dataset=d) for s, d in splits.items()}
    port = device_cache.build_split_caches(holders, Wav2Vec2CTCTokenizer(), cfg, torch.device("cpu"), verbose=False)
    ref = jax_cache.build_split_caches(holders, JaxTokenizer(), cfg, verbose=False)
    return port, ref


def _equal(got, ref):
    for name, g, r in zip(FIELDS, got, ref):
        if r is None:
            assert g is None, name
            continue
        if isinstance(g, torch.Tensor):
            g = (g.float() if g.dtype in (torch.float16, torch.bfloat16) else g).numpy()
        r = np.asarray(r)
        if r.dtype.name in ("bfloat16", "float16"):
            r = r.astype(np.float32)
        assert g.shape == r.shape, (name, g.shape, r.shape)
        np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("wire", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plan_matches_jax(layout, wire):
    ds = synthetic_splits(3, layout)["train"]
    port = device_cache.DeviceDatasetCache.plan(ds, Wav2Vec2CTCTokenizer(), PAD, TPAD, wire)
    ref = jax_cache.DeviceDatasetCache.plan(ds, JaxTokenizer(), pad_to_multiple=PAD, target_pad_to_multiple=TPAD,
                                            wire_dtype=wire, time_axis=int(layout != "seperate_zscoring"))
    assert port._host_feats.dtype == device_cache.WIRE_DTYPES[wire]
    np.testing.assert_array_equal(port._host_feats.float().numpy(), ref._host_feats.astype(np.float32))
    for got, want in ((port.targets, ref._host_targets), (port.day_idxs, ref._host_day),
                      (port.input_lens, ref._host_ilens), (port.target_lens, ref._host_tlens)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert (port.t_full, port.u_full, port.nbytes) == (ref._t_full, ref._host_targets.shape[1], ref.nbytes)
    t, u, nbytes, lengths = dataset_width(ds, Wav2Vec2CTCTokenizer(), PAD, TPAD, port._host_feats.element_size())
    assert (t, u, nbytes, lengths) == (port.t_full, port.u_full, port.nbytes, port.input_lens.tolist())
    assert port.t_full % PAD == 0 and port.u_full % TPAD == 0 and port.t_full > max(port.input_lens) - PAD


@pytest.mark.parametrize("data_axis", [1, 2])
def test_padded_index_row_matches_jax(data_axis):
    for idxs, batch_size in (([3, 1, 4], 4), ([5], 4), ([0, 1, 2, 3, 4], 4), ([7, 2], 3), ([6, 0, 9], 3)):
        got = device_cache.padded_index_row(idxs, batch_size, data_axis)
        ref = jax_cache.padded_index_row(idxs, batch_size, data_axis)
        assert got[2] == ref[2] == len(idxs)
        for g, r in zip(got[:2], ref[:2]):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
        assert len(got[0]) % data_axis == 0 and got[1].sum() == len(idxs)


@pytest.mark.parametrize("buckets", ["off", 4])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_widths_and_batches_match_jax(layout, buckets):
    """width_for, device_batch at the split's width and at each width a
    batch lands in, and host_batch, bitwise the JAX cache's."""
    port, ref = _caches(synthetic_splits(5, layout), buckets)
    assert set(port) == set(ref) == {"train", "val", "test"}
    rng = np.random.default_rng(0)
    for split, cache in port.items():
        jc = ref[split]
        assert cache.buckets == jc._buckets and (cache.t_full, cache.u_full) == (jc._t_full, jc._host_targets.shape[1])
        seen = set()
        for _ in range(12):
            idxs = [int(i) for i in rng.choice(len(cache.input_lens), size=int(rng.integers(1, 5)), replace=False)]
            width = cache.width_for(idxs)
            assert width == jc.width_for(idxs)
            seen.add(width)
            idx, mask, _ = device_cache.padded_index_row(idxs, 4)
            for t in {width, cache.t_full}:
                _equal(cache.device_batch(idx, mask, t), jc.device_batch(idx, mask, t))
            _equal(cache.host_batch(idxs), jc.host_batch(idxs))
        if buckets != "off" and split == "train":
            assert len(seen) >= 2
    if buckets == "off":
        assert all(c.buckets is None for c in port.values())


@pytest.mark.parametrize("wire,buckets", [("float32", "off"), ("float16", 4), ("bfloat16", "off"), ("float32", 4)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_gathered_epoch_equals_place(layout, wire, buckets):
    """Every batch of an epoch of each split, gathered, is bitwise what
    Trainer._place makes of the collated batch (a ragged last batch
    included), and the host batch has the collated batch's true rows."""
    splits = synthetic_splits(7, layout)
    port, _ = _caches(splits, buckets, wire)
    cfg = input_config(batch_size=4, h2d_dtype=wire)
    for split, loader in loaders(splits, Wav2Vec2CTCTokenizer(), 4, PAD, TPAD, seed=3).items():
        cache = port[split]
        trainer = placing_trainer(cache, split, cfg)
        state = loader.rng_state()
        collated = list(loader)
        loader.set_rng_state(state)
        gathered = list(cache.stream(loader.iter_index_batches(), cfg.batch_size))
        assert len(collated) == len(gathered) and len(loader.dataset) % 4
        for host, (batch, true_b, mask_total, host_b) in zip(collated, gathered):
            placed, want_b, want_total = trainer._place(host, split)
            assert true_b == want_b and mask_total is want_total is None
            assert batch.input.dtype == placed.input.dtype == device_cache.WIRE_DTYPES[wire]
            for name, g, w in zip(FIELDS, batch, placed):
                assert g.dtype == w.dtype and torch.equal(g, w), name
            assert host_b.input is None
            for name in FIELDS[2:]:
                np.testing.assert_array_equal(getattr(host_b, name), getattr(host, name), err_msg=name)
            np.testing.assert_array_equal(Wav2Vec2CTCTokenizer().batch_decode(host_b.target, group_tokens=False),
                                          Wav2Vec2CTCTokenizer().batch_decode(host.target, group_tokens=False))


@pytest.mark.parametrize("rank", [0, 1])
def test_data_parallel_rows_equal_place(rank):
    """At dp 2 (batch 3 -> 4 rows, 2 a rank) a rank's gathered rows and
    mask_total are _place's, for every batch of an epoch."""
    splits = synthetic_splits(9, sizes=(11, 5, 4))
    port, _ = _caches(splits, 4)
    cfg = input_config(batch_size=3)
    shard = DataShard(rank, 2, None)
    for split, loader in loaders(splits, Wav2Vec2CTCTokenizer(), 3, PAD, TPAD, seed=1).items():
        trainer = placing_trainer(port[split], split, cfg, shard=shard)
        state = loader.rng_state()
        collated = list(loader)
        loader.set_rng_state(state)
        gathered = list(port[split].stream(loader.iter_index_batches(), cfg.batch_size, shard))
        assert any(b.input.shape[0] < 3 for b in collated)  # a ragged batch, padded over the two ranks
        for host, (batch, true_b, mask_total, _) in zip(collated, gathered):
            placed, want_b, want_total = trainer._place(host, split)
            assert batch.input.shape[0] == 2 and (true_b, mask_total) == (want_b, want_total)
            assert mask_total == float(true_b)
            for name, g, w in zip(FIELDS, batch, placed):
                assert torch.equal(g, w), name


def test_budget_overflow_streams_and_a_failed_upload_raises(capsys, monkeypatch):
    splits = synthetic_splits(11)
    holders = {s: SimpleNamespace(dataset=d) for s, d in splits.items()}
    tok, cfg = Wav2Vec2CTCTokenizer(), _jax_config()
    caches = device_cache.build_split_caches(holders, tok, cfg, torch.device("cpu"), max_bytes=1)
    assert caches == {}
    assert "exceeds the 0 MB budget; streaming instead" in capsys.readouterr().out
    ref = jax_cache.build_split_caches(holders, JaxTokenizer(), cfg, max_bytes=1)
    assert ref == {}
    total = sum(device_cache.DeviceDatasetCache.plan(d, tok, PAD, TPAD).nbytes for d in splits.values())
    fits = device_cache.build_split_caches(holders, tok, cfg, torch.device("cpu"), max_bytes=total)
    assert set(fits) == {"train", "val", "test"}
    assert "resident on cpu: train" in capsys.readouterr().out

    def fail(self, device):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(device_cache.DeviceDatasetCache, "upload", fail)
    with pytest.raises(RuntimeError, match="uploading the train split .* failed: CUDA out of memory"):
        device_cache.build_split_caches(holders, tok, cfg, torch.device("cpu"))


def _history(exp):
    with open(os.path.join(exp.results_dir, "history.json")) as f:
        return json.load(f)


def _port(env, family, **overrides):  # noqa: F811
    cls = impl.B2TGruAndW2VConformerExperiment if family == "conformer" else impl.B2TGruAndW2VExperiment
    return cls(config(family, **overrides), YamlConfigModel(**yaml_fields(env)), device="cpu")


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_resident_trainer_equals_streamed_and_jax(env, family):  # noqa: F811
    flags = dict(device_data_cache="on", epochs=2, early_stopping_patience=None)
    jcls = jax_impl.B2TGruAndW2VConformerExperiment if family == "conformer" else jax_impl.B2TGruAndW2VExperiment
    ref_exp = jcls(config(family, results_subdir_name="jax_cached", **flags), JaxYaml(**yaml_fields(env)))
    assert set(ref_exp.get_device_caches()) == {"train", "val", "test"}
    tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), (ref_exp._merged_params(), ref_exp.model_state))
    init = bridge.params_from_jax(*jax.device_get(tree), device="cpu")
    ref_exp.run()
    ref = _history(ref_exp)

    runs = {}
    for name in ("resident", "streamed"):
        exp = _port(env, family, results_subdir_name=f"port_{name}", **flags)
        caches = exp.get_device_caches()
        assert set(caches) == set(exp.batch_widths) == {"train", "val", "test"}
        assert all(c._dev is not None and c._host_feats is None for c in caches.values())
        if name == "streamed":  # the same widths, every batch collated and placed on the host
            exp.get_device_caches = dict
        exp.adopt_params(*init)
        exp.run()
        runs[name] = (_history(exp), tree_leaves(exp.params) + tree_leaves(exp.opt_state.mu))
    (got, leaves), (streamed, streamed_leaves) = runs["resident"], runs["streamed"]
    assert got == streamed
    assert all(torch.equal(a, b) for a, b in zip(leaves, streamed_leaves))
    assert len(got["epochs"]) == len(ref["epochs"]) == 2
    pairs = [(e_got[s]["average"], e_ref[s]["average"]) for e_got, e_ref in zip(got["epochs"], ref["epochs"])
             for s in ("train", "val")] + [(got["test"]["average"], ref["test"]["average"])]
    for g, r in pairs:
        assert np.isfinite(g["loss"]) and g["loss"] > 0
        assert abs(g["loss"] - r["loss"]) <= REL * abs(r["loss"]), (g["loss"], r["loss"])
        assert g["metrics"] == r["metrics"]
    assert set(got["test"]["average"]["metrics"]) == {"word_error_rate", "char_error_rate"}


def test_grouped_chunked_epoch_visits_the_same_order_resident_and_streamed(env):  # noqa: F811
    exp = _port(env, "w2v", results_subdir_name="grouped", device_data_cache="on", multi_step_chunk=2,
                length_buckets=4, pad_to_multiple=8, batch_size=1, length_bucket_order="grouped")
    trainer = Trainer(exp)
    loader = exp.dataloader_train
    state = loader.rng_state()
    epochs = {}
    for name, caches in (("resident", trainer.caches), ("streamed", {})):
        loader.set_rng_state(state)
        trainer.caches = caches
        stream = trainer._stream_for(loader, "train", True)
        try:
            epochs[name] = list(stream)
        finally:
            stream.close()
    assert len(epochs["resident"]) == len(epochs["streamed"]) == len(loader)
    widths = []
    for (batch, true_b, _, host), (want, want_b, _, want_host) in zip(epochs["resident"], epochs["streamed"]):
        assert true_b == want_b
        np.testing.assert_array_equal(host.input_lens, want_host.input_lens)
        np.testing.assert_array_equal(host.day_idxs, want_host.day_idxs)
        for name, g, w in zip(FIELDS, batch, want):
            assert torch.equal(g, w), name
        widths.append(batch.input.shape[1])
    assert widths == sorted(widths) and len(set(widths)) >= 2
