"""The port's host prefetch thread (--host_prefetch: train/train_loop.py::
_HostPrefetcher, _batch_stream, Trainer._stream_for), on the CPU, and the
input path's two halves on a card (`cuda`).

- the Trainer (the tiny encoders of tests/test_torch_trainer.py, both
  families, streamed): epoch histories and final params bitwise with
  --host_prefetch true and false;
- a worker's error (in the loader or in the placement) is raised on the
  consumer; a consumer that stops early, or whose train step raises,
  leaves no live worker thread (every wait bounded by join(timeout=...));
- a --resume_train_state run under prefetch equals a straight run, and
  every train-state checkpoint is written after its epoch's worker ended;
- `cuda`: every gathered batch of a resident split equals _place's batch
  of the collated batch bitwise on the card, with and without buckets
  and at each wire dtype; a batch the prefetch worker copied on its own
  stream, read by the step's stream right after the handoff (the copy held
  back behind a spin on the copy stream), equals the batch placed inline.

jax is imported only inside the CPU tests' fixture: the `cuda` tests run
where jax is not installed.
"""

import json
import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from torch_input_fixtures import LAYOUTS, input_config, loaders, placing_trainer, synthetic_splits  # noqa: E402

from wav2vec2forbrain_tpu_torch.args.flags import PRETRAINED_LATENT_SIZES  # noqa: E402
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel  # noqa: E402
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer  # noqa: E402
from wav2vec2forbrain_tpu_torch.experiments import impl  # noqa: E402
from wav2vec2forbrain_tpu_torch.models import pretrained  # noqa: E402
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig  # noqa: E402
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig  # noqa: E402
from wav2vec2forbrain_tpu_torch.train import device_cache, train_loop  # noqa: E402
from wav2vec2forbrain_tpu_torch.tree import tree_leaves  # noqa: E402

JOIN_S = 10.0
FIELDS = ("input", "target", "day_idxs", "input_lens", "target_lens", "sample_mask")


def _workers():
    return [t for t in threading.enumerate() if t.name == "host-prefetch"]


def _no_live_worker():
    for t in _workers():
        t.join(timeout=JOIN_S)
    return not any(t.is_alive() for t in _workers())


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """(tmp dir, tests/test_torch_trainer.py) with the port's checkpoints
    resolved to the tiny encoders, as that file's fixture does."""
    import test_torch_trainer as tt  # imports jax: the CPU tests only

    tmp = tmp_path_factory.mktemp("prefetch")
    tt.make_splits(str(tmp / "t12"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pretrained, "encoder_config_for_checkpoint",
                   lambda c: tt._tiny(c, ConformerEncoderConfig, Wav2Vec2EncoderConfig))
        for ckpt in (tt.W2V_CKPT, tt.CONF_CKPT):
            mp.setitem(PRETRAINED_LATENT_SIZES, ckpt, 96)
        yield tmp, tt


def _experiment(env, family, **overrides):
    tmp, tt = env
    cls = impl.B2TGruAndW2VConformerExperiment if family == "conformer" else impl.B2TGruAndW2VExperiment
    return cls(tt.config(family, **overrides), YamlConfigModel(**tt.yaml_fields(tmp)), device="cpu")


def _history(exp):
    with open(os.path.join(exp.results_dir, "history.json")) as f:
        return json.load(f)


@pytest.fixture
def counted(monkeypatch):
    """The number of prefetch workers started while the test runs."""
    started = []

    class Counted(train_loop._HostPrefetcher):
        def __init__(self, *args, **kwargs):
            started.append(1)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(train_loop, "_HostPrefetcher", Counted)
    return started


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_prefetched_runs_equal_inline_runs(env, family, counted):
    runs = {}
    for prefetch in (True, False):
        before = len(counted)
        exp = _experiment(env, family, results_subdir_name=f"prefetch_{prefetch}", host_prefetch=prefetch, epochs=2,
                          early_stopping_patience=None, train_on_val_once=True)
        assert exp.get_device_caches() == {}
        exp.run()
        # 2 train, 2 val, 1 train-on-val and 1 test epoch, each on its own worker (none inline)
        assert len(counted) - before == (6 if prefetch else 0)
        runs[prefetch] = (_history(exp), tree_leaves(exp.params) + tree_leaves(exp.opt_state.mu))
    assert runs[True][0] == runs[False][0] and len(runs[True][0]["epochs"]) == 2
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))
    assert _no_live_worker()


def _place_fn(split, cfg, fail_at=None):
    splits = synthetic_splits(2)
    caches = device_cache.build_split_caches(
        {s: SimpleNamespace(dataset=d) for s, d in splits.items()}, Wav2Vec2CTCTokenizer(), cfg,
        torch.device("cpu"), verbose=False)
    trainer = placing_trainer(caches[split], split, cfg)
    calls = []

    def place(host_batch, stream):
        calls.append(1)
        if fail_at is not None and len(calls) == fail_at:
            raise ValueError("placement failed")
        return trainer._place(host_batch, split, stream)

    loader = loaders(splits, Wav2Vec2CTCTokenizer(), cfg.batch_size)[split]
    return place, loader


@pytest.mark.parametrize("where", ["loader", "place"])
def test_a_worker_error_is_raised_on_the_consumer(where):
    cfg = input_config(batch_size=3)
    place, loader = _place_fn("train", cfg, fail_at=3 if where == "place" else None)

    def batches():
        for i, b in enumerate(loader):
            if where == "loader" and i == 2:
                raise ValueError("collate failed")
            yield b

    stream = train_loop._batch_stream(batches(), place, True, torch.device("cpu"))
    got = []
    with pytest.raises(ValueError, match="failed"):
        for item in stream:
            got.append(item)
    assert len(got) == 2
    stream._thread.join(timeout=JOIN_S)
    assert not stream._thread.is_alive()
    with pytest.raises(StopIteration):  # a finished stream stays finished
        next(stream)


def test_a_consumer_that_stops_early_leaves_no_live_worker():
    """An endless loader: the worker fills the queue of 2 and waits in its
    bounded put; close() stops it."""
    cfg = input_config(batch_size=3)
    place, loader = _place_fn("train", cfg)
    host = next(iter(loader))

    def endless():
        while True:
            yield host

    stream = train_loop._batch_stream(endless(), place, True, torch.device("cpu"))
    batch, true_b, mask_total, _ = next(stream)
    assert true_b == 3 and mask_total is None and batch.input.shape[0] == 3
    stream.close()
    stream._thread.join(timeout=JOIN_S)
    assert not stream._thread.is_alive()


def test_a_train_step_that_raises_leaves_no_live_worker(env, counted):
    exp = _experiment(env, "w2v", results_subdir_name="raises", host_prefetch=True)
    trainer = train_loop.Trainer(exp)
    step, calls = trainer.train_step, []

    def failing_step(*args):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("the step failed")
        return step(*args)

    trainer.train_step = failing_step
    with pytest.raises(RuntimeError, match="the step failed"):
        trainer._train_epoch(exp.dataloader_val, 0, split="val")  # 3 batches: the worker is ahead
    assert len(counted) == 1 and len(calls) == 2
    assert _no_live_worker()


def test_resume_under_prefetch_equals_a_straight_run(env, counted, monkeypatch):
    save = train_loop.Trainer._save_train_state
    live_at_save = []

    def checked(self, *args):
        live_at_save.append(any(t.is_alive() for t in _workers()))
        return save(self, *args)

    monkeypatch.setattr(train_loop.Trainer, "_save_train_state", checked)
    common = dict(epochs=2, return_best_model=False, early_stopping_patience=None, checkpoint_every_n_epochs=1,
                  host_prefetch=True)
    straight = _experiment(env, "w2v", results_subdir_name="pf_straight", **common)
    straight.run()
    first = _experiment(env, "w2v", results_subdir_name="pf_first", **dict(common, epochs=1))
    first.run()
    state_dir = os.path.join(first.results_dir, "train_state")
    resumed = _experiment(env, "w2v", results_subdir_name="pf_resumed", resume_train_state=state_dir, **common)
    resumed.run()
    assert len(counted) >= 9 and live_at_save == [False] * 4
    a, b = _history(straight), _history(resumed)
    assert len(a["epochs"]) == len(b["epochs"]) == 2
    assert a["epochs"] == b["epochs"] and a["test"] == b["test"]
    for x, y in zip(tree_leaves(straight.params) + tree_leaves(straight.opt_state.mu),
                    tree_leaves(resumed.params) + tree_leaves(resumed.opt_state.mu)):
        assert torch.equal(x, y)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wire,buckets", [("float32", "off"), ("float32", 4), ("bfloat16", 4), ("float16", "off")])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_cuda_gathered_batches_equal_place(layout, wire, buckets):
    dev = _cuda()
    splits = synthetic_splits(7, layout, sizes=(70, 24, 10))
    cfg = input_config(batch_size=8, pad_to_multiple=8, target_pad_to_multiple=4, h2d_dtype=wire,
                       length_buckets=buckets, preprocessing=layout)
    holders = {s: SimpleNamespace(dataset=d) for s, d in splits.items()}
    caches = device_cache.build_split_caches(holders, Wav2Vec2CTCTokenizer(), cfg, dev, verbose=False)
    for split, loader in loaders(splits, Wav2Vec2CTCTokenizer(), 8, 8, 4, seed=5).items():
        cache = caches[split]
        assert cache._dev[0].is_cuda and cache.upload_s is not None
        trainer = placing_trainer(cache, split, cfg, dev)
        state = loader.rng_state()
        collated = list(loader)
        loader.set_rng_state(state)
        stream = cache.stream(loader.iter_index_batches(), cfg.batch_size)
        n = 0
        for host, (batch, true_b, _, host_b) in zip(collated, stream):
            placed, want_b, _ = trainer._place(host, split)
            assert true_b == want_b
            for name, g, w in zip(FIELDS, batch, placed):
                assert g.is_cuda and g.dtype == w.dtype and torch.equal(g, w), name
            np.testing.assert_array_equal(host_b.input_lens, host.input_lens)
            n += 1
        assert n == len(collated) == len(loader)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_cuda_prefetched_batch_read_at_the_handoff_equals_inline(wire):
    dev = _cuda()
    splits = synthetic_splits(8, sizes=(40, 8, 8))
    cfg = input_config(batch_size=8, pad_to_multiple=8, h2d_dtype=wire)
    holders = {s: SimpleNamespace(dataset=d) for s, d in splits.items()}
    caches = device_cache.build_split_caches(holders, Wav2Vec2CTCTokenizer(), cfg, torch.device("cpu"),
                                             verbose=False)
    trainer = placing_trainer(caches["train"], "train", cfg, dev)
    loader = loaders(splits, Wav2Vec2CTCTokenizer(), 8, 8)["train"]
    hosts = list(loader)

    def place(host_batch, stream):
        if stream is not None:  # hold the copies back: without the event wait the step would read them early
            with torch.cuda.stream(stream):
                torch.cuda._sleep(20_000_000)
        return trainer._place(host_batch, "train", stream)

    stream = train_loop._batch_stream(iter(hosts), place, True, dev)
    got = []
    try:
        for batch, true_b, _, host in stream:
            got.append(([t.clone() for t in batch], true_b, host))  # read on the step's stream at once
    finally:
        stream.close()
    assert len(got) == len(hosts)
    for (batch, true_b, host), want_host in zip(got, hosts):
        want, want_b, _ = trainer._place(want_host, "train")
        assert true_b == want_b and host is want_host
        for name, g, w in zip(FIELDS, batch, want):
            assert g.is_cuda and torch.equal(g, w), name
