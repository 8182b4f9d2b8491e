"""--length_bucket_order and the batch order of the epochs the JAX package
runs in K-step chunks (train/buckets.py::chunk_order, Trainer._epoch_batches),
on the CPU:

- the order: `chunk_order` is the order in which the JAX package's
  train_loop.py::_chunk_work_plan visits an epoch's batches, for random
  widths and chunk sizes, grouped and not (hypothesis);
- the rule: "auto" chunks on the card (K 32) and not on the CPU, as the
  JAX package's resolve_multi_step_chunk; a chunked epoch needs batches at
  the split's widths (--device_data_cache on);
- the runs: the tiny w2v experiment of tests/test_torch_trainer.py at
  --device_data_cache=on --multi_step_chunk=2 --length_buckets=4
  --length_bucket_order=grouped --batch_size=1 (4 train batches of 48-64
  frames over 3 bucket widths) in both packages from the same bridged
  weights: each epoch's losses within 1e-4 relative (as in
  tests/test_torch_trainer.py), every split's per-batch history in the
  same order (losses within 1e-4, and the same targets where the history
  keeps them: val and test); the port's train
  batches are sorted by width under "grouped" and in the loader's order
  under "preserve", which then trains in another order.
"""

import json
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_trainer import config, env, yaml_fields  # noqa: E402,F401

import wav2vec2forbrain_tpu.experiments.impl as jax_impl  # noqa: E402
from wav2vec2forbrain_tpu.args.yaml_config import YamlConfigModel as JaxYaml  # noqa: E402
from wav2vec2forbrain_tpu.train.train_loop import _chunk_work_plan  # noqa: E402
from wav2vec2forbrain_tpu_torch import bridge  # noqa: E402
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel  # noqa: E402
from wav2vec2forbrain_tpu_torch.experiments import impl  # noqa: E402
from wav2vec2forbrain_tpu_torch.train.buckets import chunk_order, width_for  # noqa: E402
from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer  # noqa: E402

REL = 1e-4
CHUNKED = dict(device_data_cache="on", multi_step_chunk=2, length_buckets=4, pad_to_multiple=8, batch_size=1,
               epochs=2, early_stopping_patience=None, return_best_model=False)


@settings(max_examples=200, deadline=None, database=None)
@given(widths=st.lists(st.sampled_from([48, 56, 64, 72]), max_size=40), k=st.integers(2, 9), grouped=st.booleans())
def test_chunk_order_is_the_chunk_plans(widths, k, grouped):
    rows = [(None, None, None, i) for i in range(len(widths))]
    cache = SimpleNamespace(width_for=lambda i: widths[i])
    visited = [row[3] for _, chunk, _, n_real in _chunk_work_plan(rows, k, cache, grouped) for row in chunk[:n_real]]
    assert chunk_order(widths, grouped) == visited


def _port(env, **overrides):  # noqa: F811
    return impl.B2TGruAndW2VExperiment(config("w2v", **overrides), YamlConfigModel(**yaml_fields(env)),
                                       device="cpu")


def test_chunk_size_follows_the_jax_rule(env):  # noqa: F811
    exp = _port(env, results_subdir_name="rule")
    for value, want in (("auto", 0), ("off", 0), (1, 1), (2, 2), (32, 32)):
        exp.base_config.multi_step_chunk = value
        assert exp.resolve_multi_step_chunk() == want
    exp.base_config.multi_step_chunk = "auto"
    exp.device = SimpleNamespace(type="cuda")
    assert exp.resolve_multi_step_chunk() == 32
    # no chunked epoch without batches at the split's widths (--device_data_cache=off)
    trainer = Trainer(_port(env, results_subdir_name="rule_off", multi_step_chunk=2))
    assert trainer._epoch_batches(trainer.dataloader_train, "train", True) is trainer.dataloader_train


def _history(exp):
    with open(os.path.join(exp.results_dir, "history.json")) as f:
        return json.load(f)


def _batches(hist):
    """Every split's per-batch (targets, loss), epoch by epoch, then test."""
    out = [[(h["batch"].get("targets"), h["loss"]) for h in e[s]["history"]] for e in hist["epochs"]
           for s in ("train", "val")]
    return out + [[(h["batch"].get("targets"), h["loss"]) for h in hist["test"]["history"]]]


def _train_widths(exp, grouped):
    """The widths of a chunked train epoch's batches, in the order it runs
    them; the loader's shuffle stream is put back."""
    loader = exp.dataloader_train
    state = loader.rng_state()
    widths = [width_for(exp.t_buckets["train"], int(b.input_lens.max()))
              for b in Trainer(exp)._epoch_batches(loader, "train", grouped)]
    loader.set_rng_state(state)
    return widths


def test_grouped_chunked_epochs_match_jax(env):  # noqa: F811
    ref_exp = jax_impl.B2TGruAndW2VExperiment(
        config("w2v", results_subdir_name="jax_grouped", length_bucket_order="grouped", **CHUNKED),
        JaxYaml(**yaml_fields(env)))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), (ref_exp._merged_params(), ref_exp.model_state))
    init = bridge.params_from_jax(*jax.device_get(tree), device="cpu")
    ref_exp.run()
    ref = _history(ref_exp)

    runs = {}
    for order in ("grouped", "preserve"):
        exp = _port(env, results_subdir_name=f"port_{order}", length_bucket_order=order, **CHUNKED)
        exp.adopt_params(*init)
        assert len(set(exp.t_buckets["train"])) >= 2
        widths = _train_widths(exp, order == "grouped")
        exp.run()
        runs[order] = (_history(exp), widths)
    got, grouped_widths = runs["grouped"]
    assert grouped_widths == sorted(grouped_widths) and len(set(grouped_widths)) >= 2
    assert len(got["epochs"]) == len(ref["epochs"]) == 2
    for e_got, e_ref in zip(got["epochs"], ref["epochs"]):
        for split in ("train", "val"):
            g, r = e_got[split]["average"], e_ref[split]["average"]
            assert np.isfinite(g["loss"]) and abs(g["loss"] - r["loss"]) <= REL * abs(r["loss"]), (split, g, r)
            assert g["metrics"] == r["metrics"]
    for b_got, b_ref in zip(_batches(got), _batches(ref)):
        assert [t for t, _ in b_got] == [t for t, _ in b_ref]
        assert all(abs(g - r) <= REL * abs(r) for (_, g), (_, r) in zip(b_got, b_ref))
    # "preserve" keeps the loader's order, here another one: the train steps run in another order
    preserved, preserve_widths = runs["preserve"]
    assert preserve_widths != grouped_widths and sorted(preserve_widths) == grouped_widths
    assert [loss for _, loss in _batches(preserved)[0]] != [loss for _, loss in _batches(got)[0]]
