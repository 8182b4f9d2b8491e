"""The train state crosses between the JAX package and the port
(train/jax_train_state.py, Trainer.restore_train_state, `convert
train-state`), on the CPU, for both families at tests/test_torch_trainer.py's
size (tiny encoders, biGRU 2 x 32, batch 3):

(a) the flat order of the optax state's leaves, rebuilt without jax
    (`opt_leaf_layout`), is jax.tree_util.tree_flatten's of the JAX
    make_optimizer state on the bridged params tree (paths, shapes,
    dtypes): both families, Adam at weight decay 0 and 1e-2, SGD,
    unfreeze brain_encoder+w2v and brain_encoder, per layer and
    scan-stacked;
(b) JAX -> port: a JAX run checkpoints after epoch 1; the port resumes its
    state.msgpack with the params, BN state, Adam moments and count (read
    by the JAX Trainer's own restore, bridged), epoch and history bitwise
    the bundle's, and its epoch 2 train and val losses are within 1e-4
    relative of the JAX run resumed from the same file, WER and CER equal;
(c) port -> JAX: a port state.pt, converted, resumes in the JAX Trainer
    bitwise (the restored trees against the state.pt's); the step key
    written is PRNGKey(seed + 1)'s raw data under "rbg"; the JAX run's
    epoch 2 matches the port resumed from the same msgpack within 1e-4;
(d) a scan-stacked JAX state (a JAX run at --scan_layers) resumes per
    layer in the port, bitwise.

Tolerances: the restored leaves bitwise; the losses 1e-4 relative, as in
tests/test_torch_trainer.py (Adam eps 1e-4, so a gradient that differs by
summation order d moves a param by at most lr * d / eps). Noise, dropout
and LayerDrop are off: the step keys do not cross, so the two packages'
random streams differ. The JAX side runs under "rbg", the PRNG its
experiments set (util/tpu_setup.py::configure_jax), pinned for this module
so that the file's result does not depend on what ran before it.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_trainer import FAMILIES, config, env, yaml_fields  # noqa: E402,F401
from torch_jax_prng import jax_rbg, pinned_prng  # noqa: E402,F401

import wav2vec2forbrain_tpu.experiments.impl as jax_impl  # noqa: E402
from wav2vec2forbrain_tpu.args.yaml_config import YamlConfigModel as JaxYaml  # noqa: E402
from wav2vec2forbrain_tpu.models import assembly as jax_assembly  # noqa: E402
from wav2vec2forbrain_tpu.models.conformer import ConformerEncoderConfig as JaxConformerConfig  # noqa: E402
from wav2vec2forbrain_tpu.models.wav2vec2 import Wav2Vec2EncoderConfig as JaxW2VConfig  # noqa: E402
from wav2vec2forbrain_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from wav2vec2forbrain_tpu.train.steps import merge_params, partition_params, prune_labels  # noqa: E402
from wav2vec2forbrain_tpu.train.train_loop import Trainer as JaxTrainer  # noqa: E402
from wav2vec2forbrain_tpu_torch import bridge, convert  # noqa: E402
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel  # noqa: E402
from wav2vec2forbrain_tpu_torch.experiments import impl  # noqa: E402
from wav2vec2forbrain_tpu_torch.models.assembly import param_labels  # noqa: E402
from wav2vec2forbrain_tpu_torch.train import jax_train_state as jts  # noqa: E402
from wav2vec2forbrain_tpu_torch.train.msgpack_codec import relistify  # noqa: E402
from wav2vec2forbrain_tpu_torch.train.optim import AdamState  # noqa: E402
from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer, train_state_file  # noqa: E402
from wav2vec2forbrain_tpu_torch.tree import tree_leaves_with_path, tree_map  # noqa: E402

torch.set_num_threads(2)
REL = 1e-4
RESUME = dict(checkpoint_every_n_epochs=1, early_stopping_patience=None, return_best_model=False)


# --- (a) the leaf order -------------------------------------------------------------


def _jax_params(family, scan_layers):
    enc = (dict(encoder_family="conformer", conformer_cfg=JaxConformerConfig.tiny_test(hidden_act="swish"))
           if family == "conformer" else dict(encoder_family="wav2vec2", w2v_cfg=JaxW2VConfig.tiny_test()))
    spec = jax_assembly.ModelSpec(gru_hidden_size=32, gru_num_layers=2, latent_size=96, scan_layers=scan_layers,
                                  **enc)
    with pinned_prng():
        params, state = jax_assembly.init_model_params(jax.random.PRNGKey(0), spec)
    return jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, state)


def _key(entry):
    for field in ("key", "idx", "name"):
        if hasattr(entry, field):
            return getattr(entry, field)
    raise TypeError(entry)


def _jax_leaves(params, strategy, optimizer, weight_decay):
    """(group, field, params path, shape, dtype) of each leaf of the JAX
    make_optimizer state over the trainable tree, in flatten order."""
    labels = jax_assembly.param_labels(params, strategy)
    trainable, _ = partition_params(params, labels)
    tx = jax_make_optimizer(prune_labels(labels, trainable), optimizer, weight_decay)
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tx.init(trainable))[0]:
        keys = [_key(e) for e in path]
        assert keys[:3] == ["inner_states", keys[1], "inner_state"], keys
        field = keys[4] if keys[4] in ("count", "mu", "nu") else keys[5]
        rest = keys[keys.index(field) + 1:]
        out.append((keys[1], field, tuple(rest) or None, tuple(np.shape(leaf)), str(np.asarray(leaf).dtype)))
    return out


@pytest.mark.parametrize("stacked", [False, True], ids=["per_layer", "scan_stacked"])
@pytest.mark.parametrize("strategy", ["brain_encoder+w2v", "brain_encoder"])
@pytest.mark.parametrize("optimizer,weight_decay", [("adam", 0.0), ("adam", 1e-2), ("sgd", 0.0)])
@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_opt_leaf_layout_is_tree_flatten_order(family, optimizer, weight_decay, strategy, stacked):
    params, state = _jax_params(family, stacked)
    want = _jax_leaves(params, strategy, optimizer, weight_decay)
    # the port's per-layer tree, bridged, in the JAX run's layout
    port, _ = bridge.params_from_jax(*_jax_params(family, False), device="cpu")
    layout_tree = bridge.stack_encoder(port, {})[0] if stacked else port
    got = []
    for group, field, path in jts.opt_leaf_layout(layout_tree, param_labels(layout_tree, strategy), optimizer):
        if field == "count":
            got.append((group, field, None, (), "int32"))
        else:
            leaf = jts._get(layout_tree, path)
            got.append((group, field, path, tuple(leaf.shape), str(leaf.dtype).split(".")[1]))
    assert got == want
    assert (len(want) == 0) == (optimizer == "sgd")
    if optimizer == "adam":  # a group with no trained leaf still has its count
        assert [g for g, f, *_ in want if f == "count"] == ["brain", "w2v"]


# --- the runs ----------------------------------------------------------------------------


def _jax_experiment(env, family, **overrides):  # noqa: F811
    cls = jax_impl.B2TGruAndW2VConformerExperiment if family == "conformer" else jax_impl.B2TGruAndW2VExperiment
    return cls(config(family, **overrides), JaxYaml(**yaml_fields(env)))


def _port_experiment(env, family, **overrides):  # noqa: F811
    cls = impl.B2TGruAndW2VConformerExperiment if family == "conformer" else impl.B2TGruAndW2VExperiment
    return cls(config(family, **overrides), YamlConfigModel(**yaml_fields(env)), device="cpu")


def _history(exp):
    with open(os.path.join(exp.results_dir, "history.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_states(env):  # noqa: F811
    """(family, scan_layers) -> the train_state/ of a JAX run of one epoch,
    each made once."""
    made = {}

    def state(family, scan_layers=False):
        key = (family, scan_layers)
        if key not in made:
            exp = _jax_experiment(env, family, epochs=1, scan_layers=scan_layers,
                                  results_subdir_name=f"jax1_{family}_{scan_layers}", **RESUME)
            exp.run()
            made[key] = os.path.join(exp.results_dir, "train_state")
        return made[key]

    return state


def _flax_bundle(path):
    """A state.msgpack read by flax itself, lists restored, encoder per layer."""
    with open(path, "rb") as f:
        bundle = relistify(serialization.msgpack_restore(f.read()))
    params, state = bridge.unstack_encoder(bundle["params"], bundle["state"])
    return bundle, params, state


def _assert_tree_bitwise(port_tree, ref_tree):
    """Every port tensor bitwise the numpy reference (the same structure)."""
    got, want = dict(tree_leaves_with_path(port_tree)), dict(tree_leaves_with_path(ref_tree))
    assert got.keys() == want.keys()
    for path, t in got.items():
        ref = np.asarray(want[path])
        assert str(t.dtype).split(".")[1] == ref.dtype.name, path
        np.testing.assert_array_equal(t.float().numpy(), ref.astype(np.float32), err_msg=path)


def _jax_restored(jexp, path):
    """The JAX Trainer's own restore of `path`: (params, BN state, optax
    state) as numpy trees, the encoder per layer."""
    trainer = JaxTrainer(jexp)
    epoch, history = trainer.restore_train_state(path)
    params = merge_params(jax.device_get(trainer.trainable), jax.device_get(trainer.frozen))
    tree = jax.tree_util.tree_map(np.asarray, (params, jax.device_get(trainer.model_state)))
    return epoch, history, tree, jax.device_get(trainer.opt_state), np.asarray(trainer.rng)


def _epoch_losses(hist, epoch):
    e = hist["epochs"][epoch]
    return {split: (e[split]["average"]["loss"], e[split]["average"]["metrics"]) for split in ("train", "val")}


def _assert_epoch_close(got, ref):
    for split in ("train", "val"):
        (g, gm), (r, rm) = got[split], ref[split]
        assert np.isfinite(g) and abs(g - r) <= REL * abs(r), (split, g, r)
        assert gm == rm, (split, gm, rm)


def _assert_opt_bitwise(port_opt, jax_opt, params):
    ref = bridge.opt_state_from_jax(jax_opt, params, device="cpu")
    assert port_opt.count == ref.count
    for name in ("mu", "nu"):
        got, want = dict(tree_leaves_with_path(getattr(port_opt, name))), dict(tree_leaves_with_path(getattr(ref, name)))
        assert got.keys() == want.keys() and got
        for path, t in got.items():
            assert torch.equal(t, want[path]), (name, path)


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_jax_state_resumes_in_the_port(env, jax_states, family):  # noqa: F811
    """(b): restored bitwise, then epoch 2 against the JAX run resumed from
    the same file."""
    state_dir = jax_states(family)
    msgpack = os.path.join(state_dir, "state.msgpack")
    bundle, bparams, bstate = _flax_bundle(msgpack)

    port = _port_experiment(env, family, epochs=2, resume_train_state=state_dir, results_subdir_name="port_b",
                            **RESUME)
    trainer = Trainer(port)
    epoch, history = trainer.restore_train_state(state_dir)
    assert epoch == int(bundle["epoch"]) + 1 == 1
    _assert_tree_bitwise(trainer.params, bparams)
    _assert_tree_bitwise(trainer.model_state, bstate)
    jexp = _jax_experiment(env, family, epochs=2, resume_train_state=state_dir, results_subdir_name="jax_b",
                           **RESUME)
    jepoch, jhistory, _, jopt, _ = _jax_restored(jexp, state_dir)
    assert jepoch == epoch and [e.to_dict() for e in history] == [e.to_dict() for e in jhistory]
    _assert_opt_bitwise(trainer.opt_state, jopt, trainer.params)
    assert trainer.opt_state.count == 2  # 4 train samples at batch 3: two steps

    port.run()
    jexp.run()
    got, ref = _history(port), _history(jexp)
    assert len(got["epochs"]) == len(ref["epochs"]) == 2
    assert got["epochs"][0] == ref["epochs"][0]  # epoch 1: history.json beside the state
    _assert_epoch_close(_epoch_losses(got, 1), _epoch_losses(ref, 1))


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_port_state_converts_and_resumes_in_jax(env, tmp_path, family):  # noqa: F811
    """(c): `convert train-state`, then the JAX Trainer's restore is the
    state.pt bitwise; epoch 2 of the JAX run against the port's from the
    same msgpack."""
    first = _port_experiment(env, family, epochs=1, results_subdir_name="port_c1", **RESUME)
    first.run()
    src = os.path.join(first.results_dir, "train_state")
    out = tmp_path / f"jax_{family}"
    convert.main(["train-state", src, str(out)])
    assert sorted(os.listdir(out)) == ["history.json", "state.msgpack"]
    saved = torch.load(os.path.join(src, "state.pt"), weights_only=True)

    jexp = _jax_experiment(env, family, epochs=2, resume_train_state=str(out), results_subdir_name="jax_c",
                           **RESUME)
    epoch, _, (jparams, jstate), jopt, key = _jax_restored(jexp, str(out))
    assert epoch == saved["epoch"] + 1 == 1
    _assert_tree_bitwise(saved["params"], jparams)
    _assert_tree_bitwise(saved["state"], jstate)
    _assert_opt_bitwise(AdamState(**saved["opt"]), jopt, saved["params"])
    seed = config(family)["seed"]
    with pinned_prng("rbg"):
        want_key = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed + 1)))
    np.testing.assert_array_equal(key, want_key)
    np.testing.assert_array_equal(jts.jax_step_key(seed), want_key)

    port = _port_experiment(env, family, epochs=2, resume_train_state=str(out / "state.msgpack"),
                            results_subdir_name="port_c2", **RESUME)
    port.run()
    jexp.run()
    _assert_epoch_close(_epoch_losses(_history(port), 1), _epoch_losses(_history(jexp), 1))


def test_scan_stacked_jax_state_resumes_per_layer(env, jax_states):  # noqa: F811
    """(d): the w2v family's JAX run at --scan_layers."""
    state_dir = jax_states("w2v", scan_layers=True)
    bundle, bparams, bstate = _flax_bundle(os.path.join(state_dir, "state.msgpack"))
    assert "layers_stacked" in bundle["params"]["w2v"]["encoder"]
    port = _port_experiment(env, "w2v", epochs=2, resume_train_state=state_dir, results_subdir_name="port_d",
                            **RESUME)
    trainer = Trainer(port)
    trainer.restore_train_state(state_dir)
    assert isinstance(trainer.params["w2v"]["encoder"]["layers"], list)
    _assert_tree_bitwise(trainer.params, bparams)
    jexp = _jax_experiment(env, "w2v", epochs=2, scan_layers=True, results_subdir_name="jax_d", **RESUME)
    _, _, _, jopt, _ = _jax_restored(jexp, state_dir)
    ref_params, _ = bridge.params_from_jax(*jax.tree_util.tree_map(np.asarray, (bparams, bstate)), device="cpu")
    stacked_opt = bridge.opt_state_from_jax(jopt, bridge.stack_encoder(ref_params, {})[0], device="cpu")
    for name in ("mu", "nu"):
        got = dict(tree_leaves_with_path(bridge.stack_encoder(getattr(trainer.opt_state, name), {})[0]))
        want = dict(tree_leaves_with_path(getattr(stacked_opt, name)))
        assert got.keys() == want.keys() and got
        assert all(torch.equal(t, want[p]) for p, t in got.items()), name
    port.run()
    assert all(np.isfinite(e[s]["average"]["loss"]) for e in _history(port)["epochs"] for s in ("train", "val"))


def test_bf16_moments_and_a_directory_with_both_files(tmp_path):
    """--adam_mu_dtype / --adam_nu_dtype bf16 moments cross bitwise (written
    by the port, read by flax and by the port); a directory with both a
    state.pt and a state.msgpack is refused, naming both."""
    port, state = bridge.params_from_jax(*_jax_params("w2v", False), device="cpu")
    labels = param_labels(port, "brain_encoder+w2v")
    gen = torch.Generator().manual_seed(3)

    def moment(p, label):
        return None if label == "frozen" else torch.randn(p.shape, generator=gen).to(torch.bfloat16)

    opt = {"count": 7, "mu": tree_map(moment, port, labels), "nu": tree_map(moment, port, labels)}
    path = str(tmp_path / "state.msgpack")
    jts.write_jax_train_state(path, port, state, opt, 4, 0, "brain_encoder+w2v", "adam", stacked=True)
    back = jts.read_jax_train_state(path, "brain_encoder+w2v", "adam")
    assert back["epoch"] == 4 and back["opt"]["count"] == 7
    for name in ("mu", "nu"):
        got, want = dict(tree_leaves_with_path(back["opt"][name])), dict(tree_leaves_with_path(opt[name]))
        assert got.keys() == want.keys()
        assert all(t.dtype == torch.bfloat16 and torch.equal(t, want[p]) for p, t in got.items())
    with open(path, "rb") as f:
        flax_leaves = relistify(serialization.msgpack_restore(f.read()))["opt_leaves"]
    stacked = bridge.stack_encoder(port, {})[0]
    layout = jts.opt_leaf_layout(stacked, param_labels(stacked, "brain_encoder+w2v"), "adam")
    assert len(flax_leaves) == len(layout)
    assert all(str(np.asarray(leaf).dtype) == ("int32" if f == "count" else "bfloat16")
               for leaf, (_, f, _) in zip(flax_leaves, layout))
    torch.save({}, tmp_path / "state.pt")
    with pytest.raises(ValueError, match="state.pt.*state.msgpack"):
        train_state_file(str(tmp_path))
    assert train_state_file(path) == path
