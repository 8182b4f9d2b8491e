"""The port's CLI under tensor parallelism (--mesh_model_parallel=2) on gloo
ranks against the JAX package's ('data', 'model') = (2, 2) experiment, on
the CPU, for both families.

The JAX experiment runs one epoch on a (2, 2) mesh of conftest's virtual
devices (tests/test_train_e2e.py's test_model_parallel_mesh_run); its
initial weights, bridged to the port's checkpoint format, start four ranks
of the port's `run.main(argv, device="cpu")` at (2, 2) under torchrun's
environment (subprocesses with a time limit, as tests/test_torch_dp_train.py
runs them; the conformer with ZeRO-1 moments too). The fixture and the
flags are tests/test_torch_trainer.py's (tiny encoders of 4 heads, biGRU
2 x 32, batch 3 padded to 4, dropout off, Adam eps 1e-4), so:

- the epoch's train and val losses and the test loss agree with the JAX
  run's within 2e-4 relative (JAX's own bound for its (2, 2) run), and WER
  and CER are equal;
- rank 0 alone wrote files; model.pt holds the whole tree;
- --only_test --from_checkpoint under the split reproduces the test loss;
- the train state is whole: a one-process experiment resumes it with every
  leaf bitwise the file's, and every rank's pieces are their slices of it;
  converted to the JAX package's state.msgpack, it resumes at (2, 2) for a
  second epoch, and the JAX Trainer restores it on its (2, 2) mesh bitwise;
- a one-process run's state.pt resumes at (1, 2) on two more ranks, each
  holding bitwise its slices of the file.
The JAX runs go on in this process while the ranks run.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import wav2vec2forbrain_tpu.experiments.impl as jax_impl
from test_torch_dp_train import _argv, _history
from test_torch_parallel import start_ranks, wait_ranks
from test_torch_trainer import NO_DROPOUT, config, env, port_run, yaml_fields  # noqa: F401
from wav2vec2forbrain_tpu.args.yaml_config import YamlConfigModel as JaxYaml
from wav2vec2forbrain_tpu_torch import bridge
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel
from wav2vec2forbrain_tpu_torch.experiments import impl
from wav2vec2forbrain_tpu_torch.parallel.tensor import split_dim
from wav2vec2forbrain_tpu_torch.parallel.zero import zero1_dim
from wav2vec2forbrain_tpu_torch.train.checkpoint import load_tree, save_checkpoint
from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer
from wav2vec2forbrain_tpu_torch.tree import tree_leaves_with_path
from torch_jax_prng import jax_rbg  # noqa: F401

FAMILIES = ("conformer", "w2v")
REL = 2e-4

# one rank of a gloo group of `world`: the tiny encoders of
# tests/test_torch_trainer.py, then the jobs in turn. A job runs the CLI
# ("run"), converts a train state to the JAX package's format on rank 0
# ("convert"), or restores a train state into a new experiment and dumps
# this rank's pieces ("restore"); "{name}" in a job's strings is that
# earlier job's results dir. Every path opened for writing inside a job
# (open, torch.save) is listed in written_<rank>.json.
CHILD = r"""
import builtins, json, os, sys
import torch

torch.set_num_threads(1)
rank, port, world, work, jobs = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4], json.loads(sys.argv[5])
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                  MASTER_PORT=port)

from wav2vec2forbrain_tpu_torch import run
from wav2vec2forbrain_tpu_torch.args.argparsing import get_experiment_from_args
from wav2vec2forbrain_tpu_torch.args.flags import PRETRAINED_LATENT_SIZES
from wav2vec2forbrain_tpu_torch.convert import convert_train_state
from wav2vec2forbrain_tpu_torch.models import pretrained
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig
from wav2vec2forbrain_tpu_torch.parallel import distributed
from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer

NO_DROPOUT = json.loads(sys.argv[6])
for ckpt in list(PRETRAINED_LATENT_SIZES):
    PRETRAINED_LATENT_SIZES[ckpt] = 96


def tiny(checkpoint):
    if "conformer" in checkpoint:
        return "conformer", ConformerEncoderConfig.tiny_test(conformer_conv_dropout=0.0, hidden_act="swish",
                                                             **NO_DROPOUT)
    return "wav2vec2", Wav2Vec2EncoderConfig.tiny_test(**NO_DROPOUT)


pretrained.encoder_config_for_checkpoint = tiny
written = []
_open, _save = builtins.open, torch.save


def open_(file, mode="r", *a, **k):
    if any(c in mode for c in "wax+"):
        written.append(str(file))
    return _open(file, mode, *a, **k)


def save_(obj, f, *a, **k):
    written.append(str(f))
    return _save(obj, f, *a, **k)


def pieces(exp_or_trainer, name):
    builtins.open, torch.save = _open, _save
    torch.save({"params": exp_or_trainer.params, "mu": exp_or_trainer.opt_state.mu},
               os.path.join(work, f"pieces_{name}_{rank}.pt"))
    builtins.open, torch.save = open_, save_


os.chdir(work)
results = {}
builtins.open, torch.save = open_, save_
for name, kind, argv in jobs:
    argv = [a.format(**results) for a in argv]
    if kind == "run":
        exp = run.main(argv, device="cpu")
        assert exp.shard.model is not None and exp.shard.model.size == 2
        assert (exp.shard.rank, exp.shard.model.rank) == divmod(rank, 2)
        results[name] = exp.results_dir
        pieces(exp, name)
    elif kind == "convert":
        if distributed.is_coordinator():
            convert_train_state(argv[0], argv[1])
        distributed.barrier("converted")
    else:
        exp = get_experiment_from_args(argv[1:], device="cpu")
        trainer = Trainer(exp)
        start, history = trainer.restore_train_state(argv[0])
        assert start == 1 and len(history) == 1
        pieces(trainer, name)
builtins.open, torch.save = _open, _save
with open(os.path.join(work, f"written_{rank}.json"), "w") as f:
    json.dump({"written": written, "results": results}, f)
import torch.distributed as dist
dist.destroy_process_group()
"""


def _flags(family, **overrides):
    return _argv(config(family, **dict(dict(epochs=1, mesh_data_parallel=0, mesh_model_parallel=2), **overrides)))


@pytest.fixture(scope="module")
def runs(env):  # noqa: F811
    """family -> JAX (2, 2) history; the ranks' written files, results dirs
    and pieces; the one-process state the (1, 2) ranks resumed."""
    work = env / "tp"
    work.mkdir()
    with open(work / "config.yaml", "w") as f:
        f.write("".join(f"{k}: {v}\n" for k, v in yaml_fields(env).items()))
    jax_exps, jobs = {}, []
    for family in FAMILIES:
        cls = (jax_impl.B2TGruAndW2VConformerExperiment if family == "conformer"
               else jax_impl.B2TGruAndW2VExperiment)
        exp = cls(config(family, epochs=1, mesh_data_parallel=2, mesh_model_parallel=2, results_subdir_name="jax"),
                  JaxYaml(**yaml_fields(env)))
        assert exp.mesh.shape == {"data": 2, "model": 2}
        tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), (exp._merged_params(), exp.model_state))
        init = str(work / f"init_{family}.pt")
        save_checkpoint(init, *bridge.params_from_jax(*jax.device_get(tree), device="cpu"))
        jax_exps[family] = exp
        zero1 = ["--optimizer_state_sharding=zero1"] if family == "conformer" else []
        train = f"train_{family}"
        jobs += [
            (train, "run", _flags(family, results_subdir_name=f"tp_{family}", checkpoint_every_n_epochs=1)
             + zero1 + [f"--from_checkpoint={init}"]),
            (f"only_test_{family}", "run", _flags(family, results_subdir_name=f"tp_only_{family}", only_test=True)
             + [f"--from_checkpoint={{{train}}}/model.pt"]),
            (f"convert_{family}", "convert", [f"{{{train}}}/train_state", str(work / f"jax_state_{family}")]),
            (f"resume_{family}", "run", _flags(family, results_subdir_name=f"tp_resume_{family}", epochs=2)
             + zero1 + [f"--resume_train_state={work / f'jax_state_{family}'}"]),
        ]
    # a one-process run's train state, for two ranks to resume at (1, 2)
    single = port_run(env, "conformer", epochs=1, checkpoint_every_n_epochs=1, results_subdir_name="one_process")
    state_dir = os.path.join(single.results_dir, "train_state")
    restore = [("restore_1x2", "restore", [state_dir] + _flags("conformer", epochs=2, results_subdir_name="tp_1x2"))]
    child_args = lambda world, sub, js: [world, sub, json.dumps(js), json.dumps(NO_DROPOUT)]  # noqa: E731
    (work / "g4").mkdir()
    (work / "g2").mkdir()
    for sub in ("g4", "g2"):
        with open(work / sub / "config.yaml", "w") as f:
            f.write("".join(f"{k}: {v}\n" for k, v in yaml_fields(env).items()))
    procs = [start_ranks(CHILD, child_args(4, work / "g4", jobs), tmp_path=work / "g4", n=4, cwd=str(work / "g4")),
             start_ranks(CHILD, child_args(2, work / "g2", restore), tmp_path=work / "g2", n=2, cwd=str(work / "g2"))]
    try:
        for exp in jax_exps.values():
            exp.run()
    finally:
        for p in procs:
            wait_ranks(p, timeout=300)
    ranks = {}
    for sub, world in (("g4", 4), ("g2", 2)):
        ranks[sub] = []
        for r in range(world):
            with open(work / sub / f"written_{r}.json") as f:
                ranks[sub].append(json.load(f))
    pieces = lambda sub, name, world: [torch.load(str(work / sub / f"pieces_{name}_{r}.pt"),  # noqa: E731
                                                  weights_only=False) for r in range(world)]
    return dict(jax={f: _history(e.results_dir) for f, e in jax_exps.items()}, ranks=ranks, pieces=pieces,
                single_state=os.path.join(state_dir, "state.pt"),
                jax_states={f: str(work / f"jax_state_{f}") for f in FAMILIES})


def _close(got, ref):
    assert np.isfinite(got) and abs(got - ref) <= REL * abs(ref), (got, ref)


@pytest.mark.parametrize("family", FAMILIES)
def test_four_rank_cli_at_2x2_matches_the_jax_2x2_run(runs, family):
    ref = runs["jax"][family]
    results = {r["results"][f"train_{family}"] for r in runs["ranks"]["g4"]}
    assert len(results) == 1  # rank 0's timestamp, broadcast
    got = _history(results.pop())
    assert len(got["epochs"]) == len(ref["epochs"]) == 1
    for split in ("train", "val"):
        g, r = got["epochs"][0][split]["average"], ref["epochs"][0][split]["average"]
        _close(g["loss"], r["loss"])
        assert g["metrics"] == r["metrics"], split
    g, r = got["test"]["average"], ref["test"]["average"]
    _close(g["loss"], r["loss"])
    assert g["metrics"] == r["metrics"] and set(g["metrics"]) == {"word_error_rate", "char_error_rate"}


def test_only_rank_zero_writes_files(runs):
    rank0, *others = (r["written"] for r in runs["ranks"]["g4"])
    assert all(w == [] for w in others)
    names = {os.path.basename(p) for p in rank0}
    assert {"config.json", "history.json", "metrics.jsonl", "model.pt.tmp", "best_model.pt.tmp", "state.pt.tmp",
            "test_predictions.json"} <= names, names


def _whole_and_pieces(runs, family):
    results = runs["ranks"]["g4"][0]["results"][f"train_{family}"]
    bundle = load_tree(os.path.join(results, "train_state", "state.pt"))
    return results, bundle, runs["pieces"]("g4", f"train_{family}", 4)


def _slice(whole, path, m, d, dp, zero1, moment):
    """Rank (d, m)'s piece of a whole leaf: the model-axis slice, then
    under ZeRO-1 (a moment leaf) the data-axis slice of that."""
    md = split_dim(path, whole.dim())
    piece = whole
    if md is not None:
        n = whole.shape[md] // 2
        piece = piece.narrow(md, m * n, n)
    zd = zero1_dim(piece.shape, dp, md) if zero1 and moment else None
    if zd is not None:
        n = piece.shape[zd] // dp
        piece = piece.narrow(zd, d * n, n)
    return piece


@pytest.mark.parametrize("family", FAMILIES)
def test_tensor_parallel_files_are_whole_and_resume_in_one_process(env, runs, family):  # noqa: F811
    results, bundle, pieces = _whole_and_pieces(runs, family)
    cls = impl.B2TGruAndW2VConformerExperiment if family == "conformer" else impl.B2TGruAndW2VExperiment
    exp = cls(config(family, epochs=2, results_subdir_name="resume_one"), YamlConfigModel(**yaml_fields(env)),
              device="cpu")
    assert exp.shard is None
    shapes = {p: t.shape for p, t in tree_leaves_with_path(exp.params)}
    model = load_tree(os.path.join(results, "model.pt"))
    assert {p: t.shape for p, t in tree_leaves_with_path(model["params"])} == shapes
    assert {p: t.shape for p, t in tree_leaves_with_path(bundle["params"])} == shapes
    trainer = Trainer(exp)
    start, history = trainer.restore_train_state(os.path.join(results, "train_state"))
    assert start == 1 and len(history) == 1 and bundle["opt"]["count"] == 2
    for tree, file_tree in ((trainer.params, bundle["params"]), (trainer.opt_state.mu, bundle["opt"]["mu"])):
        got = dict(tree_leaves_with_path(tree))
        for p, t in tree_leaves_with_path(file_tree):
            assert torch.equal(got[p], t), p
    # every rank's pieces at the end of its run are its slices of the whole file
    n_split = 0
    for r, rank_pieces in enumerate(pieces):
        d, m = divmod(r, 2)
        for key, file_tree in (("params", bundle["params"]), ("mu", bundle["opt"]["mu"])):
            mine = dict(tree_leaves_with_path(rank_pieces[key]))
            for p, whole in tree_leaves_with_path(file_tree):
                want = _slice(whole, p, m, d, 2, family == "conformer", key == "mu")
                assert torch.equal(mine[p], want), (r, key, p)
                n_split += want.numel() < whole.numel()
    assert n_split > 4 * 20


@pytest.mark.parametrize("family", FAMILIES)
def test_only_test_and_a_jax_format_resume_under_the_split(runs, family):
    rank0 = runs["ranks"]["g4"][0]["results"]
    train = _history(rank0[f"train_{family}"])
    with open(os.path.join(rank0[f"only_test_{family}"], "test_predictions.json")) as f:
        pred = json.load(f)["average"]
    assert pred["loss"] == train["test"]["average"]["loss"]
    assert pred["metrics"] == train["test"]["average"]["metrics"]
    resumed = _history(rank0[f"resume_{family}"])
    assert len(resumed["epochs"]) == 2
    assert resumed["epochs"][0] == train["epochs"][0]  # history.json beside state.msgpack
    assert np.isfinite(resumed["epochs"][1]["train"]["average"]["loss"])


@pytest.mark.parametrize("family", FAMILIES)
def test_the_converted_state_restores_in_the_jax_package_at_2x2(env, runs, family):  # noqa: F811
    """`convert train-state` of the (2, 2) run's whole state, restored by the
    JAX Trainer on its (2, 2) mesh: every param and BN leaf the state.pt's."""
    from test_torch_jax_train_state import _assert_tree_bitwise, _jax_restored

    _, bundle, _ = _whole_and_pieces(runs, family)
    cls = jax_impl.B2TGruAndW2VConformerExperiment if family == "conformer" else jax_impl.B2TGruAndW2VExperiment
    path = runs["jax_states"][family]
    jexp = cls(config(family, epochs=2, mesh_data_parallel=2, mesh_model_parallel=2, resume_train_state=path,
                      results_subdir_name="jax_resume"), JaxYaml(**yaml_fields(env)))
    epoch, _, (jparams, jstate), _, _ = _jax_restored(jexp, path)
    assert epoch == bundle["epoch"] + 1 == 1
    _assert_tree_bitwise(bundle["params"], jparams)
    _assert_tree_bitwise(bundle["state"], jstate)


def test_a_one_process_train_state_resumes_at_1x2(runs):
    bundle = load_tree(runs["single_state"])
    pieces = runs["pieces"]("g2", "restore_1x2", 2)
    n_split = 0
    for m, rank_pieces in enumerate(pieces):
        for key, file_tree in (("params", bundle["params"]), ("mu", bundle["opt"]["mu"])):
            mine = dict(tree_leaves_with_path(rank_pieces[key]))
            for p, whole in tree_leaves_with_path(file_tree):
                want = _slice(whole, p, m, 0, 1, False, key == "mu")
                assert torch.equal(mine[p], want), (m, key, p)
                n_split += want.numel() < whole.numel()
    assert n_split > 2 * 20
    assert runs["ranks"]["g2"][1]["written"] == []
