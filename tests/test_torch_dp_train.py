"""The port's CLI under two gloo ranks against the JAX package's
data-parallel experiment, on the CPU, for both families.

The JAX experiment runs one epoch on a ('data', 'model') = (2, 1) mesh of
conftest's virtual devices (--mesh_data_parallel=2); its initial weights,
bridged to the port's checkpoint format, start two ranks of the port's
`run.main(argv, device="cpu")` under torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; subprocesses with a time
limit, as tests/test_multihost.py runs its children), once with the Adam
moments replicated and once with --optimizer_state_sharding=zero1. The
fixture and the flags are tests/test_torch_trainer.py's (tiny encoders,
biGRU 2 x 32, batch 3: the train split's ragged last batch of 1 and the
val split's of 2 are padded to 4 rows, 2 a rank; dropout off, Adam eps
1e-4), so:

- each epoch's train and val losses and the test loss agree within 1e-4
  relative of the JAX run's, and WER and CER are equal;
- rank 0 alone wrote files (config.json, history.json, metrics.jsonl,
  model.pt, the train state): every file rank 1 opened for writing is
  listed, and there is none;
- the ZeRO-1 run's train_state/state.pt holds the moments whole, and a
  one-process experiment resumes from it;
- a --mesh_model_parallel that does not divide the encoder's heads, or the
  world size, is refused by either experiment (ValueError).
The JAX runs go on in this process while the ranks run.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import wav2vec2forbrain_tpu.experiments.impl as jax_impl
from test_torch_parallel import start_ranks, wait_ranks
from test_torch_trainer import NO_DROPOUT, REL, config, env, yaml_fields  # noqa: F401
from wav2vec2forbrain_tpu.args.yaml_config import YamlConfigModel as JaxYaml
from wav2vec2forbrain_tpu_torch import bridge
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel
from wav2vec2forbrain_tpu_torch.experiments import impl
from wav2vec2forbrain_tpu_torch.train.checkpoint import load_tree, save_checkpoint
from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer
from wav2vec2forbrain_tpu_torch.tree import tree_leaves_with_path

FAMILIES = ("conformer", "w2v")
RUNS = {"replicated": [], "zero1": ["--optimizer_state_sharding=zero1", "--checkpoint_every_n_epochs=1"]}

# one rank: the tiny encoders of tests/test_torch_trainer.py, then the CLI of
# each (family, run) in turn in one gloo group; every path opened for
# writing (open, torch.save) is listed in written_<rank>.json
CHILD = r"""
import builtins, json, os, sys
import torch

torch.set_num_threads(1)
rank, port, work, jobs = int(sys.argv[1]), sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank), MASTER_ADDR="localhost", MASTER_PORT=port)

from wav2vec2forbrain_tpu_torch import run
from wav2vec2forbrain_tpu_torch.args.flags import PRETRAINED_LATENT_SIZES
from wav2vec2forbrain_tpu_torch.models import pretrained
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig
from wav2vec2forbrain_tpu_torch.parallel import distributed

NO_DROPOUT = json.loads(sys.argv[5])
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


builtins.open, torch.save = open_, save_
os.chdir(work)
results = {}
for name, argv in jobs:
    exp = run.main(argv, device="cpu")
    assert exp.shard is not None and exp.shard.size == 2 and exp.shard.rank == rank
    assert (exp.optimizer.zero is not None) == ("--optimizer_state_sharding=zero1" in argv)
    results[name] = exp.results_dir
builtins.open, torch.save = _open, _save
with open(os.path.join(work, f"written_{rank}.json"), "w") as f:
    json.dump({"written": written, "results": results}, f)
import torch.distributed as dist
dist.destroy_process_group()
"""


def _argv(cfg: dict) -> list:
    out = []
    for k, v in cfg.items():
        if v is None:
            continue
        if isinstance(v, bool):
            v = str(v).lower()
        elif isinstance(v, list):
            v = json.dumps(v)
        out.append(f"--{k}={v}")
    return out


def _history(results_dir):
    with open(os.path.join(results_dir, "history.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(env):  # noqa: F811
    """family -> JAX history; the ranks' written files and results dirs."""
    work = env / "dp"
    work.mkdir()
    with open(work / "config.yaml", "w") as f:
        f.write("".join(f"{k}: {v}\n" for k, v in yaml_fields(env).items()))
    jax_exps, jobs = {}, []
    for family in FAMILIES:
        cls = (jax_impl.B2TGruAndW2VConformerExperiment if family == "conformer"
               else jax_impl.B2TGruAndW2VExperiment)
        exp = cls(config(family, epochs=1, mesh_data_parallel=2, results_subdir_name="jax"),
                  JaxYaml(**yaml_fields(env)))
        assert exp.mesh.shape["data"] == 2
        tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), (exp._merged_params(), exp.model_state))
        init = str(work / f"init_{family}.pt")
        save_checkpoint(init, *bridge.params_from_jax(*jax.device_get(tree), device="cpu"))
        jax_exps[family] = exp
        for name, extra in RUNS.items():
            flags = _argv(config(family, epochs=1, mesh_data_parallel=0, results_subdir_name=f"port_{name}"))
            jobs.append((f"{family}_{name}", flags + extra + [f"--from_checkpoint={init}"]))
    procs = start_ranks(CHILD, [work, json.dumps(jobs), json.dumps(NO_DROPOUT)], tmp_path=work, cwd=str(work))
    try:
        for exp in jax_exps.values():
            exp.run()
    finally:
        wait_ranks(procs, timeout=300)
    ranks = []
    for r in range(2):
        with open(work / f"written_{r}.json") as f:
            ranks.append(json.load(f))
    return dict(jax={f: _history(e.results_dir) for f, e in jax_exps.items()}, ranks=ranks)


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_cli_matches_the_jax_dp2_run(runs, family, run):
    ref = runs["jax"][family]
    results = runs["ranks"][0]["results"][f"{family}_{run}"]
    assert runs["ranks"][1]["results"][f"{family}_{run}"] == results  # rank 0's timestamp, broadcast
    got = _history(results)
    assert len(got["epochs"]) == len(ref["epochs"]) == 1
    for split in ("train", "val"):
        g, r = got["epochs"][0][split]["average"], ref["epochs"][0][split]["average"]
        assert np.isfinite(g["loss"]) and abs(g["loss"] - r["loss"]) <= REL * abs(r["loss"]), (split, g, r)
        assert g["metrics"] == r["metrics"], split
        assert len(got["epochs"][0][split]["history"]) == (2 if split == "train" else 3)  # 3 + 1; 3 + 3 + 2
    g, r = got["test"]["average"], ref["test"]["average"]
    assert abs(g["loss"] - r["loss"]) <= REL * abs(r["loss"]), (g["loss"], r["loss"])
    assert g["metrics"] == r["metrics"] and set(g["metrics"]) == {"word_error_rate", "char_error_rate"}
    files = set(os.listdir(results))
    assert {"config.json", "history.json", "metrics.jsonl", "model.pt"} <= files
    with open(os.path.join(results, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert sum(r["_type"] == "run_config" for r in rows) == 1
    assert any("train_samples_per_sec" in r for r in rows)


def test_only_rank_zero_writes_files(runs):
    rank0, rank1 = (r["written"] for r in runs["ranks"])
    assert rank1 == []
    names = {os.path.basename(p) for p in rank0}
    # the checkpoints go through a temporary file (train/checkpoint.py::save_tree)
    assert {"config.json", "history.json", "metrics.jsonl", "model.pt.tmp", "best_model.pt.tmp",
            "state.pt.tmp"} <= names, names


@pytest.mark.parametrize("family", FAMILIES)
def test_zero1_train_state_is_whole_and_resumes_in_one_process(env, runs, family):  # noqa: F811
    results = runs["ranks"][0]["results"][f"{family}_zero1"]
    path = os.path.join(results, "train_state", "state.pt")
    bundle = load_tree(path)
    shapes = dict((p, t.shape) for p, t in tree_leaves_with_path(bundle["params"]))
    mu = tree_leaves_with_path(bundle["opt"]["mu"])
    assert len(mu) > 10 and all(t.shape == shapes[p] for p, t in mu)
    assert bundle["opt"]["count"] == 2  # two train batches
    cls = impl.B2TGruAndW2VConformerExperiment if family == "conformer" else impl.B2TGruAndW2VExperiment
    exp = cls(config(family, epochs=2, results_subdir_name="resume"), YamlConfigModel(**yaml_fields(env)),
              device="cpu")
    assert exp.shard is None
    trainer = Trainer(exp)
    start, history = trainer.restore_train_state(os.path.dirname(path))
    assert start == 1 and len(history) == 1
    got = dict(tree_leaves_with_path(trainer.opt_state.mu))
    for p, t in mu:
        assert torch.equal(got[p], t), p


@pytest.mark.parametrize("family", FAMILIES)
def test_tensor_parallel_flag_still_raises(env, family):  # noqa: F811
    """A model axis that does not divide the tiny encoder's 4 heads (3), or
    the world size of one process (2), is refused before anything is
    loaded."""
    cls = impl.B2TGruAndW2VConformerExperiment if family == "conformer" else impl.B2TGruAndW2VExperiment
    for mp, match in ((3, "--mesh_model_parallel=3 must divide the encoder's 4 attention heads"),
                      (2, "--mesh_model_parallel=2 does not divide the world size 1")):
        with pytest.raises(ValueError, match=match):
            cls(config(family, mesh_model_parallel=mp, results_subdir_name="tp"),
                YamlConfigModel(**yaml_fields(env)), device="cpu")
