"""The port's sweep runner (wav2vec2forbrain_tpu_torch/sweep.py) against the
repository's sweep.py:

- its YAML reader gives what yaml.safe_load gives on all three
  sweeps/*.yaml (only this test imports yaml), and refuses what lies
  outside the subset it reads;
- --dry_run lists the commands `python sweep.py <yaml> --dry_run` lists,
  in the same order with the same flags, with the port's program in place
  of run.py; --max_runs caps the grid;
- read_metric and the pick of the best point behave as
  tests/test_sweep_runner.py holds the original to;
- one grid point of the from-scratch sweep (tiny widths through --extra,
  the tiny encoders of tests/test_torch_trainer.py's fixture) runs in
  process on the CPU through the launcher, to its results dir and a
  summary.jsonl row.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import yaml

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_trainer import env, yaml_fields  # noqa: E402,F401

from wav2vec2forbrain_tpu_torch import run, sweep  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SWEEPS = sorted(os.path.join(REPO, "sweeps", n) for n in os.listdir(os.path.join(REPO, "sweeps"))
                if n.endswith(".yaml"))
SCRATCH = os.path.join(REPO, "sweeps", "b2p2t_gru+w2v_training_from_scratch.yaml")


@pytest.mark.parametrize("path", SWEEPS, ids=os.path.basename)
def test_reader_equals_yaml_safe_load(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    got = sweep.read_sweep_yaml(path)
    assert got == ref
    assert [type(v) for v in got["parameters"]["encoder_gru_hidden_size"]["values"]] == [int] * 3
    assert len(list(sweep.expand_grid(got["parameters"]))) == got["run_cap"] == 45


@pytest.mark.parametrize("text", [
    "a: [1, [2]]\n", "a: &x 1\n", "a:\n  - b: 1\n", "a: 0x1f\n", "a:\n b: 1\n  c: 2\n", "a: 'it''s'\n",
])
def test_reader_refuses_what_lies_outside_its_subset(tmp_path, text):
    path = tmp_path / "s.yaml"
    path.write_text(text)
    with pytest.raises(ValueError):
        sweep.read_sweep_yaml(str(path))


def test_reader_takes_scalars_comments_and_quoted_lists(tmp_path):
    text = ("# a sweep\nname: x  # trailing\nrate: 0.5\nflag: true\nnone:\nlist:\n- '--a=1'\n- b\n"
            "parameters:\n  p:\n    values: ['[1, 2]', \"q\", 3, 1.5]\n")
    path = tmp_path / "s.yaml"
    path.write_text(text)
    assert sweep.read_sweep_yaml(str(path)) == yaml.safe_load(text)


def _config_yaml(tmp_path):
    cache = tmp_path / "cache"
    path = tmp_path / "config.yaml"
    path.write_text(f"cache_dir: {cache}\n")
    return path, cache


@pytest.mark.parametrize("path", SWEEPS, ids=os.path.basename)
def test_dry_run_lists_the_root_runners_commands(tmp_path, capsys, path):
    config, _ = _config_yaml(tmp_path)
    extra = ["--extra", "--epochs=1", "--batch_size=8"]
    ref = subprocess.run([sys.executable, os.path.join(REPO, "sweep.py"), path, "--dry_run",
                          f"--config_yaml={config}", *extra], capture_output=True, text=True, check=True,
                         cwd=tmp_path).stdout
    sweep.main([path, "--dry_run", f"--config_yaml={config}", *extra], launch=None)
    got = capsys.readouterr().out
    port = " ".join(sweep.PROGRAM)
    want = ref.replace(f"{sys.executable} run.py", port)
    assert got == want
    commands = [line for line in got.splitlines() if line.startswith("[")]
    assert len(commands) == 45 and all(port in c and c.endswith("--epochs=1 --batch_size=8") for c in commands)


def test_max_runs_caps_the_grid(tmp_path, capsys):
    config, _ = _config_yaml(tmp_path)
    sweep.main([SCRATCH, "--dry_run", "--max_runs", "4", f"--config_yaml={config}"], launch=None)
    out = capsys.readouterr().out
    commands = [line for line in out.splitlines() if line.startswith("[")]
    assert [c.split("]")[0] for c in commands] == ["[1/4", "[2/4", "[3/4", "[4/4"]
    assert "4 runs, metric test_ctc_loss (minimize)" in out
    assert commands[1].endswith("--encoder_fc_hidden_sizes=[] --encoder_gru_hidden_size=256 "
                                "--encoder_num_gru_layers=3")


def test_read_metric(tmp_path):
    d = tmp_path / "experiment_results" / "exp" / "run1"
    os.makedirs(d)
    with open(d / "metrics.jsonl", "w") as f:
        f.write(json.dumps({"_type": "metrics", "test_ctc_loss": 2.0}) + "\n")
        f.write("not json\n")
        f.write(json.dumps({"_type": "metrics", "test_ctc_loss": 1.5}) + "\n")
    assert sweep.read_metric(str(tmp_path), "exp", "test_ctc_loss") == (1.5, str(d))
    assert sweep.read_metric(str(tmp_path), "nope", "test_ctc_loss") == (None, None)


def test_best_point_by_goal(tmp_path):
    """Three launched points write their metric; the best is the smallest
    under minimize and the larger under maximize."""
    config, cache = _config_yaml(tmp_path)
    values = [3.0, 1.0, 2.0]
    launched = []

    def launch(flags):
        d = cache / "experiment_results" / "b2p2t_gru+w2v" / f"run{len(launched)}"
        os.makedirs(d)
        (d / "metrics.jsonl").write_text(json.dumps({"test_ctc_loss": values[len(launched)]}) + "\n")
        launched.append(flags)
        return 0

    summary, best = sweep.main([SCRATCH, "--max_runs", "3", f"--config_yaml={config}"], launch=launch)
    assert best[0] == 1.0 and best[1]["encoder_num_gru_layers"] == 3
    with open(summary) as f:
        rows = [json.loads(line) for line in f]
    assert [r["test_ctc_loss"] for r in rows] == [3.0, 1.0, 2.0] and [r["run"] for r in rows] == [0, 1, 2]
    assert sweep.better(2.0, (1.0, {}), "maximize") and not sweep.better(2.0, (1.0, {}), "minimize")
    assert not sweep.better(None, None, "minimize") and sweep.better(5.0, None, "minimize")


def test_a_grid_point_runs_in_process(env, monkeypatch, capsys):  # noqa: F811
    work = env / "sweep_run"
    work.mkdir()
    fields = dict(yaml_fields(env), cache_dir=str(work / "cache"))
    (work / "config.yaml").write_text("".join(f"{k}: {v}\n" for k, v in fields.items()))
    monkeypatch.chdir(work)

    summary, best = sweep.main([SCRATCH, "--max_runs", "1", "--extra", "--epochs=1", "--batch_size=3",
                                "--encoder_gru_hidden_size=32", "--device_data_cache=off"],
                               launch=sweep.in_process(lambda flags: run.main(flags, device="cpu")))
    assert summary == str(work / "cache" / "sweep_results" / "b2p2t_gru+w2v__from_scratch" / "summary.jsonl")
    with open(summary) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 1 and rows[0]["returncode"] == 0
    assert rows[0]["params"] == {"encoder_fc_hidden_sizes": "[]", "encoder_gru_hidden_size": 256,
                                 "encoder_num_gru_layers": 1}
    assert math.isfinite(rows[0]["test_ctc_loss"]) and best == (rows[0]["test_ctc_loss"], rows[0]["params"])
    results = rows[0]["results_dir"]
    assert results.startswith(str(work / "cache" / "experiment_results" / "b2p2t_gru+w2v"))
    assert {"config.json", "history.json", "metrics.jsonl", "model.pt"} <= set(os.listdir(results))
    with open(os.path.join(results, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["encoder_gru_hidden_size"] == 32 and cfg["epochs"] == 1 and cfg["w2v_skip_loading_weights"] is True
    assert "Best test_ctc_loss" in capsys.readouterr().out


def _record_points(cache, values, commands):
    """A launcher that records each command and writes what rank 0 of a
    torchrun point writes: one results dir with its metrics.jsonl (the
    other ranks write no file)."""

    def launch(command):
        d = cache / "experiment_results" / "b2p2t_gru+w2v" / f"run{len(commands)}"
        os.makedirs(d)
        (d / "metrics.jsonl").write_text(json.dumps({"_type": "run_config", "rank": 0}) + "\n"
                                         + json.dumps({"test_ctc_loss": values[len(commands)]}) + "\n")
        commands.append(command)
        return 0

    return launch


def test_torchrun_command_at_two_ranks(tmp_path, capsys):
    """--nproc_per_node 2: each point runs as two ranks under torchrun with
    the one-process point's flags, and its metric is read from rank 0's
    files."""
    config, cache = _config_yaml(tmp_path)
    one, two = [], []
    sweep.main([SCRATCH, "--max_runs", "2", f"--config_yaml={config}"], launch=_record_points(cache, [2.0, 1.0], one))
    (cache / "experiment_results").rename(tmp_path / "one_rank_results")
    summary, best = sweep.main([SCRATCH, "--max_runs", "2", "--nproc_per_node", "2", f"--config_yaml={config}"],
                               launch=_record_points(cache, [4.0, 3.0], two))
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
                "-m", "wav2vec2forbrain_tpu_torch.run"]
    assert sweep.program(2) == torchrun
    assert [c[: len(torchrun)] for c in two] == [torchrun, torchrun]
    assert [c[len(torchrun):] for c in two] == [c[len(sweep.PROGRAM):] for c in one]
    assert all("--nproc_per_node" not in " ".join(c[len(torchrun):]) for c in two)
    with open(summary) as f:
        rows = [json.loads(line) for line in f][-2:]
    assert [r["test_ctc_loss"] for r in rows] == [4.0, 3.0] and best[0] == 3.0
    assert rows[1]["results_dir"] == str(cache / "experiment_results" / "b2p2t_gru+w2v" / "run1")
    assert " ".join(torchrun) in capsys.readouterr().out


def test_one_rank_keeps_the_command(tmp_path):
    """--nproc_per_node 1 (the default) launches exactly the one-process
    command of a sweep without the option."""
    config, cache = _config_yaml(tmp_path)
    default, one = [], []
    sweep.main([SCRATCH, "--max_runs", "3", f"--config_yaml={config}"],
               launch=_record_points(cache, [1.0] * 3, default))
    (cache / "experiment_results").rename(tmp_path / "default_results")
    sweep.main([SCRATCH, "--max_runs", "3", "--nproc_per_node", "1", f"--config_yaml={config}"],
               launch=_record_points(cache, [1.0] * 3, one))
    assert one == default and all(c[: len(sweep.PROGRAM)] == sweep.PROGRAM for c in one)
    assert sweep.PROGRAM == [sys.executable, "-m", "wav2vec2forbrain_tpu_torch.run"] == sweep.program(1)


def test_in_process_launcher_refuses_torchrun(tmp_path):
    seen = []
    launch = sweep.in_process(seen.append)
    assert launch(sweep.program(1) + ["--epochs=1"]) == 0 and seen == [["--epochs=1"]]
    with pytest.raises(ValueError, match="one process"):
        launch(sweep.program(2) + ["--epochs=1"])
    with pytest.raises(ValueError, match="at least 1"):
        sweep.program(0)
