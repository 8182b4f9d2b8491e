"""Local grid-sweep runner over the W&B sweep YAMLs (counterpart of the
repository's sweep.py), running the port's CLI.

    python -m wav2vec2forbrain_tpu_torch.sweep sweeps/b2p2t_gru+w2v_training_from_scratch.yaml \\
        [--dry_run] [--max_runs N] [--config_yaml config.yaml] [--nproc_per_node N] [--extra --flag=value ...]

It reads the same sweeps/*.yaml and expands the same grid in the same
order: each point runs `python -m wav2vec2forbrain_tpu_torch.run` (in
place of the YAML's `program`) with the YAML's fixed flags (without
--use_wandb and the ${...} placeholders), the point's flags and --extra.
With --nproc_per_node N above 1 a point runs as N ranks under torchrun
(`python -m torch.distributed.run --standalone --nproc_per_node=N -m
wav2vec2forbrain_tpu_torch.run ...`, data parallel over N cards, as a JAX
sweep point uses every local device); 1, the default, runs one process.
Each run appends a row to <cache_dir>/sweep_results/<name>/summary.jsonl
(cache_dir from config.yaml) with the sweep's metric, read from the run's
metrics.jsonl (under torchrun rank 0's: the only rank that writes files);
the best point by the YAML's metric and goal is printed.

The YAML is read by `read_sweep_yaml`, which takes the subset the sweep
files use (top-level scalars, the `command:` list, the `metric:` mapping
and `parameters: {name: {values: [...]}}` with flow lists).
`main(argv, launch=...)` runs each point through `launch(command) ->
return code`, the command being `program(N)` followed by the point's flags
(by default a subprocess), so a caller can run the points in process
(`in_process`).
"""

import argparse
import itertools
import json
import os
import re
import subprocess
import sys
import time
from typing import Callable, List, Optional

from wav2vec2forbrain_tpu_torch.args.yaml_config import _NOT_STR, read_flat_yaml

PROGRAM = [sys.executable, "-m", "wav2vec2forbrain_tpu_torch.run"]


def program(nproc_per_node: int = 1) -> List[str]:
    """The command a point's flags follow: one process, or N ranks under torchrun."""
    if nproc_per_node < 1:
        raise ValueError(f"--nproc_per_node {nproc_per_node}: at least 1")
    if nproc_per_node == 1:
        return list(PROGRAM)
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc_per_node}",
            "-m", "wav2vec2forbrain_tpu_torch.run"]


_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?$")  # YAML 1.1 floats need the dot
_TRUE = {"y", "Y", "yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"n", "N", "no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}


def _scalar(text: str, where: str):
    """A YAML 1.1 plain or quoted scalar of the kinds the sweep files use."""
    text = text.strip()
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text[0] in "'\"":
        if len(text) < 2 or text[-1] != text[0] or text[0] in text[1:-1]:
            raise ValueError(f"{where}: unsupported quoted value {text!r}")
        return text[1:-1]
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if text[0] in "[]{}&*!|>%@`" or ": " in text or " #" in text or _NOT_STR.match(text):
        raise ValueError(f"{where}: {text!r} is outside the sweep files' YAML subset")
    return text


def _flow_list(text: str, where: str) -> list:
    """[a, 'b, c', 3] -> a list of scalars (no nesting)."""
    text = text.strip()
    if not (text.startswith("[") and text.endswith("]")):
        raise ValueError(f"{where}: expected a flow list, got {text!r}")
    items, cur, quote = [], "", None
    for ch in text[1:-1]:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch == ",":
            items.append(cur)
            cur = ""
        elif ch in "[]{}":
            raise ValueError(f"{where}: nested flow collections are outside the subset")
        else:
            cur += ch
    if quote:
        raise ValueError(f"{where}: unterminated quote")
    if cur.strip() or items:
        items.append(cur)
    return [_scalar(item, where) for item in items]


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def read_sweep_yaml(path: str) -> dict:
    """The sweep file as yaml.safe_load reads it, for the subset the sweep
    files use: `key: scalar`, `key:` + a block list of scalars (`  - x`),
    `key:` + a mapping of scalars, and `parameters:` + `name:` + `values:
    [...]`. Raises ValueError on anything else."""
    lines = []
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = _strip_comment(raw.rstrip("\n"))
            if line.strip():
                if "\t" in line[: len(line) - len(line.lstrip())]:
                    raise ValueError(f"{path} line {lineno}: tab indentation")
                lines.append((lineno, len(line) - len(line.lstrip(" ")), line.strip()))
    key_re = re.compile(r"^([A-Za-z_][A-Za-z0-9_.+-]*):(?:\s+(.*))?$")

    def block(i, indent):
        """The block at `indent` from line i: (value, next line index)."""
        where = f"{path} line {lines[i][0]}"
        if lines[i][2].startswith("- ") or lines[i][2] == "-":
            items = []
            while i < len(lines) and lines[i][1] == indent and lines[i][2].startswith("-"):
                items.append(_scalar(lines[i][2][1:], f"{path} line {lines[i][0]}"))
                i += 1
            return items, i
        mapping = {}
        while i < len(lines) and lines[i][1] == indent:
            lineno, _, text = lines[i]
            m = key_re.match(text)
            if m is None:
                raise ValueError(f"{path} line {lineno}: not a 'key: value' line: {text!r}")
            key, value = m.group(1), m.group(2)
            if key in mapping:
                raise ValueError(f"{path} line {lineno}: {key} given twice")
            i += 1
            if value is not None and value.strip():
                value = value.strip()
                mapping[key] = _flow_list(value, f"{path} line {lineno}") if value.startswith("[") else \
                    _scalar(value, f"{path} line {lineno}")
            elif i < len(lines) and lines[i][1] > indent:
                mapping[key], i = block(i, lines[i][1])
            elif i < len(lines) and lines[i][1] == indent and lines[i][2].startswith("-"):
                mapping[key], i = block(i, indent)  # a block list at its key's indent
            else:
                mapping[key] = None
        if i < len(lines) and lines[i][1] > indent:
            raise ValueError(f"{where}: unexpected indentation at line {lines[i][0]}")
        return mapping, i

    if not lines:
        return {}
    if lines[0][1] != 0:
        raise ValueError(f"{path}: the first key is indented")
    out, i = block(0, 0)
    if i != len(lines):
        raise ValueError(f"{path} line {lines[i][0]}: unexpected indentation")
    return out


def expand_grid(parameters: dict):
    keys = list(parameters.keys())
    values = [parameters[k]["values"] for k in keys]
    for combo in itertools.product(*values):
        yield dict(zip(keys, combo))


def fixed_flags(command) -> List[str]:
    """The flags baked into the sweep's command list, without --use_wandb
    and the ${...} placeholders."""
    return [item for item in command
            if isinstance(item, str) and item.startswith("--") and not item.startswith("--use_wandb")]


def read_metric(results_root: str, name: str, metric: str):
    """(last value of `metric`, run dir) in the newest metrics.jsonl under
    <results_root>/experiment_results/<name>/; (None, None) if none."""
    exp_dir = os.path.join(results_root, "experiment_results", name)
    if not os.path.isdir(exp_dir):
        return None, None
    candidates = [os.path.join(root, "metrics.jsonl") for root, _dirs, files in os.walk(exp_dir)
                  if "metrics.jsonl" in files]
    if not candidates:
        return None, None
    latest = max(candidates, key=os.path.getmtime)
    value = None
    with open(latest) as f:
        for line in f:
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if metric in row:
                value = row[metric]
    return value, os.path.dirname(latest)


def better(value, best, goal: str) -> bool:
    return value is not None and (best is None or (goal == "minimize" and value < best[0])
                                  or (goal == "maximize" and value > best[0]))


def run_subprocess(command: List[str]) -> int:
    return subprocess.run(command).returncode


def in_process(run_flags: Callable[[List[str]], object]) -> Callable[[List[str]], int]:
    """A launcher that runs a one-process point's flags through run_flags
    (for example run.main on the CPU); it refuses a torchrun command."""

    def launch(command: List[str]) -> int:
        if command[: len(PROGRAM)] != PROGRAM:
            raise ValueError(f"an in-process launcher runs one process, not {' '.join(command)}")
        run_flags(command[len(PROGRAM):])
        return 0

    return launch


def main(argv: Optional[List[str]] = None, launch: Callable[[List[str]], int] = run_subprocess):
    """Run (or with --dry_run list) the sweep; returns (summary path, best
    (value, point) or None)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("sweep_yaml")
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--max_runs", type=int, default=None)
    ap.add_argument("--config_yaml", default="config.yaml")
    ap.add_argument("--nproc_per_node", type=int, default=1, help="ranks a point runs as (torchrun above 1)")
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[], help="extra flags appended to every run")
    args = ap.parse_args(argv)

    sweep = read_sweep_yaml(args.sweep_yaml)
    base_flags = fixed_flags(sweep.get("command", []))
    metric = sweep["metric"]["name"]
    goal = sweep["metric"]["goal"]
    run_cap = args.max_runs or sweep.get("run_cap")

    cache_dir = read_flat_yaml(args.config_yaml)["cache_dir"]
    out_dir = os.path.join(cache_dir, "sweep_results", sweep.get("name", "sweep"))
    os.makedirs(out_dir, exist_ok=True)
    summary_path = os.path.join(out_dir, "summary.jsonl")

    exp_type = next((f.split("=", 1)[1] for f in base_flags if f.startswith("--experiment_type=")),
                    "b2p2t_gru+w2v")
    command = program(args.nproc_per_node)
    grid = list(expand_grid(sweep.get("parameters", {})))
    if run_cap:
        grid = grid[:run_cap]
    print(f"sweep {sweep.get('name')}: {len(grid)} runs, metric {metric} ({goal})")

    best = None
    for i, point in enumerate(grid):
        flags = base_flags + [f"--{k}={v}" for k, v in point.items()] + args.extra
        print(f"\n[{i + 1}/{len(grid)}] {' '.join(command + flags)}")
        if args.dry_run:
            continue
        t0 = time.time()
        returncode = launch(command + flags)
        value, run_dir = read_metric(cache_dir, exp_type, metric)
        row = {
            "run": i,
            "params": point,
            metric: value,
            "returncode": returncode,
            "runtime_s": round(time.time() - t0, 1),
            "results_dir": run_dir,
        }
        with open(summary_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if better(value, best, goal):
            best = (value, point)
        print(f"  -> {metric}={value} (best so far: {best})")

    if not args.dry_run and best is not None:
        print(f"\nBest {metric}: {best[0]} at {best[1]}")
        print(f"Summary: {summary_path}")
    return summary_path, best


if __name__ == "__main__":
    main()
