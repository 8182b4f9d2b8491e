"""Experiment tracking behind a small interface (counterpart of
wav2vec2forbrain_tpu/train/logger.py).

Two backends: the wandb client when it is installed and --use_wandb is set,
and an always-on JSONL backend (metrics.jsonl in the results dir), with the
same metric names either way. Where wandb is missing, --use_wandb=true
prints a warning and writes the JSONL file only.
"""

import json
import os
import time
from typing import Optional


class JsonlLogger:
    def __init__(self, out_dir: str, run_config: Optional[dict] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        if run_config is not None:
            self._write({"_type": "run_config", "config": run_config})

    def _write(self, obj: dict):
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()

    def log(self, metrics: dict):
        self._write({"_type": "metrics", "ts": time.time(), **metrics})

    def finish(self):
        self._f.close()


class WandbLogger:
    def __init__(
        self,
        api_key: str,
        project: str,
        entity: str,
        run_config: dict,
        name: str,
        out_dir: str,
    ):
        import wandb  # optional dependency

        wandb.login(key=api_key, relogin=True)
        self._wandb = wandb
        self._run = wandb.init(
            project=project,
            entity=entity,
            config=run_config,
            name=name,
            dir=out_dir,
            save_code=True,
        )

    def log(self, metrics: dict):
        self._wandb.log(metrics)

    def finish(self):
        self._run.finish()


class MultiLogger:
    def __init__(self, *loggers):
        self.loggers = [l for l in loggers if l is not None]

    def log(self, metrics: dict):
        for l in self.loggers:
            l.log(metrics)

    def finish(self):
        for l in self.loggers:
            l.finish()


def make_logger(
    results_dir: str,
    run_config: dict,
    use_wandb: bool,
    wandb_api_key: Optional[str] = None,
    wandb_project: Optional[str] = None,
    wandb_entity: Optional[str] = None,
    experiment_name: str = "experiment",
    enabled: bool = True,
) -> MultiLogger:
    """enabled=False (a data-parallel rank other than 0) logs nothing."""
    if not enabled:
        return MultiLogger()
    loggers = [JsonlLogger(results_dir, run_config)]
    if use_wandb:
        try:
            loggers.append(
                WandbLogger(
                    wandb_api_key,
                    wandb_project,
                    wandb_entity,
                    run_config,
                    experiment_name,
                    results_dir,
                )
            )
        except ImportError:
            print("WARNING: use_wandb=true but wandb is not installed; JSONL only")
    return MultiLogger(*loggers)
