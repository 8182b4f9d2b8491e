"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, and the result line.

A cell is a configuration file (configs/), a traffic file (traffic/) and a
file of limits (limits/<workload>.json), all found by the names in
BENCHMARK.json. The traffic file's `entry` names what the window drives:

- "train_epoch": `Trainer._train_epoch` over the train split, epoch after
  epoch (the method `Trainer.train()` runs each epoch). Set-up runs the
  first `check_steps` steps through the same call and feed and keeps what
  the check compares; the window then runs whole epochs until the clock
  passes --seconds and ends at that step.
- "predict_test": `_predict(trainer, "test")`, the --only_test pass, pass
  after pass. Set-up runs one pass (every batch shape of the split); the
  window's passes end at the batch the clock passes --seconds on.

The harness wraps two of the Trainer's attributes on the instance: its
`_stream_for` (to stop the stream at the deadline and time each wait for a
batch) and its step (to time each dispatch and, in a traced run, to start
and stop the profiler around a few steps). Nothing else of the program is
touched. The program's own prints go to a log file in the run's work
directory, so the result line is the last line of standard output.
"""

import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import traffic_gen, weights
from port_bench import seeds as bench_seeds
from port_bench.reference.train import leaves

PB = Path(__file__).resolve().parent
ROOT = PB.parent
INT31 = 2**31 - 1
B1 = 0.9  # Adam's first-moment decay: the first gradient is the moment after one step over (1 - B1)
TRACE_STEPS = {"train": 5, "serve": 20}  # the steps a traced run profiles, from 40% of the window


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    per_layer: List[dict] = field(default_factory=list)

    @classmethod
    def from_benchmark(cls, workload: str) -> "Cell":
        with open(ROOT / "BENCHMARK.json") as f:
            bench = json.load(f)
        entry = {w["name"]: w for w in bench["workloads"]}[workload]
        config_file = {c["name"]: c["file"] for c in bench["configs"]}[entry["config"]]
        with open(ROOT / config_file) as f:
            config = json.load(f)
        with open(PB / "traffic" / f"{entry['traffic']}.json") as f:
            traffic = json.load(f)
        with open(PB / "limits" / f"{workload}.json") as f:
            limits = json.load(f)
        per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
        return cls(workload, config, traffic, limits, per_layer)

    @property
    def kind(self) -> str:
        return "train" if self.traffic["entry"] == "train_epoch" else "serve"


class Window:
    """The harness's clock and host spans: the deadline or step limit the
    wrapped stream obeys, one record per step, and the traced segment.

    The traced segment records the device's activity only (CUPTI through
    torch.profiler); the host's spans (waiting for a batch, dispatching a
    step) are the harness's own wall-clock readings, in the clock the
    profiler stamps its events with, so tracing adds no per-op host cost."""

    def __init__(self, device, trace_steps: int = 0, trace_after: float = 0.0):
        self.device = device
        self.deadline: Optional[float] = None
        self.limit: Optional[int] = None
        self.timing = False
        self.steps: List[dict] = []
        self.pending: Optional[dict] = None  # the batch the stream last handed out
        self.trace_steps, self.trace_after = trace_steps, trace_after
        self.t0 = None
        self.prof = None
        self.traced: List[dict] = []
        self.trace_done = False
        self.stop_s = 0.0
        self.span_ns = None  # (start, end) of the traced segment
        self.host_spans: Dict[str, List[tuple]] = {"input_wait": [], "dispatch": []}

    @contextlib.contextmanager
    def span(self, name: str):
        if self.prof is None or self.trace_done:
            yield
            return
        t = time.time_ns()
        try:
            yield
        finally:
            self.host_spans[name].append((t, time.time_ns()))

    def stop_now(self, n: int) -> bool:
        if n == 0:
            return False  # every epoch or pass runs at least one step
        if self.limit is not None and n >= self.limit:
            return True
        return self.deadline is not None and time.perf_counter() >= self.deadline

    # the traced segment: a few steps past `trace_after` of the window
    def maybe_start_trace(self):
        if (self.trace_steps and self.t0 is not None and self.timing and not self.trace_done and self.prof is None
                and time.perf_counter() - self.t0 >= self.trace_after):
            self.prof = torch.profiler.profile(activities=_activities(self.device))
            self.prof.start()
            self.span_ns = (time.time_ns(), None)

    def maybe_stop_trace(self, force: bool = False):
        if self.prof is not None and not self.trace_done and (force or len(self.traced) >= self.trace_steps):
            _sync(self.device)
            t = time.perf_counter()
            self.span_ns = (self.span_ns[0], time.time_ns())
            self.prof.stop()
            self.stop_s = time.perf_counter() - t  # the profiler's collection, left out of the traced run's window
            self.trace_done = True


def wrap_trainer(trainer, win: Window, kind: str, on_step=None):
    """Wrap the instance's stream and step (the module's header)."""
    from wav2vec2forbrain_tpu_torch.ops import kernels

    original_stream = trainer._stream_for

    def stream_for(loader, split, grouped):
        inner = original_stream(loader, split, grouped)

        def batches():
            n = 0
            try:
                while not win.stop_now(n):
                    t = time.perf_counter()
                    with win.span("input_wait"):
                        try:
                            item = next(inner)
                        except StopIteration:
                            return
                    host = item[3]
                    true_b = int(item[1])
                    win.pending = {"wait_s": time.perf_counter() - t, "true_b": true_b,
                                   "width": int(item[0].input.shape[1]),
                                   "lens": host.input_lens[:true_b].astype(int).tolist(),
                                   "days": host.day_idxs[:true_b].astype(int).tolist(),
                                   "tgt_lens": host.target_lens[:true_b].astype(int).tolist(),
                                   "tgt_width": int(host.target.shape[1]), "train": kind == "train",
                                   "index": n}
                    n += 1
                    yield item
            finally:
                inner.close()

        return batches()

    trainer._stream_for = stream_for
    step_name = "train_step" if kind == "train" else "eval_step"
    original_step = getattr(trainer, step_name)

    def timed_step(*args, **kwargs):
        rec = dict(win.pending or {})
        rec["batch_rows"] = int(args[3].input.shape[0] if kind == "train" else args[2].input.shape[0])
        win.maybe_start_trace()
        traced = win.prof is not None and not win.trace_done
        before = dict(kernels.LAUNCHES) if traced else None
        t = time.perf_counter()
        with win.span("dispatch"):
            out = original_step(*args, **kwargs)
        rec["dispatch_s"] = time.perf_counter() - t
        if traced:
            rec["launches"] = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
            win.traced.append(rec)
        if win.timing:
            win.steps.append(rec)
        if on_step is not None:
            on_step(rec, out)
        if traced:
            win.maybe_stop_trace()
        return out

    setattr(trainer, step_name, timed_step)


@contextlib.contextmanager
def program_output(path: str):
    """The program's prints go to `path` (appended)."""
    with open(path, "a") as f, contextlib.redirect_stdout(f):
        yield


def build_experiment(cell: Cell, seed: int, work: str, device):
    from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel
    from wav2vec2forbrain_tpu_torch.experiments.registry import experiments

    flags = dict(cell.config["flags"], device_data_cache=cell.config["device_data_cache"], seed=int(seed) % INT31,
                 use_wandb=False, epochs=10**6)
    yaml = YamlConfigModel(cache_dir=os.path.join(work, "cache"), fig_dir=os.path.join(work, "figs"),
                           n3gram_lm_model_path=os.path.join(work, "none.arpa"),
                           n5gram_lm_model_path=os.path.join(work, "none.arpa"),
                           dataset_splits_dir=os.path.join(work, "t12"), wandb_api_key="offline")
    exp = experiments[flags["experiment_type"]](flags, yaml, device=device)
    exp.can_plot = False
    enc = exp.spec.conformer_cfg if exp.spec.encoder_family == "conformer" else exp.spec.w2v_cfg
    wrong = {k: (getattr(enc, k), v) for k, v in cell.config["encoder"].items()
             if hasattr(enc, k) and getattr(enc, k) != v}
    if wrong or exp.spec.encoder_family != cell.config["encoder_family"]:
        raise ValueError(f"the program's encoder differs from {cell.config['name']}: {wrong}")
    return exp


def _activities(device):
    if torch.device(device).type == "cuda":
        return [torch.profiler.ProfilerActivity.CUDA]
    return [torch.profiler.ProfilerActivity.CPU]


def _peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" else 0


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_setup: float, device="cuda") -> dict:
    """Everything a run reports, as a dict (run.py prints it). Set-up is
    timed from `t_setup` (perf_counter at the process's start);
    `setup_parts` splits it at its stages' ends."""
    parts = {"start": time.perf_counter() - t_setup}
    device = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="port_bench_", dir=os.environ.get("TMPDIR")) as work:
        log = os.path.join(work, "program.log")
        sessions = traffic_gen.make_sessions(cell.traffic, seed)
        splits = traffic_gen.write_splits(sessions, os.path.join(work, "t12"))
        parts["data"] = time.perf_counter() - t_setup
        with program_output(log):
            exp = build_experiment(cell, seed, work, device)
        # every split is in the program's memory now: the files go before the kernel writes them back, so
        # a run writes no split to disk and no writeback falls into the window
        shutil.rmtree(splits)
        parts["experiment"] = time.perf_counter() - t_setup
        params, state = weights.make(cell.config, seed, device)
        exp.adopt_params(params, state)
        parts["weights"] = time.perf_counter() - t_setup
        # the weights as made (views of one buffer): the train check measures each leaf's change from them
        p0 = dict(leaves(params)) if cell.kind == "train" else None
        del params, state
        program = _drive(cell, exp, p0, seed, seconds, trace, device, log, t_setup)
        program["setup_parts"] = dict(parts, warm=program["setup_s"])
        del exp, p0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from port_bench import check

    t_check = time.perf_counter()
    readings = check.readings(cell, sessions, program, seed, device)
    program["check_s"] = time.perf_counter() - t_check
    program["readings"] = readings
    return program


def _drive(cell: Cell, exp, p0, seed, seconds, trace, device, log, t_setup) -> dict:
    """Set-up's steps, the window and (traced runs) the profiler's reduction;
    returns host data only, so the program's state can be freed."""
    from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer

    kind = cell.kind
    trainer = Trainer(exp)
    win = Window(device, trace_steps=TRACE_STEPS[kind] if trace else 0, trace_after=0.4 * seconds)
    out: dict = {"kind": kind}
    if kind == "train":
        enc = cell.config["encoder"]
        trainer.rng = bench_seeds.bench_rng(seed, device, enc["num_hidden_layers"], enc["layerdrop"])
        check = _TrainCheck(exp, p0, cell.traffic["check_steps"])
        del p0
        wrap_trainer(trainer, win, kind, on_step=check.on_step)
        loader, epoch = exp.dataloader_train, cell.config["first_epoch"]
        win.limit = cell.traffic["check_steps"]
        with program_output(log):
            trainer._train_epoch(loader, epoch)
        _sync(device)
        out["check"] = check.result(trainer.rng, epoch)
        del check
        win.limit = None
        run_pass = lambda e: trainer._train_epoch(loader, e)  # noqa: E731
        epoch += 1
    else:
        captured: Dict[int, tuple] = {}
        sample: set = set()

        def on_eval(rec, outs):
            if rec["index"] in sample:
                _, logits, logit_lens, pred_ids, _ = outs
                captured[rec["index"]] = (logits, logit_lens, pred_ids, rec)

        wrap_trainer(trainer, win, kind, on_step=on_eval)
        win.timing = True  # the warm-up pass's records choose the sample
        with program_output(log):
            exp._predict(trainer, "test")
        _sync(device)
        warm = list(win.steps)
        win.steps, win.timing = [], False
        sample.update(_serve_sample(warm, seed, cell.traffic["check_batches"]))
        out["sample"] = sorted(sample)
        run_pass = lambda e: exp._predict(trainer, "test")  # noqa: E731
        epoch = 0
    if trace:  # the profiler's first start (CUPTI's set-up) belongs to set-up
        with torch.profiler.profile(activities=_activities(device)):
            torch.zeros(1, device=device).add_(1)
            _sync(device)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out["setup_s"] = time.perf_counter() - t_setup
    win.timing = True
    win.t0 = time.perf_counter()
    win.deadline = win.t0 + seconds
    with program_output(log):
        while time.perf_counter() < win.deadline:
            run_pass(epoch)
            epoch += 1
    _sync(device)
    win.maybe_stop_trace(force=True)
    out["window_s"] = time.perf_counter() - win.t0 - win.stop_s
    win.timing = False
    out["steps"] = [{k: v for k, v in s.items() if k != "launches"} for s in win.steps]
    out["memory_peak_bytes"] = _peak_bytes(device)
    if kind == "train":
        out["layerdrop"] = [d.layerdrop for d in trainer.rng.draws[cell.traffic["check_steps"]:]]
    else:
        out["captured"] = {i: (lg.detach().float().cpu(), ll.cpu(), pi.cpu(), rec)
                           for i, (lg, ll, pi, rec) in captured.items()}
    if win.prof is not None:
        from port_bench import trace as bench_trace

        out["trace"] = bench_trace.reduce(win.prof, win.span_ns, win.host_spans, win.traced)
    return out


def _serve_sample(warm: List[dict], seed: int, n: int) -> List[int]:
    """The batch indices of a pass that the check compares: the one holding
    the longest trial, and n - 1 more drawn from the seed."""
    longest = max(range(len(warm)), key=lambda i: max(warm[i]["lens"]))
    rest = [i for i in range(len(warm)) if i != longest]
    rng = np.random.default_rng([int(seed), 3])
    return [longest] + rng.choice(rest, size=min(n - 1, len(rest)), replace=False).tolist()


class _TrainCheck:
    """What set-up's first steps leave for the check: each step's loss, the
    rows of its batch, the norm of every leaf's first gradient as Adam got
    it (its first moment over 1 - B1) and of every leaf's change over the
    steps (against `p0`, the weights the benchmark made, by path)."""

    def __init__(self, exp, p0: dict, steps: int):
        self.exp, self.p0, self.steps = exp, p0, steps
        self.losses, self.batches = [], []
        self.grad_norms = self.delta_norms = None

    @torch.no_grad()
    def on_step(self, rec, out):
        if len(self.losses) >= self.steps:
            return
        self.losses.append(out.loss.detach().clone())
        self.batches.append({"days": rec["days"], "lens": rec["lens"], "rows": rec["batch_rows"]})
        if len(self.losses) == 1:
            mu = dict(leaves(out.opt_state.mu))
            self.grad_norms = {p: torch.linalg.vector_norm(m.float()) / (1.0 - B1) for p, m in mu.items()}
        if len(self.losses) == self.steps:
            self.delta_norms = {p: torch.linalg.vector_norm(t.float() - self.p0[p])
                                for p, t in leaves(self.exp.params) if p in self.grad_norms}
            self.p0 = None  # the buffer is freed before the window

    def result(self, rng, epoch: int) -> dict:
        return {"losses": [float(x) for x in self.losses], "batches": self.batches, "epoch": epoch,
                "grad_norms": {p: float(v) for p, v in self.grad_norms.items()},
                "delta_norms": {p: float(v) for p, v in self.delta_norms.items()},
                "draws": rng.draws[: self.steps], "noise_seed": rng.noise_seed}



def forbidden_modules() -> List[str]:
    banned = {"jax", "jaxlib", "flax", "wav2vec2forbrain_tpu"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & banned)
