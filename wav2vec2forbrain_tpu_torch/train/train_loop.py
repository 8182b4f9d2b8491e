"""Training loops (counterpart of wav2vec2forbrain_tpu/train/train_loop.py).

- `train_batches`: the bare per-batch loop (one train step per host batch
  at given LRs, with the train evaluator's history), for callers that hold
  a model without an experiment (profile_train.py, chip_smoke.py).
- `Trainer`: the JAX Trainer in its single-process, single-device form:
  epochs at the per-epoch LRs of train/optim.py's schedules, val every
  epoch, early stopping with patience and delta, the best model by a val
  metric kept under cache_dir/model_checkpoints/<uuid>/ and reloaded,
  --train_on_val_once, the test evaluation, and periodic full train-state
  checkpoints (--checkpoint_every_n_epochs) that --resume_train_state
  continues exactly; --resume_train_state also takes the JAX package's
  train_state/state.msgpack (train/jax_train_state.py).

Both are lag-1 pipelined: step i+1 is enqueued on the device before step
i's outputs are fetched and decoded on the host. `Trainer._put` pads a
ragged batch's rows up to --batch_size with masked duplicates of its last
row (the loss and the metrics ignore them; in train mode the conformer's
BatchNorm batch statistics see them, as in the JAX package), pads the time
and target axes to the split's width under --device_data_cache (the
experiment's `batch_widths`; with --length_buckets the time axis to the
batch's bucket, `t_buckets`) and applies the --h2d_dtype host cast. Where
the test evaluator decodes with an LM, each test batch's logits come to
the host with its ids.

Data parallelism (torchrun, parallel/): every rank loads the same global
batch; `_place` pads its rows to --batch_size rounded up to the data axis
(as the JAX Trainer._put), picks the width from the whole batch (the
BatchNorm statistics count pad frames, so the ranks must agree), and keeps
the rank's rows. The steps return the global loss and metrics; the ranks'
predicted ids (and logits, where they are needed) are gathered, so every
rank tracks the same history and takes the same early-stopping and
best-model decisions. Rank 0 alone writes files (the best model, the train
state, whose ZeRO-1 moments are gathered first so the file keeps the whole
layout), each write followed by a barrier; every rank reads back.

Tensor parallelism (parallel/tensor.py): the params and the moments are
this rank's model-axis pieces. Every file holds the whole tree: the ranks
gather the pieces over the model group (and the moments first over the
data group, under ZeRO-1) before rank 0 writes, and every reader splits
the whole tree again, so a file written at one (dp, mp) reads at any
other. The gathered outputs are the data group's rows: the ranks of a
model group hold the same ones.

An epoch the JAX package runs in K-step chunks (K =
experiment.resolve_multi_step_chunk() >= 2, batches at the split's widths)
visits its batches in the chunks' order (`_epoch_batches`,
train/buckets.py::chunk_order): sorted by width for val and test (unless
the LM decode needs the logits) and for train epochs under
--length_bucket_order=grouped. Each batch and each step is the same;
only the order of the optimizer steps and of the per-batch history moves.

Left out, being XLA- or TPU-only: the K-step chunks themselves, the bucket
precompile and the host prefetch thread.
"""

import json
import os
import time
from typing import Any, Iterable, Literal, NamedTuple

import numpy as np
import torch

from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch, to_device
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer
from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
from wav2vec2forbrain_tpu_torch.parallel import distributed
from wav2vec2forbrain_tpu_torch.parallel.mesh import padded_rows
from wav2vec2forbrain_tpu_torch.parallel.tensor import gather_tree, split_tree
from wav2vec2forbrain_tpu_torch.train.buckets import chunk_order, width_for
from wav2vec2forbrain_tpu_torch.train.checkpoint import copy_into, load_into, load_tree, save_checkpoint, save_tree, to_cpu
from wav2vec2forbrain_tpu_torch.train.evaluator import GreedyEvaluator
from wav2vec2forbrain_tpu_torch.train.history import EpochLosses, SingleEpochHistory, TrainHistory
from wav2vec2forbrain_tpu_torch.train.jax_train_state import read_jax_train_state
from wav2vec2forbrain_tpu_torch.train.optim import AdamState
from wav2vec2forbrain_tpu_torch.util.profiling import StepTimer

WIRE_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


def train_state_file(path: str) -> str:
    """The train-state file a --resume_train_state path names: the path
    itself, or the one of state.pt and state.msgpack its directory holds."""
    if not os.path.isdir(path):
        return path
    found = [os.path.join(path, name) for name in ("state.pt", "state.msgpack")
             if os.path.exists(os.path.join(path, name))]
    if len(found) > 1:
        raise ValueError(f"{path} holds both {found[0]} and {found[1]}: name the file to resume")
    if not found:
        raise FileNotFoundError(f"{path} holds neither state.pt nor state.msgpack")
    return found[0]


class TrainBatchesOut(NamedTuple):
    params: Any  # the same tree, updated in place
    opt_state: Any
    model_state: Any
    history: SingleEpochHistory
    steps: int


def train_batches(
    train_step,
    params: dict,
    opt_state,
    model_state: dict,
    batches: Iterable[B2tBatch],
    rng: StepRng,
    brain_lr: float,
    w2v_lr: float,
) -> TrainBatchesOut:
    """One train_step (train/steps.py::build_train_step) per host batch
    (numpy B2tBatch, moved to the params' device)."""
    device = next(iter(params["w2v"]["lm_head"].values())).device
    evaluator = GreedyEvaluator(Wav2Vec2CTCTokenizer())
    pending = None
    steps = 0

    def process(out, host_batch):
        preds = {
            "loss": float(out.loss),
            "pred_ids": out.pred_ids.cpu().numpy(),
            "logit_lens": out.logit_lens.cpu().numpy(),
            "metrics": {k: float(v) for k, v in out.metrics.items()},
        }
        evaluator.track_batch(preds, host_batch)

    for host_batch in batches:
        out = train_step(params, opt_state, model_state, to_device(host_batch, device), rng, brain_lr, w2v_lr)
        opt_state, model_state = out.opt_state, out.model_state
        steps += 1
        if pending is not None:
            process(*pending)
        pending = (out, host_batch)
    if pending is not None:
        process(*pending)
    return TrainBatchesOut(params, opt_state, model_state, evaluator.history, steps)


def pad_rows(batch: B2tBatch, rows: int) -> B2tBatch:
    """Pad batch rows up to `rows` with masked duplicates of row -1."""
    b = batch.input.shape[0]
    pad = rows - b
    if pad <= 0:
        return batch

    def rep(a):
        return None if a is None else np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)

    mask = np.concatenate([
        batch.sample_mask if batch.sample_mask is not None else np.ones((b,), np.float32),
        np.zeros((pad,), np.float32),
    ])
    return B2tBatch(rep(batch.input), rep(batch.target), rep(batch.day_idxs), rep(batch.input_lens),
                    rep(batch.target_lens), mask)


def pad_width(batch: B2tBatch, t: int, u: int, time_axis: int = 0, pad_id: int = 0) -> B2tBatch:
    """Zero-pad the input's time axis to t and the targets to u (pad_id)."""
    x = batch.input
    widths = [(0, 0)] * x.ndim
    widths[1 + time_axis] = (0, t - x.shape[1 + time_axis])
    target = batch.target
    if target is not None and target.shape[1] < u:
        target = np.pad(target, ((0, 0), (0, u - target.shape[1])), constant_values=pad_id)
    return batch._replace(input=np.pad(x, widths), target=target)


class Trainer:
    shard = None  # parallel/mesh.py::DataShard under data parallelism
    zero = None  # parallel/zero.py::Zero1 under ZeRO-1

    def __init__(self, experiment):
        self.experiment = experiment
        self.config = experiment.base_config
        self.yaml_config = experiment.yaml_config
        self.logger = experiment.logger
        self.device = experiment.device

        self.train_step = experiment.train_step
        self.eval_step = experiment.eval_step
        self.lr_schedules = experiment.lr_schedules

        # state: params and the Adam moments are updated in place by the
        # step; the BatchNorm state is replaced every train step
        self.params = experiment.params
        self.opt_state = experiment.opt_state
        self.model_state = experiment.model_state
        self.rng = experiment.step_rng

        self.dataloader_train = experiment.dataloader_train
        self.dataloader_val = experiment.dataloader_val
        self.dataloader_test = experiment.dataloader_test

        self.step_timer = StepTimer()
        self.shard = experiment.shard
        self.tp = None if self.shard is None else self.shard.model  # parallel/tensor.py::TensorShard
        self.zero = experiment.optimizer.zero
        self.chunk_k = experiment.resolve_multi_step_chunk()

    # --- helpers ------------------------------------------------------------

    def _put(self, batch: B2tBatch, split: str) -> tuple:
        """(padded device batch, true row count) for a host batch of `split`."""
        return self._place(batch, split)[:2]

    def _place(self, batch: B2tBatch, split: str) -> tuple:
        """(device batch, true row count, mask_total): the host batch padded
        and widened; under data parallelism its rows of this rank, and the
        global batch's "mean" denominator (None in one process)."""
        true_b = batch.input.shape[0]
        dp = 1 if self.shard is None else self.shard.size
        batch = pad_rows(batch, padded_rows(self.config.batch_size, true_b, dp))
        width = self.experiment.batch_widths.get(split)
        if width is not None:
            t, u = width
            buckets = self.experiment.t_buckets.get(split)
            if buckets:
                t = width_for(buckets, int(batch.input_lens.max()))
            batch = pad_width(batch, t, u, time_axis=self.experiment.time_axis,
                              pad_id=self.experiment.tokenizer.pad_token_id)
        mask_total = None
        if self.shard is not None:
            rows = batch.input.shape[0]
            mask_total = float(rows if batch.sample_mask is None else batch.sample_mask.sum())
            mine = self.shard.rows(rows)
            batch = B2tBatch(*(None if a is None else a[mine] for a in batch))
        dev = to_device(batch._replace(input=None), self.device)
        x = torch.from_numpy(np.ascontiguousarray(batch.input)).to(WIRE_DTYPES[self.config.h2d_dtype])
        return dev._replace(input=x.to(self.device)), true_b, mask_total

    def _epoch_batches(self, loader, split: str, grouped: bool):
        """The epoch's host batches: in the loader's order, or, where the
        JAX package would chunk this epoch, in the chunks' order (the same
        batches from the same shuffle stream; sorted by width where
        `grouped`)."""
        widths = self.experiment.batch_widths.get(split)
        if self.chunk_k < 2 or widths is None:
            return loader
        index_batches = list(loader.iter_index_batches())
        buckets = self.experiment.t_buckets.get(split)
        lengths = self.experiment.sample_lengths[split]
        t = [width_for(buckets, max(lengths[i] for i in idxs)) if buckets else widths[0] for idxs in index_batches]
        return (loader.collate_fn([loader.dataset[i] for i in index_batches[j]]) for j in chunk_order(t, grouped))

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """A step output's rows of the global batch (every rank's, gathered)."""
        return x if self.shard is None else distributed.gather_rows(x, self.shard.group)

    def _log_intermediate(self, i: int, n: int, evaluator):
        print(
            f"Batch {i + 1}/{n} loss: {evaluator.get_latest_loss():.2f} "
            f"running: {evaluator.get_running_loss():.2f}\r",
            end="",
        )

    def _track(self, evaluator, preds, host_batch, i, n):
        evaluator.track_batch(preds, host_batch)
        every = self.config.log_every_n_batches
        if i % every == every - 1:
            self._log_intermediate(i, n, evaluator)

    def _train_epoch(self, data_loader, epoch: int, split: str = "train") -> SingleEpochHistory:
        evaluator = self.experiment.create_evaluator("train")
        brain_lr = float(self.lr_schedules.brain(epoch))
        w2v_lr = float(self.lr_schedules.w2v(epoch))
        n = len(data_loader)
        pending = None
        epoch_samples = 0
        t_epoch = time.perf_counter()

        def process(out, host_batch, true_b, i):
            preds = {
                "loss": float(out.loss),
                "pred_ids": self._rows(out.pred_ids)[:true_b].cpu().numpy(),
                "logit_lens": self._rows(out.logit_lens)[:true_b].cpu().numpy(),
            }
            if out.metrics:
                preds["metrics"] = {k: float(v) for k, v in out.metrics.items()}
            self._track(evaluator, preds, host_batch, i, n)

        grouped = self.config.length_bucket_order == "grouped"
        for i, host_batch in enumerate(self._epoch_batches(data_loader, split, grouped)):
            batch, true_b, mask_total = self._place(host_batch, split)
            out = self.train_step(self.params, self.opt_state, self.model_state, batch, self.rng, brain_lr, w2v_lr,
                                  mask_total)
            self.opt_state = out.opt_state
            self.model_state = out.model_state
            self.rng.forwards.clear()  # the step's seed streams are spent
            epoch_samples += true_b
            if pending is not None:
                process(*pending)
            pending = (out, host_batch, true_b, i)
        if pending is not None:
            process(*pending)
        dt_epoch = time.perf_counter() - t_epoch
        if epoch_samples:
            self.step_timer.add(dt_epoch, epoch_samples, steps=n)
        results = evaluator.evaluate()
        evaluator.clean_up()
        return results

    def _evaluate_epoch(self, mode: Literal["val", "test"]) -> SingleEpochHistory:
        dataloader = self.dataloader_val if mode == "val" else self.dataloader_test
        evaluator = self.experiment.create_evaluator(mode)
        # every rank gathers what rank 0's LM decode needs (a collective)
        need_logits = mode == "test" and self.config.lm_decode_test_predictions
        n = len(dataloader)
        pending = None

        def process(outs, host_batch, true_b, i):
            loss, logits, logit_lens, pred_ids, metrics = outs
            preds = {"loss": float(loss), "pred_ids": self._rows(pred_ids)[:true_b].cpu().numpy()}
            if metrics:
                preds["metrics"] = {k: float(v) for k, v in metrics.items()}
            preds["logit_lens"] = self._rows(logit_lens)[:true_b].cpu().numpy()
            if need_logits:
                preds["logits"] = self._rows(logits)[:true_b].cpu().numpy()
            self._track(evaluator, preds, host_batch, i, n)

        for i, host_batch in enumerate(self._epoch_batches(dataloader, mode, not need_logits)):
            batch, true_b, mask_total = self._place(host_batch, mode)
            outs = self.eval_step(self.params, self.model_state, batch, mask_total)
            if pending is not None:
                process(*pending)
            pending = (outs, host_batch, true_b, i)
        if pending is not None:
            process(*pending)
        results = evaluator.evaluate()
        evaluator.clean_up()
        return results

    def _get_wandb_metrics(self, epoch_hist: SingleEpochHistory, prefix: str):
        avg = epoch_hist.get_average()
        metrics = {f"{prefix}_{self.config.loss_function}_loss": avg.loss}
        metrics.update({f"{prefix}_{k}": v for k, v in avg.metrics.items()})
        return metrics

    # --- periodic full train-state checkpoints --------------------------------

    def _train_state_path(self) -> str:
        return os.path.join(self.experiment.results_dir, "train_state", "state.pt")

    def _save_train_state(self, epoch: int, history: list):
        """params, BN state, optimizer state, the step RNG's generators and
        the loaders' shuffle streams: a resumed run continues exactly. The
        moments are written whole (ZeRO-1's pieces gathered by every rank),
        so the file resumes at any data-parallel width."""
        path = self._train_state_path()
        opt = self.opt_state
        mu, nu = opt.mu, opt.nu
        if self.zero is not None and mu is not None:
            mu, nu = self.zero.full_moments(mu, self.params), self.zero.full_moments(nu, self.params)
        params, mu, nu = (gather_tree(t, self.tp) for t in (self.params, mu, nu))
        if not distributed.is_coordinator():
            distributed.barrier("train state written")
            return
        bundle = {
            "params": to_cpu(params),
            "state": to_cpu(self.model_state),
            "opt": {"count": int(opt.count), "mu": to_cpu(mu), "nu": to_cpu(nu)},
            "rng": {"host": self.rng._host.get_state(), "device": self.rng._device.get_state()},
            "loaders": {
                split: loader.rng_state()
                for split, loader in (("train", self.dataloader_train), ("val", self.dataloader_val),
                                      ("test", self.dataloader_test))
            },
            "epoch": epoch,
        }
        save_tree(path, bundle)
        with open(os.path.join(os.path.dirname(path), "history.json"), "w") as f:
            json.dump(TrainHistory(history, SingleEpochHistory()).to_dict(), f)
        distributed.barrier("train state written")

    def restore_train_state(self, path: str):
        """Returns (next_epoch, history). `path`: a train_state/ directory
        holding state.pt or state.msgpack (not both), or either file.

        The port's state.pt continues exactly: its step RNG generators and
        the loaders' shuffle streams come back too. The JAX package's
        state.msgpack (train/jax_train_state.py) brings the params, BN
        state, Adam moments and count and the epoch, each bitwise; its step
        key is dropped, and the step RNG and the loaders' shuffle streams
        run as a fresh run's from --seed (this runs before any epoch), as
        in the JAX package's own resume, whose loaders start afresh. Both
        read history.json beside the file."""
        path = train_state_file(path)
        if path.endswith(".msgpack"):
            bundle = read_jax_train_state(path, self.config.unfreeze_strategy, self.config.optimizer)
            print(f"Resuming the JAX package's train state {path}: its step key is not carried over; the step "
                  f"RNG and the loaders' shuffle streams start from --seed={self.config.seed} as a fresh run's")
        else:
            bundle = load_tree(path)
        copy_into(self.params, split_tree(bundle["params"], self.tp))
        copy_into(self.model_state, bundle["state"])
        opt = bundle["opt"]
        if self.opt_state.mu is not None:
            mu, nu = (split_tree(opt[k], self.tp) for k in ("mu", "nu"))
            if self.zero is not None:  # the file's whole moments -> this rank's pieces
                mu, nu = self.zero.shard_moments(mu), self.zero.shard_moments(nu)
            copy_into(self.opt_state.mu, mu)
            copy_into(self.opt_state.nu, nu)
        self.opt_state = AdamState(int(opt["count"]), self.opt_state.mu, self.opt_state.nu)
        if "rng" in bundle:
            self.rng._host.set_state(bundle["rng"]["host"])
            self.rng._device.set_state(bundle["rng"]["device"])
            for split, loader in (("train", self.dataloader_train), ("val", self.dataloader_val),
                                  ("test", self.dataloader_test)):
                loader.set_rng_state(bundle["loaders"][split])
        history = []
        hist_path = os.path.join(os.path.dirname(path), "history.json")
        if os.path.exists(hist_path):
            history = list(TrainHistory.from_json(hist_path).epochs)
        return int(bundle["epoch"]) + 1, history

    def _save_model(self, path: str):
        params = gather_tree(self.params, self.tp)
        if distributed.is_coordinator():
            save_checkpoint(path, params, self.model_state)
        distributed.barrier("model written")

    def _load_model(self, path: str):
        load_into(path, self.params, self.model_state, self.tp)

    # --- main loop ----------------------------------------------------------

    def train(self) -> TrainHistory:
        # as in the JAX package, --from_checkpoint pre-seeds `history` (the
        # early-stopping window continues) while the epoch counter and the
        # schedules restart at 0
        history: list = (
            self.experiment.checkpoint_history.epochs if self.experiment.checkpoint_history is not None else []
        )
        best_metric = float("inf" if self.config.minimize_best_model_metric else "-inf")
        best_model_path = os.path.join(
            self.yaml_config.cache_dir, "model_checkpoints", distributed.shared_uuid(), "best_model.pt"
        )
        coordinator = distributed.is_coordinator()
        if coordinator:
            os.makedirs(os.path.dirname(best_model_path), exist_ok=True)
        saved_best = False

        def get_relevant_metric(epoch_hist: SingleEpochHistory):
            avg = epoch_hist.get_average()
            return avg.loss if self.config.best_model_metric == "loss" else avg.metrics[self.config.best_model_metric]

        start_epoch = 0
        if self.config.resume_train_state:
            start_epoch, history = self.restore_train_state(self.config.resume_train_state)
            print(f"Resumed full train state at epoch {start_epoch}")

        last_epoch = 0
        for epoch in range(start_epoch, self.config.epochs):
            last_epoch = epoch + 1
            print(f"\nEpoch {epoch + 1}/{self.config.epochs}")
            train_losses = self._train_epoch(self.dataloader_train, epoch)
            val_losses = self._evaluate_epoch("val")
            print(
                f"\n\n{'=' * 20}\nFinished Epoch {epoch + 1}/{self.config.epochs} "
                f"train {self.config.loss_function}-loss: {train_losses.get_average().loss} "
                f"val {self.config.loss_function}-loss: {val_losses.get_average().loss}"
            )
            history.append(EpochLosses(train_losses, val_losses))
            metrics = self._get_wandb_metrics(val_losses, "val")
            metrics.update(self._get_wandb_metrics(train_losses, "train"))
            metrics.update(self.step_timer.metrics("train", 1))
            self.step_timer.reset()
            self.logger.log(metrics)

            every = self.config.checkpoint_every_n_epochs
            if every is not None and (epoch + 1) % every == 0:
                self._save_train_state(epoch, history)
                if coordinator:
                    print(f"Saved train state at {self._train_state_path()}")

            if self.config.return_best_model:
                curr = get_relevant_metric(val_losses)
                is_better = curr < best_metric if self.config.minimize_best_model_metric else curr > best_metric
                if is_better:
                    best_metric = curr
                    self._save_model(best_model_path)
                    saved_best = True
                    print(f"\n\nSaving model checkpoint at {best_model_path}\n")

            patience = self.config.early_stopping_patience
            if patience is not None and len(history) >= patience:
                window = [get_relevant_metric(e.val_losses) for e in history][-patience:]
                if self.config.minimize_best_model_metric:
                    window[0] -= self.config.early_stopping_delta
                    best_index = int(np.argmin(window))
                else:
                    window[0] += self.config.early_stopping_delta
                    best_index = int(np.argmax(window))
                if best_index == 0:
                    print(
                        f"\nEarly stopping after {epoch} epochs ({patience} epochs without improvement "
                        f"in validation {self.config.best_model_metric} metrics)"
                    )
                    break

        if self.config.return_best_model and saved_best:
            self._load_model(best_model_path)
            distributed.barrier("best model read")
            if coordinator:
                os.remove(best_model_path)
            print("Loaded model with best validation loss of this experiment from disk")
        if coordinator and os.path.isdir(os.path.dirname(best_model_path)):
            os.rmdir(os.path.dirname(best_model_path))

        if self.config.train_on_val_once:
            print("Training one epoch on val set")
            self._train_epoch(self.dataloader_val, last_epoch, split="val")

        test_losses = self._evaluate_epoch("test")
        self.logger.log(self._get_wandb_metrics(test_losses, "test"))
        print(f"\nTest loss ({self.config.loss_function}): {test_losses.get_average().loss}")
        return TrainHistory(history, test_losses)
