"""Train and eval steps (counterpart of wav2vec2forbrain_tpu/train/steps.py).

The JAX package builds its steps once per experiment, closed over the static
ModelSpec; `build_eval_step` and `build_train_step` do the same. PyTorch
runs eagerly, so there is nothing to compile.

The train step (JAX `build_step_fns.train_step`):
- white-noise and constant-offset augmentation of the input, drawn from the
  step's StepRng (models/seeds.py), then forward_with_loss(train=True) with
  the step's ForwardRng;
- gradients by autograd over the trainable leaves: a frozen leaf gets
  requires_grad=False, except when gradient clipping is on, when the norm
  covers the full tree, frozen gradients included (torch clip_grad_norm_
  over model.parameters());
- the Adam step (train/optim.py) at the host's per-group LRs.
Unlike the JAX step, which returns new arrays, the port updates the params
and the optimizer moments in place and returns the same objects.

Data parallelism (`shard`, parallel/mesh.py::DataShard): the batch is this
rank's rows of the global batch, whose "mean" denominator the caller gives
as `mask_total`. The step then computes what the JAX step computes on the
whole batch over a ('data', 'model') = (dp, 1) mesh: the noise drawn at the
global shape and sliced, the dropout masks at the global rows and the
BatchNorm statistics over every rank's rows (the streams' row0 and group,
models/seeds.py), the loss and its metrics summed over the ranks
(models/assembly.py::forward_with_loss), and the gradients SUM-all-reduced
in flat buckets before the norm and the clipping see them. That
all-reduce is also what the JAX package's kernel partitioning
(parallel/kernel_partition.py) adds: every kernel runs on the rank's local
rows, and the batch-summed weight gradients (the GRU's dW, preproc's per-day
dW, conv_glu's dK) are summed over the ranks with the rest.

--remat_policy=auto on the card (`RematAuto`, the counterpart of the JAX
impl.py::_resolve_remat_policy): the train steps choose the policy as they
run, with no step of their own. The JAX chooser compiles each candidate
ahead of time and asks XLA for its memory; eager PyTorch cannot know a
step's peak without running it. So the first of models/remat.py::
AUTO_CANDIDATES (none) runs, and a step whose batch shape has not yet run
under the current policy is watched: after its forward and backward the
allocator's peak since the policy took over (the footprint: params, Adam
moments and resident splits are allocated already) must be within the
budget. The peak counter is reset only when the policy changes, so a run
that stays under none leaves it as a run at --remat_policy=none does. One
that passes the budget
moves the later steps to the next candidate (its own result stands: every
policy computes the same step, bitwise); one that runs out of memory is
freed, its StepRng rewound, and run again under the next candidate, before
the optimizer has touched anything. A step that does not fit under the
last candidate raises. Under data or tensor parallelism the ranks OR their
verdicts (`distributed.any_across`), so all take the same policy; the ranks
run the same shapes, so an out-of-memory error strikes them at the same
allocation (a rank that ran out alone would leave the others waiting in the
step's collectives).

Tensor parallelism (`shard.model`, parallel/tensor.py): the params are this
rank's pieces, the rows those of its data index, and every collective
above runs over the data group (`shard.group`); the encoder's blocks
reduce over the model group themselves. The gradient norm sums the split
leaves' squares over the model group (train/optim.py::global_norm).
"""

import dataclasses
import gc
from typing import Any, NamedTuple, Optional

import torch

from wav2vec2forbrain_tpu_torch.models import remat
from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec, forward_with_loss
from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
from wav2vec2forbrain_tpu_torch.parallel import distributed
from wav2vec2forbrain_tpu_torch.train.optim import Optimizer, clip_by_global_norm, global_norm
from wav2vec2forbrain_tpu_torch.tree import tree_leaves, tree_map


class StepConfig(NamedTuple):
    gradient_clipping: Optional[float]
    white_noise_sd: float
    constant_offset_sd: float


class TrainStepOut(NamedTuple):
    params: Any
    opt_state: Any
    model_state: Any
    loss: torch.Tensor
    pred_ids: torch.Tensor  # greedy argmax on the device
    logit_lens: torch.Tensor
    rng: StepRng
    # ctc/intermediate/combined losses with the aux head; {} otherwise
    metrics: Any = {}


def build_eval_step(spec: ModelSpec, shard=None):
    """eval_step(params, state, batch, mask_total=None) -> (loss, logits,
    logit_lens, pred_ids, metrics); batch is a data.batch.B2tBatch of
    tensors on the params' device. With a shard: the loss and the metrics
    are the global batch's, the rest this rank's rows'."""
    group = None if shard is None else shard.group
    tp = None if shard is None else shard.model

    def eval_step(params, state, batch, mask_total=None):
        with torch.inference_mode():
            out = forward_with_loss(
                params,
                state,
                spec,
                batch.input,
                batch.day_idxs,
                batch.input_lens,
                batch.target,
                batch.target_lens,
                train=False,
                sample_mask=batch.sample_mask,
                mask_total=mask_total,
                group=group,
                tp=tp,
            )
            loss = out["loss"]
            if loss is None:
                loss = torch.zeros((), dtype=torch.float32, device=out["logits"].device)
            pred_ids = torch.argmax(out["logits"], dim=-1).to(torch.int32)
        return loss, out["logits"], out["logit_lens"], pred_ids, out["metrics"]

    return eval_step


def build_grad_fn(spec: ModelSpec, labels, step_cfg: StepConfig, shard=None):
    """grad_fn(params, model_state, batch, rng, mask_total=None) -> (out,
    grads, norm): the train step up to the optimizer. out is
    forward_with_loss's dict; grads a tree like params (None at frozen
    leaves, and at leaves the forward did not reach), summed over the ranks
    with a shard; norm the global gradient norm (over the full tree when
    clipping is on), before clipping; grads are clipped when clipping is
    on. With a shard, mask_total (the global batch's sample_mask sum, or its
    row count) is required."""
    clip = step_cfg.gradient_clipping
    tp = None if shard is None else shard.model

    def grad_fn(params, model_state, batch, rng: StepRng, mask_total=None):
        global_b = batch.input.shape[0]
        rows = group = None
        if shard is not None:
            if mask_total is None:
                raise ValueError("a data-parallel step needs the global batch's mask_total")
            global_b *= shard.size
            rows, group = shard.rows(global_b), shard.group
        fwd_rng = rng.next_forward(0 if rows is None else rows.start, group)
        x = batch.input.float()
        if step_cfg.white_noise_sd > 0:
            x = x + rng.normal((global_b, *x.shape[1:]), x.device, rows) * step_cfg.white_noise_sd
        if step_cfg.constant_offset_sd > 0:
            x = x + rng.normal((global_b, 1, x.shape[2]), x.device, rows) * step_cfg.constant_offset_sd

        def need(p, label):
            p.requires_grad_(label != "frozen" or clip is not None)

        tree_map(need, params, labels)
        out = forward_with_loss(
            params, model_state, spec, x, batch.day_idxs, batch.input_lens,
            batch.target, batch.target_lens, rng=fwd_rng, train=True,
            sample_mask=batch.sample_mask, mask_total=mask_total, group=group, tp=tp,
        )
        leaves = [p for p in tree_leaves(params) if p.requires_grad]
        found = torch.autograd.grad(out["loss"], leaves, allow_unused=True)
        if shard is not None and shard.size > 1:  # the same leaves on every rank: LayerDrop's decisions are shared
            distributed.all_reduce_tensors([g for g in found if g is not None], group)
        by_id = {id(p): g for p, g in zip(leaves, found)}
        grads = tree_map(lambda p: by_id.get(id(p)), params)
        if clip is not None:
            grads, norm = clip_by_global_norm(grads, clip, tp=tp)
            grads = tree_map(lambda g, label: None if label == "frozen" else g, grads, labels)
        else:
            norm = global_norm(grads, tp)
        return out, grads, norm

    return grad_fn


class RematAuto:
    """--remat_policy=auto's choice, made by the train steps (this module's
    header). `policy` is the one the next step runs; `budget` in bytes."""

    def __init__(self, budget: float, device):
        self.budget, self.device = budget, device
        self.policy = remat.AUTO_CANDIDATES[0]
        self.fitted = set()  # batch shapes a step has run within the budget under `policy`

    @staticmethod
    def key(batch):
        return tuple(batch.input.shape), tuple(batch.target.shape)

    def reset_peak(self) -> None:
        torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device)

    def free(self) -> None:
        """Return a failed step's memory (its frames may sit in cycles)."""
        gc.collect()
        torch.cuda.empty_cache()

    def settle(self, batch, ran: bool) -> bool:
        """After a watched step's forward and backward (`ran`: not out of
        memory): True to run it again under the next policy."""
        peak = self.peak() if ran else None
        out_of_memory, over = distributed.any_across([not ran, ran and peak > self.budget], self.device)
        last = self.policy == remat.AUTO_CANDIDATES[-1]
        at = f"a step at batch {tuple(batch.input.shape)} under {self.policy}"
        if out_of_memory:
            if last:
                raise torch.OutOfMemoryError(f"remat_policy=auto: {at} ran out of memory, the last candidate")
            self.free()
            self._next(f"{at} ran out of memory; run again under")
            return True
        if over and not last:
            self._next(f"{at} peaked at {peak / 2**30:.2f} GiB, over the budget of {self.budget / 2**30:.2f} GiB; "
                       "the next steps run under")
            return False
        if not self.fitted:
            print(f"remat_policy=auto: {self.policy} ({at} peaked at {peak / 2**30:.2f} GiB, budget "
                  f"{self.budget / 2**30:.2f} GiB)")
        self.fitted.add(self.key(batch))
        return False

    def _next(self, why: str) -> None:
        self.policy = remat.AUTO_CANDIDATES[remat.AUTO_CANDIDATES.index(self.policy) + 1]
        self.fitted = set()
        self.reset_peak()
        print(f"remat_policy=auto: {why} {self.policy}")


def build_train_step(spec: ModelSpec, labels, optimizer: Optimizer, step_cfg: StepConfig, shard=None,
                     auto: Optional[RematAuto] = None):
    """train_step(params, opt_state, model_state, batch, rng, brain_lr,
    w2v_lr, mask_total=None) -> TrainStepOut (JAX: build_step_fns'
    train_step). labels is the param_labels tree the optimizer was made
    with; rng a StepRng; shard and mask_total as build_grad_fn's (the
    optimizer carries ZeRO-1, train/optim.py). pred_ids and logit_lens are
    this rank's rows'. With `auto`, each step runs under auto.policy
    instead of spec.remat_policy, and watched steps settle it (the header)."""
    grad_fns = {}

    def grad_fn(policy):
        if policy not in grad_fns:
            grad_fns[policy] = build_grad_fn(dataclasses.replace(spec, remat_policy=policy), labels, step_cfg, shard)
        return grad_fns[policy]

    def train_step(params, opt_state, model_state, batch, rng: StepRng, brain_lr, w2v_lr,
                   mask_total=None) -> TrainStepOut:
        if auto is None or RematAuto.key(batch) in auto.fitted:
            out, grads, _ = grad_fn(spec.remat_policy if auto is None else auto.policy)(
                params, model_state, batch, rng, mask_total)
        else:
            while True:
                mark = rng.mark()
                try:
                    out, grads, _ = grad_fn(auto.policy)(params, model_state, batch, rng, mask_total)
                except torch.OutOfMemoryError:
                    out = grads = None
                if not auto.settle(batch, out is not None):
                    break
                rng.rewind(mark)
        new_opt_state = optimizer.step(params, grads, opt_state, brain_lr, w2v_lr)
        metrics = {k: v.detach() for k, v in out["metrics"].items()}
        return TrainStepOut(
            params,
            new_opt_state,
            out["state"],
            out["loss"].detach(),
            torch.argmax(out["logits"].detach(), dim=-1).to(torch.int32),
            out["logit_lens"],
            rng,
            metrics,
        )

    return train_step
