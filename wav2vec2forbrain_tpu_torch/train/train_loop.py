"""A minimal per-batch training loop (the inner step loop of the JAX
package's train/train_loop.py::Trainer._train_epoch, without epochs, early
stopping or checkpoints).

train_batches takes one train step per host batch at the given per-group
LRs and records each step's loss and the greedy WER/CER of its train
predictions in a SingleEpochHistory, as the Trainer's train evaluator does.
Like the Trainer it is lag-1 pipelined: step i+1 is enqueued on the device
before step i's outputs are fetched and decoded on the host.
"""

from typing import Any, Iterable, NamedTuple

from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch, to_device
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer
from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
from wav2vec2forbrain_tpu_torch.train.evaluator import GreedyEvaluator
from wav2vec2forbrain_tpu_torch.train.history import SingleEpochHistory


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
