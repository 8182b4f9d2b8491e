"""Serving entry point: prediction over a list of batches (counterpart of
wav2vec2forbrain_tpu/experiments/impl.py::_predict).

For each host batch: move it to the params' device, run the eval step
(preprocessing -> biGRU -> FC -> conformer -> CTC head + loss), fetch loss,
logits, logit_lens and greedy ids, and feed them to the greedy evaluator.
Returns the SingleEpochHistory (loss, word_error_rate, char_error_rate).

Usage:
    from wav2vec2forbrain_tpu_torch.predict import predict
    history = predict(params, state, spec, host_batches)
    history.get_average()
"""

from typing import Callable, Iterable, Optional

from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch, to_device
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer
from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec
from wav2vec2forbrain_tpu_torch.ops import select
from wav2vec2forbrain_tpu_torch.train.evaluator import GreedyEvaluator
from wav2vec2forbrain_tpu_torch.train.history import SingleEpochHistory
from wav2vec2forbrain_tpu_torch.train.steps import build_eval_step


def predict(
    params: dict,
    state: dict,
    spec: ModelSpec,
    batches: Iterable[B2tBatch],
    on_batch: Optional[Callable[[int, dict], None]] = None,
) -> SingleEpochHistory:
    """Run every host batch (numpy B2tBatch) through the eval step and the
    evaluator. on_batch(i, preds), if given, sees each batch's host-side
    predictions dict (loss, pred_ids, logits, logit_lens, metrics). TF32
    is turned off for cuBLAS and cuDNN (select.f32_products)."""
    select.f32_products()
    device = params["w2v"]["lm_head"]["kernel"].device
    eval_step = build_eval_step(spec)
    evaluator = GreedyEvaluator(Wav2Vec2CTCTokenizer())
    for i, host_batch in enumerate(batches):
        loss, logits, logit_lens, pred_ids, metrics = eval_step(
            params, state, to_device(host_batch, device)
        )
        preds = {
            "loss": float(loss),
            "pred_ids": pred_ids.cpu().numpy(),
            "logits": logits.cpu().numpy(),
            "logit_lens": logit_lens.cpu().numpy(),
            "metrics": metrics,
        }
        evaluator.track_batch(preds, host_batch)
        if on_batch is not None:
            on_batch(i, preds)
    return evaluator.history
