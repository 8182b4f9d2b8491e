"""Evaluators: greedy decode + WER/CER per batch (counterpart of
wav2vec2forbrain_tpu/train/evaluator.py).

The same classes and metric names (word_error_rate, char_error_rate) as the
JAX package; tests hold them to the originals on the same predictions. The
evaluators take argmax ids computed on the device; the greedy decode runs at
the batch's max logit length, and with --greedy_decode_crop_lens each
sample's frames past its own length are blanked too. The LM beam-search
decode (`*_lm_decode` metrics) is not ported yet (ROADMAP, Slice 5):
asking for it raises.
"""

from abc import ABC, abstractmethod
from math import isnan, nan
from typing import Callable, Literal, Optional

import numpy as np

from wav2vec2forbrain_tpu_torch.train.history import DecodedPredictionBatch, MetricEntry, SingleEpochHistory
from wav2vec2forbrain_tpu_torch.train.metrics import char_error_rate, word_error_rate

LM_DECODE_NOT_PORTED = (
    "the LM beam-search decode (--lm_decode_test_predictions=true) is not ported yet: "
    "ROADMAP.md, Queue 1, Slice 5 item 6"
)


def cut_after_eos_token(string: str, eos_token: str = "</s>") -> str:
    idx = string.find(eos_token)
    return string[: idx + len(eos_token)] if idx != -1 else string


class Evaluator(ABC):
    """Running and latest loss."""

    def __init__(self, mode: Literal["train", "val", "test"], track_non_test_predictions: bool = False):
        self.mode = mode
        self.track_non_test_predictions = track_non_test_predictions
        self._latest_loss = nan
        self._running_loss = 0.0
        self._running_count = 0

    def track_batch(self, predictions, batch):
        self._latest_loss = float(predictions["loss"])
        self._running_loss += self._latest_loss
        self._running_count += 1
        self._track_batch(predictions, batch)

    def get_latest_loss(self) -> float:
        return self._latest_loss

    def get_running_loss(self) -> float:
        if self._running_count == 0:
            return nan
        return self._running_loss / self._running_count

    @abstractmethod
    def _track_batch(self, predictions, batch): ...

    @abstractmethod
    def evaluate(self) -> SingleEpochHistory: ...

    def clean_up(self):
        pass


class DefaultEvaluator(Evaluator):
    """Greedy decode + WER. `predictions`: loss (float), pred_ids (B, T')
    argmax ids, logit_lens (B,), metrics (dict, optional)."""

    def __init__(self, tokenizer, mode, track_non_test_predictions: bool = False, crop_lens: bool = False):
        super().__init__(mode, track_non_test_predictions)
        self.tokenizer = tokenizer
        self.crop_lens = crop_lens
        self.history = SingleEpochHistory()

    def decode_predictions(self, predictions, batch):
        pred_ids = np.asarray(predictions["pred_ids"])
        if "logit_lens" in predictions:
            lens = np.asarray(predictions["logit_lens"])
            if lens.size:
                pred_ids = pred_ids[:, : max(1, int(lens.max()))]
                if self.crop_lens:
                    pred_ids = np.where(np.arange(pred_ids.shape[1])[None, :] < lens[:, None], pred_ids, 0)
        predicted = self.tokenizer.batch_decode(pred_ids, group_tokens=True)
        labels = (
            self.tokenizer.batch_decode(np.asarray(batch.target), group_tokens=False)
            if batch.target is not None
            else None
        )
        return predicted, labels

    def _stores(self) -> bool:
        return self.mode == "test" or self.track_non_test_predictions

    def _track_batch(self, predictions, batch):
        predicted, labels = self.decode_predictions(predictions, batch)
        predicted = [cut_after_eos_token(s) for s in predicted]
        metrics = dict(predictions.get("metrics") or {})
        if labels is not None:
            metrics["word_error_rate"] = word_error_rate(predicted, labels)
        self.history.add_batch_metric(
            MetricEntry(metrics, float(predictions["loss"])),
            DecodedPredictionBatch(predicted, labels) if self._stores() else None,
        )

    def evaluate(self) -> SingleEpochHistory:
        return self.history


class EvaluatorWithLMDecoder(DefaultEvaluator):
    """DefaultEvaluator plus the CER on every batch. An LM decoder on the
    test split is not ported: passing one with lm_decode_test_predictions
    raises NotImplementedError."""

    def __init__(
        self,
        tokenizer,
        mode,
        lm_decoder: Optional[Callable] = None,
        track_non_test_predictions: bool = False,
        lm_decode_test_predictions: bool = False,
        crop_lens: bool = False,
    ):
        super().__init__(tokenizer, mode, track_non_test_predictions, crop_lens)
        if lm_decode_test_predictions and mode == "test":
            raise NotImplementedError(LM_DECODE_NOT_PORTED)
        self.lm_decoder = None

    def _track_batch(self, predictions, batch):
        predicted, labels = self.decode_predictions(predictions, batch)
        predicted = [cut_after_eos_token(s) for s in predicted]
        metrics = dict(predictions.get("metrics") or {})
        if labels is not None:
            metrics["word_error_rate"] = word_error_rate(predicted, labels)
            cer = char_error_rate(predicted, labels)
            if not isnan(cer):
                metrics["char_error_rate"] = cer
        stored = DecodedPredictionBatch(predicted, labels)._asdict() if self._stores() else None
        self.history.add_batch_metric(MetricEntry(metrics, float(predictions["loss"])), stored)


def GreedyEvaluator(tokenizer) -> EvaluatorWithLMDecoder:
    """The serving path's evaluator: test mode, every batch's decoded
    strings kept (predict.py, train_loop.train_batches)."""
    return EvaluatorWithLMDecoder(tokenizer, "test")
