"""Evaluators: greedy decode + WER/CER per batch, the LM beam-search decode
of the test split, and the phoneme error rate (counterpart of
wav2vec2forbrain_tpu/train/evaluator.py).

The same classes and metric names (word_error_rate, char_error_rate,
word_error_rate_lm_decode, char_error_rate_lm_decode) as the JAX package;
tests hold them to the originals on the same predictions. The evaluators
take argmax ids computed on the device; the greedy decode runs at the
batch's max logit length, and with --greedy_decode_crop_lens each sample's
frames past its own length are blanked too. The LM decode takes the test
batches' logits on the host (decode/lm_decode.py).
"""

import os
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from math import isnan, nan
from typing import Callable, List, Literal, Optional

import numpy as np

from wav2vec2forbrain_tpu_torch.train.history import DecodedPredictionBatch, MetricEntry, SingleEpochHistory
from wav2vec2forbrain_tpu_torch.train.metrics import char_error_rate, levenshtein, word_error_rate
from wav2vec2forbrain_tpu_torch.util.phoneme_helper import PHONE_DEF_SIL

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
    """DefaultEvaluator plus the CER on every batch and, on the test split
    with lm_decode_test_predictions, the LM decode.

    `lm_decoder`: callable(logits (B, T', V) f32, logit_lens) -> list[str],
    run on the host (decode/lm_decode.py::make_lm_decoder). Decodes go to a
    thread pool (the native decoder releases the GIL), at most two held per
    worker; each is resolved in batch order, and its metrics are folded into
    the batch's entry and into the running total before evaluate() returns.
    The stored batch gains `predictions_lm_decoded`."""

    def __init__(
        self,
        tokenizer,
        mode,
        lm_decoder: Optional[Callable] = None,
        track_non_test_predictions: bool = False,
        lm_decode_test_predictions: bool = False,
        crop_lens: bool = False,
        lm_decode_workers: int = 0,
    ):
        super().__init__(tokenizer, mode, track_non_test_predictions, crop_lens)
        self.lm_decoder = lm_decoder if (lm_decode_test_predictions and mode == "test") else None
        self.lm_decoded_batches: List[List[str]] = []
        self._lm_workers = lm_decode_workers or min(4, os.cpu_count() or 1)
        self._lm_pool = None
        self._lm_pending: List[tuple] = []  # (future, MetricEntry, stored dict or None, labels)

    def _submit_lm_decode(self, logits, logit_lens):
        if self._lm_pool is None:
            self._lm_pool = ThreadPoolExecutor(max_workers=self._lm_workers, thread_name_prefix="lm-decode")
        while len(self._lm_pending) >= 2 * self._lm_workers:  # backpressure
            self._resolve_lm(self._lm_pending.pop(0))
        return self._lm_pool.submit(self.lm_decoder, np.asarray(logits), np.asarray(logit_lens))

    def _resolve_lm(self, pending):
        fut, entry, stored, labels = pending
        lm_decoded = fut.result()
        lm_metrics = {
            "word_error_rate_lm_decode": word_error_rate(lm_decoded, labels),
            "char_error_rate_lm_decode": char_error_rate(lm_decoded, labels),
        }
        entry.metrics.update(lm_metrics)
        # the running total took this entry before its decode finished: fold
        # the late metrics in with MetricEntry.__iadd__'s semantics
        total = self.history._total.metrics
        for k, v in lm_metrics.items():
            if k in total and total[k] is not None:
                total[k] += v
            else:
                total[k] = v
        if stored is not None:
            stored["predictions_lm_decoded"] = lm_decoded
        self.lm_decoded_batches.append(lm_decoded)

    def _track_batch(self, predictions, batch):
        predicted, labels = self.decode_predictions(predictions, batch)
        predicted = [cut_after_eos_token(s) for s in predicted]
        metrics = dict(predictions.get("metrics") or {})
        lm_future = None
        if labels is not None:
            metrics["word_error_rate"] = word_error_rate(predicted, labels)
            if self.lm_decoder is not None:
                if "logits" not in predictions:
                    raise ValueError("the LM decode needs the batch's logits in the predictions dict")
                lm_future = self._submit_lm_decode(predictions["logits"], predictions["logit_lens"])
            cer = char_error_rate(predicted, labels)
            if not isnan(cer):
                metrics["char_error_rate"] = cer
        stored = DecodedPredictionBatch(predicted, labels)._asdict() if self._stores() else None
        entry = MetricEntry(metrics, float(predictions["loss"]))
        self.history.add_batch_metric(entry, stored)
        if lm_future is not None:
            self._lm_pending.append((lm_future, entry, stored, labels))

    def evaluate(self) -> SingleEpochHistory:
        for pending in self._lm_pending:  # in batch order
            self._resolve_lm(pending)
        self._lm_pending = []
        return self.history

    def clean_up(self):
        if self._lm_pool is not None:
            self._lm_pool.shutdown(wait=False)
            self._lm_pool = None
        super().clean_up()


class B2PEvaluator(Evaluator):
    """Phoneme-error-rate evaluator (ref: evaluator.py:245-313).

    Consumes argmax ids over the phoneme vocab (blank=0); PER = total
    phoneme-level edit distance / total reference phonemes, aggregated over
    the whole batch like the reference."""

    def __init__(self, mode: Literal["train", "val", "test"], track_non_test_predictions: bool = False):
        super().__init__(mode, track_non_test_predictions)
        self.history = SingleEpochHistory()

    def _track_batch(self, predictions, batch):
        pred_ids = np.asarray(predictions["pred_ids"])
        total_dist = 0
        total_len = 0
        labels = []
        predicted = []
        for i in range(pred_ids.shape[0]):
            if batch.target is None:
                continue
            # collapse repeats then drop blanks (greedy CTC decode)
            seq = pred_ids[i]
            collapsed = [int(x) for j, x in enumerate(seq) if j == 0 or x != seq[j - 1]]
            decoded = [x for x in collapsed if x != 0]
            u = int(batch.target_lens[i]) if batch.target_lens is not None else None
            true_seq = [int(x) for x in np.asarray(batch.target[i])[:u] if x > 0]
            labels.append([PHONE_DEF_SIL[x - 1] for x in true_seq])
            predicted.append([PHONE_DEF_SIL[x - 1] for x in decoded])
            total_dist += levenshtein(true_seq, decoded)
            total_len += len(true_seq)
        metrics = dict(predictions.get("metrics") or {})
        metrics["phoneme_error_rate"] = total_dist / total_len if total_len else nan
        self.history.add_batch_metric(
            MetricEntry(metrics, float(predictions["loss"])),
            DecodedPredictionBatch([" ".join(p) for p in predicted], [" ".join(t) for t in labels])
            if self.mode == "test" or self.track_non_test_predictions else None,
        )

    def evaluate(self) -> SingleEpochHistory:
        return self.history


def GreedyEvaluator(tokenizer) -> EvaluatorWithLMDecoder:
    """The serving path's evaluator: test mode, every batch's decoded
    strings kept (predict.py, train_loop.train_batches)."""
    return EvaluatorWithLMDecoder(tokenizer, "test")
