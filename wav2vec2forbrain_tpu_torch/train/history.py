"""Training history records with JSON round-trip and plots (counterpart of
wav2vec2forbrain_tpu/train/history.py).

The same record shapes and history.json schema as the JAX package, so its
tooling (sweep analysis, resume with history) reads the port's files.
Plotting is matplotlib, imported only when a plot is written.
"""

import json
from dataclasses import dataclass
from math import nan
from typing import List, NamedTuple, Optional


class DecodedPredictionBatch(NamedTuple):
    predictions: List[str]
    targets: Optional[List[str]]


@dataclass
class MetricEntry:
    """Per-batch metrics + loss; += / ÷ aggregation."""

    metrics: dict
    loss: float = 0

    def __iadd__(self, other: "MetricEntry"):
        for key, value in other.metrics.items():
            if key in self.metrics and self.metrics[key] is not None:
                self.metrics[key] += value
            else:
                self.metrics[key] = value
        self.loss += other.loss
        return self

    def __truediv__(self, other: float):
        metrics_copy = dict(self.metrics)
        for key, value in metrics_copy.items():
            metrics_copy[key] = value / other if other != 0 else nan
        return MetricEntry(
            metrics_copy, self.loss / other if other != 0 else nan
        )


class SingleEpochHistory:
    """Batch-level accumulator; average = mean over batches."""

    def __init__(self):
        self.metrics: List[MetricEntry] = []
        self._total = MetricEntry({})
        self._count = 0
        self.decoded: List[Optional[DecodedPredictionBatch]] = []

    def add_batch_metric(
        self, entry: MetricEntry, decoded: Optional[DecodedPredictionBatch] = None
    ):
        self.metrics.append(entry)
        self._total += entry
        self._count += 1
        self.decoded.append(decoded)

    def get_average(self) -> MetricEntry:
        return self._total / self._count

    def get_last(self) -> MetricEntry:
        return self.metrics[-1]

    def to_dict(self):
        def get_batch(i):
            entry = self.decoded[i]
            if entry is None:
                return {}
            # plain dicts may carry extra fields (predictions_lm_decoded)
            return entry if isinstance(entry, dict) else entry._asdict()

        return {
            "history": [
                {"metrics": m.metrics, "loss": m.loss, "batch": get_batch(i)}
                for i, m in enumerate(self.metrics)
            ],
            "average": {
                "metrics": self.get_average().metrics,
                "loss": self.get_average().loss,
            },
        }

    def plot_metric_as_hist(self, metric_key: str, title: str, plt_ax):
        vals = [
            m.metrics[metric_key] for m in self.metrics if metric_key in m.metrics
        ]
        plt_ax.hist(vals, bins=10, color="blue", alpha=0.7)
        ignored = len(self.metrics) - len(vals)
        plt_ax.set_title(
            title + (f" (ignored {ignored} batches w/o {metric_key})" if ignored else "")
        )
        plt_ax.set_xlabel(metric_key)
        plt_ax.set_ylabel("Frequency")

    def save_plot_metric_as_hist(self, metric_key: str, title: str, out_path: str):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(1, 1, figsize=(10, 5))
        self.plot_metric_as_hist(metric_key, title, ax)
        plt.tight_layout()
        plt.savefig(out_path)
        plt.close(fig)


class EpochLosses(NamedTuple):
    train_losses: SingleEpochHistory
    val_losses: SingleEpochHistory

    def to_dict(self):
        return {
            "train": self.train_losses.to_dict(),
            "val": self.val_losses.to_dict(),
        }


class TrainHistory(NamedTuple):
    epochs: List[EpochLosses]
    test_losses: SingleEpochHistory

    def to_dict(self):
        return {
            "epochs": [e.to_dict() for e in self.epochs],
            "test": self.test_losses.to_dict(),
        }

    @classmethod
    def from_json(cls, json_path: str) -> "TrainHistory":
        with open(json_path, "r") as f:
            data = json.load(f)

        def load_epoch(d) -> SingleEpochHistory:
            hist = SingleEpochHistory()
            for batch in d["history"]:
                decoded = None
                b = batch.get("batch")
                if b and "predictions" in b:
                    decoded = DecodedPredictionBatch(
                        predictions=b["predictions"], targets=b.get("targets")
                    )
                hist.add_batch_metric(
                    MetricEntry(batch["metrics"], batch["loss"]), decoded
                )
            return hist

        return cls(
            epochs=[
                EpochLosses(load_epoch(e["train"]), load_epoch(e["val"]))
                for e in data["epochs"]
            ],
            test_losses=load_epoch(data["test"]),
        )

    def plot(self, out_path: str, loss_name: str = "ctc"):
        """Loss curves + metric curves over epochs."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        train_losses = [e.train_losses.get_average().loss for e in self.epochs]
        val_losses = [e.val_losses.get_average().loss for e in self.epochs]
        metric_keys = sorted(
            {
                k
                for e in self.epochs
                for k in e.val_losses.get_average().metrics.keys()
            }
        )
        n = 1 + len(metric_keys)
        fig, axes = plt.subplots(n, 1, figsize=(10, 5 * n), squeeze=False)
        ax = axes[0][0]
        ax.plot(train_losses, label=f"train {loss_name} loss")
        ax.plot(val_losses, label=f"val {loss_name} loss")
        ax.set_xlabel("epoch")
        ax.legend()
        for i, key in enumerate(metric_keys):
            ax = axes[i + 1][0]
            vals = [
                e.val_losses.get_average().metrics.get(key, nan)
                for e in self.epochs
            ]
            ax.plot(vals, label=f"val {key}")
            ax.set_xlabel("epoch")
            ax.legend()
        plt.tight_layout()
        plt.savefig(out_path)
        plt.close(fig)
