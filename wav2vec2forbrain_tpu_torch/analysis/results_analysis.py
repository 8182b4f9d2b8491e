"""Sweep-result aggregation and statistics (counterpart of
wav2vec2forbrain_tpu/analysis/results_analysis.py; numpy and scipy on the
host).

Replaces the reference's experiment_setups_analysis notebook
(ref: src/analysis/experiment_setups_analysis.ipynb cells 8-37): per-setup
metric distributions over grid runs, boxplots, pairwise Wilcoxon
signed-rank tests across setups.

Input formats:
- the sweep runner's summary.jsonl (wav2vec2forbrain_tpu_torch/sweep.py,
  whose rows are the root sweep.py's)
- the reference's archived W&B CSV exports (fft.csv/frozenw2v.csv/...)
"""

import json
from typing import Dict, List, Optional

import numpy as np


def load_sweep_summary(path: str, metric: str) -> List[float]:
    """Metric values from a summary.jsonl or a W&B CSV export."""
    values: List[float] = []
    if path.endswith(".jsonl"):
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                v = row.get(metric)
                if v is not None:
                    values.append(float(v))
    else:  # csv
        import csv

        with open(path) as f:
            for row in csv.DictReader(f):
                v = row.get(metric)
                if v not in (None, ""):
                    try:
                        values.append(float(v))
                    except ValueError:
                        pass
    return values


def setup_stats(values: List[float]) -> Dict[str, float]:
    a = np.asarray(values, dtype=np.float64)
    if a.size == 0:
        return {"n": 0}
    return {
        "n": int(a.size),
        "min": float(a.min()),
        "median": float(np.median(a)),
        "mean": float(a.mean()),
        "max": float(a.max()),
        "std": float(a.std(ddof=1)) if a.size > 1 else 0.0,
    }


def wilcoxon_signed_rank(a: List[float], b: List[float]) -> Dict[str, float]:
    """Paired Wilcoxon test between two setups' runs (same grid order),
    as the reference notebook compares fft vs frozen vs from-scratch."""
    from scipy.stats import wilcoxon

    n = min(len(a), len(b))
    stat, p = wilcoxon(a[:n], b[:n])
    return {"statistic": float(stat), "p_value": float(p), "n": n}


def compare_setups(
    setups: Dict[str, List[float]], out_plot: Optional[str] = None
) -> Dict[str, dict]:
    """Stats per setup + pairwise Wilcoxon; optional boxplot figure."""
    result: Dict[str, dict] = {
        name: setup_stats(vals) for name, vals in setups.items()
    }
    names = list(setups.keys())
    pairwise = {}
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            a, b = setups[names[i]], setups[names[j]]
            if min(len(a), len(b)) >= 5:
                pairwise[f"{names[i]}_vs_{names[j]}"] = wilcoxon_signed_rank(a, b)
    result["_pairwise_wilcoxon"] = pairwise

    if out_plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(2 + 2 * len(names), 5))
        ax.boxplot([setups[n] for n in names], tick_labels=names)  # `labels` before matplotlib 3.9
        ax.set_ylabel("metric")
        plt.tight_layout()
        plt.savefig(out_plot)
        plt.close(fig)
    return result
