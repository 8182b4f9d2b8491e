"""Raw neural-data EDA: windowing, cross-channel correlation, PCA structure
(counterpart of wav2vec2forbrain_tpu/analysis/raw_data_analysis.py).

Functional equivalent of the reference's exploratory raw-data notebooks, as
a testable module instead of notebooks:

- ref src/analysis/brain_data_analysis2.ipynb — find the time-bin window
  that maximizes mean cross-feature correlation (with an optional window-
  length penalty), count the PCA components needed for 95% of variance,
  and plot mean variance vs window size.
- ref src/analysis/brain_data_analysis3.ipynb — per-channel rolling-mean
  views of a single sentence's recording.
- ref src/analysis/helpers.py — correlation-matrix heatmaps and PCA
  component counting (pca_most_valuable_features).

Everything here is pure numpy on host data (EDA is no device workload);
figures are optional and gated behind a matplotlib import so the module
works headless. `analyze_dataset` runs on any Brain2TextDataset, the
synthetic fixture (data/synthetic.py) included.

CLI:
    python -m wav2vec2forbrain_tpu_torch.analysis.raw_data_analysis \
        --dataset_splits_dir <dir> [--split train] [--max_samples 200] \
        [--fig_dir out/]
"""

import json
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "bin_time_series",
    "avg_correlation",
    "correlation_score",
    "optimal_window",
    "pca_explained_variance_ratio",
    "pca_components_for_variance",
    "channel_correlation",
    "channel_stats",
    "rolling_mean",
    "analyze_sentence",
    "analyze_dataset",
    "save_figures",
]


# --- windowing / correlation (brain_data_analysis2.ipynb) --------------------


def bin_time_series(x: np.ndarray, bin_len: int) -> np.ndarray:
    """(T, C) -> (T // bin_len, C): mean over consecutive windows of
    `bin_len` frames (the notebook's get_time_series_df re-binning; frames
    are 20 ms in the T12 recordings)."""
    x = np.asarray(x, np.float64)
    t = (x.shape[0] // bin_len) * bin_len
    if t == 0:
        return x[:0]
    return x[:t].reshape(-1, bin_len, x.shape[1]).mean(axis=1)


def avg_correlation(x: np.ndarray) -> float:
    """Mean of the full (C, C) Pearson correlation matrix (diagonal
    included, like pandas `df.corr()` + double mean in the notebook).
    Constant channels correlate as 0, not NaN."""
    x = np.asarray(x, np.float64)
    if x.shape[0] < 2:
        return float("nan")
    sd = x.std(axis=0)
    keep_scale = np.where(sd > 0, sd, 1.0)
    z = (x - x.mean(axis=0)) / keep_scale
    corr = (z.T @ z) / x.shape[0]
    np.fill_diagonal(corr, 1.0)
    dead = sd == 0
    corr[dead, :] = 0.0
    corr[:, dead] = 0.0
    corr[np.ix_(dead, dead)] = np.eye(int(dead.sum()))
    return float(corr.mean())


def correlation_score(
    x: np.ndarray, bin_len: int, max_bin_len: int, bin_len_penalty: float
):
    """(avg_corr, penalized score) for one window size — the notebook's
    calculate_correlation: longer windows are discounted linearly so the
    argmax doesn't trivially run to the longest window."""
    binned = bin_time_series(x, bin_len)
    avg_corr = avg_correlation(binned)
    penalty = bin_len_penalty * (bin_len / max_bin_len)
    return avg_corr, avg_corr * (1.0 - penalty)


def optimal_window(
    x: np.ndarray,
    max_bin_len: int = 100,
    bin_len_penalty: float = 0.2,
    min_bin_len: int = 5,
    bin_len_step: int = 5,
) -> Dict:
    """Scan window sizes and return the correlation profile plus the argmax
    with and without the length penalty (get_optimal_window)."""
    bin_lens = list(range(min_bin_len, max_bin_len, bin_len_step))
    avg_corrs, scores = [], []
    for bl in bin_lens:
        c, s = correlation_score(x, bl, max_bin_len, bin_len_penalty)
        avg_corrs.append(c)
        scores.append(s)
    scores_a = np.asarray(scores)
    corrs_a = np.asarray(avg_corrs)
    return {
        "bin_lens": bin_lens,
        "avg_corrs": avg_corrs,
        "scores": scores,
        "best_bin_len": int(bin_lens[int(np.nanargmax(scores_a))]),
        "best_bin_len_no_penalty": int(bin_lens[int(np.nanargmax(corrs_a))]),
    }


# --- PCA structure (helpers.pca_most_valuable_features) ----------------------


def pca_explained_variance_ratio(x: np.ndarray) -> np.ndarray:
    """Explained-variance ratios of the centered data's principal
    components (plain numpy SVD — no sklearn dependency)."""
    x = np.asarray(x, np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    s = np.linalg.svd(x, compute_uv=False)
    var = s**2
    total = var.sum()
    if total == 0:
        return np.zeros_like(var)
    return var / total


def pca_components_for_variance(x: np.ndarray, data_percentage: float = 0.95) -> int:
    """Index of the first component at which cumulative explained variance
    reaches `data_percentage` (helpers.pca_most_valuable_features — the
    reference reports np.where(...)[0][0], i.e. a 0-based index)."""
    cum = pca_explained_variance_ratio(x).cumsum()
    hit = np.where(cum >= data_percentage)[0]
    return int(hit[0]) if hit.size else int(cum.size - 1)


def pca_project(x: np.ndarray, n_components: int = 2) -> np.ndarray:
    """(T, C) -> (T, n) projection onto the top principal components (for
    the scatter-by-day figure)."""
    x = np.asarray(x, np.float64)
    mu = x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x - mu, full_matrices=False)
    return (x - mu) @ vt[:n_components].T


# --- per-channel statistics ---------------------------------------------------


def channel_correlation(samples: Sequence[np.ndarray]) -> np.ndarray:
    """(C, C) correlation matrix over all frames of all samples (the
    show_corr_matrix input, computed dataset-wide)."""
    x = np.concatenate([np.asarray(s, np.float64) for s in samples], axis=0)
    sd = x.std(axis=0)
    keep = np.where(sd > 0, sd, 1.0)
    z = (x - x.mean(axis=0)) / keep
    corr = (z.T @ z) / x.shape[0]
    np.fill_diagonal(corr, 1.0)
    return corr


def channel_stats(
    samples: Sequence[np.ndarray], day_idxs: Sequence[int]
) -> Dict:
    """Per-channel mean/var overall and per recording day (the helpers
    show_statistics summary, broken down by session so day-to-day drift —
    the motivation for the model's day-specific affine layer — is visible
    in the raw features)."""
    days = sorted(set(int(d) for d in day_idxs))
    per_day = {}
    for d in days:
        x = np.concatenate(
            [
                np.asarray(s, np.float64)
                for s, di in zip(samples, day_idxs)
                if int(di) == d
            ],
            axis=0,
        )
        per_day[d] = {
            "frames": int(x.shape[0]),
            "mean": x.mean(axis=0),
            "var": x.var(axis=0),
        }
    x_all = np.concatenate([np.asarray(s, np.float64) for s in samples], axis=0)
    return {
        "n_channels": int(x_all.shape[1]),
        "mean": x_all.mean(axis=0),
        "var": x_all.var(axis=0),
        "min": x_all.min(axis=0),
        "max": x_all.max(axis=0),
        "per_day": per_day,
    }


def rolling_mean(x: np.ndarray, window_size: int) -> np.ndarray:
    """Centered rolling mean per channel (brain_data_analysis3.ipynb's
    conv1d smoothing of the single-sentence channel view)."""
    x = np.asarray(x, np.float64)
    kernel = np.ones(window_size) / window_size
    return np.stack(
        [np.convolve(x[:, c], kernel, mode="same") for c in range(x.shape[1])],
        axis=1,
    )


# --- dataset-level analysis ---------------------------------------------------


def analyze_sentence(
    x: np.ndarray, max_bin_len: int = 100, bin_len_penalty: float = 0.2
) -> Dict:
    """One sentence's EDA record: optimal window (both variants) and the
    PCA-95% component count at each (the notebook's analyze_sentence)."""
    win = optimal_window(x, max_bin_len, bin_len_penalty)
    out = dict(win)
    out["pca_95_feat_count"] = pca_components_for_variance(x, 0.95)
    out["pca_95_at_best_window"] = pca_components_for_variance(
        bin_time_series(x, win["best_bin_len"]), 0.95
    )
    return out


def analyze_dataset(
    dataset,
    max_samples: int = 200,
    seed: int = 0,
    max_bin_len: int = 100,
    bin_len_penalty: float = 0.2,
) -> Dict:
    """Dataset-wide EDA summary over a random sample subset (the notebook
    analyzes 200 of ~9k sentences). Returns plain-python/np results; pass
    to save_figures for the plots."""
    n = len(dataset)
    rng = random.Random(seed)
    idxs = sorted(rng.sample(range(n), k=min(max_samples, n)))
    samples = [dataset[i] for i in idxs]
    feats = [np.asarray(s.input, np.float64) for s in samples]
    day_idxs = [int(s.day_idx) for s in samples]
    lens = np.asarray([f.shape[0] for f in feats])

    # cap the window scan at half the shortest analyzed sentence so every
    # scanned window has >= 2 bins (the notebook asserts the same bound)
    max_bin = int(min(max_bin_len, max(lens.min() // 2, 10)))
    per_sentence = [
        analyze_sentence(f, max_bin, bin_len_penalty) for f in feats
    ]

    best_windows = np.asarray([r["best_bin_len"] for r in per_sentence])
    best_np = np.asarray([r["best_bin_len_no_penalty"] for r in per_sentence])
    pca95 = np.asarray([r["pca_95_feat_count"] for r in per_sentence])

    corr = channel_correlation(feats)
    stats = channel_stats(feats, day_idxs)

    # mean variance vs window size on the longest analyzed sentence
    # (notebook cell 16)
    longest = feats[int(np.argmax(lens))]
    var_bins = list(range(5, max_bin, 5)) or [5]
    mean_vars = [
        float(bin_time_series(longest, b).var(axis=0).mean()) for b in var_bins
    ]

    # per-day PCA scatter input: per-sample mean feature vectors projected
    # to 2 components, colored by day
    sample_means = np.stack([f.mean(axis=0) for f in feats])
    pca2 = (
        pca_project(sample_means, 2)
        if sample_means.shape[0] >= 2
        else np.zeros((sample_means.shape[0], 2))
    )

    return {
        "n_analyzed": len(feats),
        "n_total": n,
        "frames_per_sample": {
            "median": float(np.median(lens)),
            "min": int(lens.min()),
            "max": int(lens.max()),
        },
        "optimal_window": {
            "mean": float(best_windows.mean()),
            "median": float(np.median(best_windows)),
            "mean_no_penalty": float(best_np.mean()),
        },
        "pca_95_feat_count": {
            "mean": float(pca95.mean()),
            "median": float(np.median(pca95)),
        },
        "channel_correlation": corr,
        "channel_stats": stats,
        "variance_vs_window": {"bin_lens": var_bins, "mean_vars": mean_vars},
        "pca_scatter": {"points": pca2, "day_idxs": day_idxs},
        "per_sentence": per_sentence,
    }


def summary_json(summary: Dict) -> Dict:
    """The JSON-serializable slice of analyze_dataset's output (arrays
    reduced to scalars) — what the CLI writes next to the figures."""
    stats = summary["channel_stats"]
    return {
        "n_analyzed": summary["n_analyzed"],
        "n_total": summary["n_total"],
        "frames_per_sample": summary["frames_per_sample"],
        "optimal_window": summary["optimal_window"],
        "pca_95_feat_count": summary["pca_95_feat_count"],
        "n_channels": stats["n_channels"],
        "mean_abs_offdiag_correlation": float(
            np.abs(
                summary["channel_correlation"]
                - np.eye(stats["n_channels"])
            ).sum()
            / (stats["n_channels"] * (stats["n_channels"] - 1))
        ),
        "per_day_mean_of_channel_means": {
            str(d): float(v["mean"].mean())
            for d, v in stats["per_day"].items()
        },
    }


def save_figures(summary: Dict, fig_dir: str) -> List[str]:
    """Write the notebook's figures from an analyze_dataset summary:
    correlation heatmap, correlation-vs-window profile, mean-variance vs
    window, and the per-day PCA scatter. Returns the written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(fig_dir, exist_ok=True)
    paths = []

    def save(name):
        p = os.path.join(fig_dir, name)
        plt.tight_layout()
        plt.savefig(p)
        plt.close()
        paths.append(p)

    plt.figure(figsize=(8, 7))
    plt.imshow(summary["channel_correlation"], vmin=-0.8, vmax=0.8, cmap="RdBu_r")
    plt.colorbar(label="Pearson r")
    plt.title("Channel correlation matrix")
    plt.xlabel("channel")
    plt.ylabel("channel")
    save("channel_correlation.png")

    first = summary["per_sentence"][0]
    plt.figure()
    plt.plot(first["bin_lens"], first["scores"], label="score (length penalty)")
    plt.plot(first["bin_lens"], first["avg_corrs"], label="avg correlation")
    plt.xlabel("Window length (frames)")
    plt.ylabel("Mean cross-feature correlation")
    plt.title("Correlation vs window size (first analyzed sentence)")
    plt.legend()
    save("correlation_vs_window.png")

    vv = summary["variance_vs_window"]
    plt.figure()
    plt.plot(vv["bin_lens"], vv["mean_vars"])
    plt.xlabel("Window size")
    plt.ylabel("Mean variance")
    plt.title("Mean variance vs. window size")
    save("variance_vs_window.png")

    sc = summary["pca_scatter"]
    pts, days = sc["points"], np.asarray(sc["day_idxs"])
    plt.figure()
    for d in sorted(set(days.tolist())):
        sel = days == d
        plt.scatter(pts[sel, 0], pts[sel, 1], s=12, label=f"day {d}")
    plt.xlabel("PC 1")
    plt.ylabel("PC 2")
    plt.title("Per-sample mean features, PCA by recording day")
    plt.legend(fontsize=7)
    save("pca_by_day.png")
    return paths


def main(argv: Optional[List[str]] = None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_splits_dir", required=True)
    p.add_argument("--split", default="train", choices=["train", "val", "test"])
    p.add_argument("--preprocessing", default="seperate_zscoring")
    p.add_argument("--max_samples", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fig_dir", default=None)
    a = p.parse_args(argv)

    from wav2vec2forbrain_tpu_torch.args.flags import B2TDatasetArgsModel, validate
    from wav2vec2forbrain_tpu_torch.data.dataset import Brain2TextDataset

    ds = Brain2TextDataset(
        validate(B2TDatasetArgsModel, {"preprocessing": a.preprocessing}),
        a.dataset_splits_dir,
        split=a.split,
    )
    summary = analyze_dataset(ds, max_samples=a.max_samples, seed=a.seed)
    out = summary_json(summary)
    print(json.dumps(out, indent=2))
    if a.fig_dir:
        for path in save_figures(summary, a.fig_dir):
            print(f"wrote {path}")
        with open(os.path.join(a.fig_dir, "raw_data_summary.json"), "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
