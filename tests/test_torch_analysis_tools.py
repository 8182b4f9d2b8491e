"""The port's sweep statistics (analysis/results_analysis.py) and raw-data
EDA (analysis/raw_data_analysis.py) against the JAX package's, on the CPU.

Both are numpy (and scipy) on the host, copied: on the same inputs the
outputs are equal exactly.
- results: `load_sweep_summary` of a summary.jsonl as the port's sweep
  runner writes it and of a W&B CSV export, `setup_stats`,
  `compare_setups` (pairwise Wilcoxon; the boxplot where matplotlib is);
- EDA: the windowing, correlation, PCA and rolling-mean functions on
  synthetic signals; `analyze_dataset` and `summary_json` on the synthetic
  T12 splits, each package reading them through its own dataset; both
  `main`s on one splits dir print the same JSON and write the same
  raw_data_summary.json (and the four figures where matplotlib is).
"""

import json
import os

import numpy as np
import pytest

from wav2vec2forbrain_tpu.analysis import raw_data_analysis as jax_eda
from wav2vec2forbrain_tpu.analysis import results_analysis as jax_results
from wav2vec2forbrain_tpu.args.base_args import B2TDatasetArgsModel as JaxDatasetArgs
from wav2vec2forbrain_tpu.data.dataset import Brain2TextDataset as JaxDataset
from wav2vec2forbrain_tpu_torch.analysis import raw_data_analysis as eda
from wav2vec2forbrain_tpu_torch.analysis import results_analysis as results
from wav2vec2forbrain_tpu_torch.args.flags import B2TDatasetArgsModel
from wav2vec2forbrain_tpu_torch.data.dataset import Brain2TextDataset


def _equal(a, b):
    """Nested dicts / lists / arrays / floats equal exactly (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple, np.ndarray)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (a, b)


def test_sweep_summaries_match_jax(tmp_path):
    # rows as wav2vec2forbrain_tpu_torch/sweep.py appends them, a failed point (no metric) among them
    rng = np.random.default_rng(0)
    rows = [{"run": i, "params": {"encoder_gru_hidden_size": 256 * (1 + i % 2)},
             "test_ctc_loss": None if i == 3 else float(rng.uniform(0.5, 2.0)), "returncode": int(i == 3),
             "runtime_s": 3.1, "results_dir": f"/r/{i}"} for i in range(7)]
    jsonl = tmp_path / "summary.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in rows))
    csv = tmp_path / "fft.csv"
    csv.write_text("name,test_word_error_rate\nrun1,0.35\nrun2,0.31\nrun3,\nrun4,n/a\nrun5,0.4\n")
    for path, metric in ((jsonl, "test_ctc_loss"), (csv, "test_word_error_rate"), (csv, "missing")):
        got = results.load_sweep_summary(str(path), metric)
        assert got == jax_results.load_sweep_summary(str(path), metric)
    assert len(results.load_sweep_summary(str(jsonl), "test_ctc_loss")) == 6
    for values in ([], [1.5], [0.3, 0.1, 0.2]):
        _equal(results.setup_stats(values), jax_results.setup_stats(values))

    setups = {"fft": list(rng.normal(0.35, 0.02, 12)), "frozen": list(rng.normal(0.55, 0.03, 12)),
              "scratch": list(rng.normal(0.5, 0.05, 4))}  # under 5 runs: no Wilcoxon against it
    plot = None
    try:
        import matplotlib  # noqa: F401

        plot = str(tmp_path / "box.png")
    except ImportError:
        pass
    got = results.compare_setups(setups, out_plot=plot)
    _equal(got, jax_results.compare_setups(setups))
    assert list(got["_pairwise_wilcoxon"]) == ["fft_vs_frozen"]
    assert got["_pairwise_wilcoxon"]["fft_vs_frozen"]["p_value"] < 0.01
    assert plot is None or os.path.getsize(plot) > 0
    _equal(results.wilcoxon_signed_rank(setups["fft"], setups["frozen"][:10]),
           jax_results.wilcoxon_signed_rank(setups["fft"], setups["frozen"][:10]))


def _signals():
    rng = np.random.default_rng(1)
    t, c = 240, 8
    slow = np.repeat(rng.normal(size=(t // 20, 1)), 20, axis=0)
    x = slow + 1.5 * rng.normal(size=(t, c))
    x[:, 3] = 2.0  # a constant channel
    return x


@pytest.mark.parametrize("name,args", [
    ("bin_time_series", (10,)), ("avg_correlation", ()), ("correlation_score", (10, 60, 0.2)),
    ("optimal_window", (60, 0.2)), ("pca_explained_variance_ratio", ()), ("pca_components_for_variance", (0.9,)),
    ("pca_project", (3,)), ("rolling_mean", (7,)), ("analyze_sentence", (60, 0.2)),
])
def test_eda_functions_match_jax(name, args):
    x = _signals()
    _equal(getattr(eda, name)(x, *args), getattr(jax_eda, name)(x, *args))


def test_eda_channel_functions_match_jax():
    rng = np.random.default_rng(2)
    samples = [rng.normal(size=(n, 6)) + d for n, d in ((50, 0), (70, 1), (40, 0))]
    days = [0, 1, 0]
    _equal(eda.channel_correlation(samples), jax_eda.channel_correlation(samples))
    _equal(eda.channel_stats(samples, days), jax_eda.channel_stats(samples, days))


def test_eda_dataset_summary_matches_jax(synthetic_splits_dir):
    ds = Brain2TextDataset(B2TDatasetArgsModel(), synthetic_splits_dir, split="train")
    ref_ds = JaxDataset(JaxDatasetArgs(), synthetic_splits_dir, split="train")
    got = eda.analyze_dataset(ds, max_samples=4, seed=0)
    want = jax_eda.analyze_dataset(ref_ds, max_samples=4, seed=0)
    _equal(got, want)
    _equal(eda.summary_json(got), jax_eda.summary_json(want))
    assert got["n_analyzed"] == min(4, len(ds))


def test_eda_mains_print_the_same_json(synthetic_splits_dir, tmp_path, capsys):
    argv = ["--dataset_splits_dir", synthetic_splits_dir, "--split", "test", "--max_samples", "3"]
    jax_out = jax_eda.main(argv + ["--fig_dir", str(tmp_path / "jax")])
    jax_printed = capsys.readouterr().out
    out = eda.main(argv + ["--fig_dir", str(tmp_path / "port")])
    printed = capsys.readouterr().out
    assert out == jax_out
    assert printed.replace(str(tmp_path / "port"), "<dir>") == jax_printed.replace(str(tmp_path / "jax"), "<dir>")
    with open(tmp_path / "port" / "raw_data_summary.json") as f, open(tmp_path / "jax" / "raw_data_summary.json") as g:
        assert json.load(f) == json.load(g)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    with pytest.raises(ValueError, match="preprocessing"):
        eda.main(argv + ["--preprocessing", "nope"])
