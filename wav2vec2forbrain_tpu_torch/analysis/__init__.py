"""The analysis subsystem (counterpart of wav2vec2forbrain_tpu/analysis/):

- `latent_analysis`: the paper's brain-vs-audio latent comparison, both
  streams through the trained model on the card (the ported kernels), and
  the statistics of the two latent sets;
- `results_analysis`: sweep statistics over `summary.jsonl` (sweep.py)
  or W&B CSV exports, with paired Wilcoxon tests;
- `raw_data_analysis`: the raw neural-data EDA (numpy), also a CLI:
  `python -m wav2vec2forbrain_tpu_torch.analysis.raw_data_analysis`.

matplotlib is imported only inside the plotting functions.
"""
