"""Host-side neural-signal preprocessing (numpy; counterpart of
wav2vec2forbrain_tpu/data/preprocessing.py).

Eight block-wise normalization strategies over the T12 dataset's `tx1`
(threshold crossings) and `spikePow` (spike-band power) features: per-block
z-scoring with eps 1e-8, area slicing (6v = cols :128, 44 = cols 128:), and
linear resampling. All of this runs once at dataset-build time on the host;
the per-step augmentation and smoothing run on the device.
"""

from typing import Callable, Dict, List, Literal, Tuple

import numpy as np

Area = Literal["44", "6v"]


def resample_sample(
    sample: np.ndarray, target_sample_rate: int, orig_sample_rate: int
) -> np.ndarray:
    """Integer-factor linear upsampling along time (torch F.interpolate
    'linear', align_corners=False equivalent; ref: preprocessing.py:12-27)."""
    if target_sample_rate == orig_sample_rate:
        return sample
    scale = target_sample_rate // orig_sample_rate
    t_in = sample.shape[0]
    t_out = t_in * scale
    # align_corners=False: out coord x maps to input coord (x + 0.5)/scale - 0.5
    coords = (np.arange(t_out, dtype=np.float64) + 0.5) / scale - 0.5
    lo = np.floor(coords).astype(np.int64)
    frac = (coords - lo).astype(sample.dtype)
    lo_c = np.clip(lo, 0, t_in - 1)
    hi_c = np.clip(lo + 1, 0, t_in - 1)
    out = sample[lo_c] * (1.0 - frac)[:, None] + sample[hi_c] * frac[:, None]
    return out.astype(sample.dtype)


def _area_slice(arr: np.ndarray, area: Area) -> np.ndarray:
    return arr[:, 128:] if area == "44" else arr[:, :128]


def _iter_trials(data_file: dict, feature: str, area: Area) -> List[np.ndarray]:
    n_trials = data_file["sentenceText"].shape[0]
    return [_area_slice(data_file[feature][0, i], area) for i in range(n_trials)]


def _transcriptions(data_file: dict) -> List[str]:
    n_trials = data_file["sentenceText"].shape[0]
    return [str(data_file["sentenceText"][i]).strip() for i in range(n_trials)]


def _blockwise_zscore(
    features: List[np.ndarray],
    block_index_ranges: List[np.ndarray],
    apply_zscore: bool = True,
) -> List[np.ndarray]:
    out: List[np.ndarray] = [None] * 0
    for block_index_range in block_index_ranges:
        block = np.concatenate(
            features[block_index_range[0] : (block_index_range[-1] + 1)], axis=0
        )
        mean = np.mean(block, axis=0, keepdims=True)
        std = np.std(block, axis=0, keepdims=True)
        for i in block_index_range:
            out.append(
                ((features[i] - mean) / (std + 1e-8)) if apply_zscore else features[i]
            )
    return out


def preprocess_competition_recommended(
    data_file: dict, block_index_ranges: List[np.ndarray], area: Area
) -> Tuple[List[np.ndarray], List[str]]:
    """Concat tx1+spikePow first, then z-score jointly per block
    (ref: preprocessing.py:30-73)."""
    tx = _iter_trials(data_file, "tx1", area)
    sp = _iter_trials(data_file, "spikePow", area)
    feats = [np.concatenate([t, s], axis=1) for t, s in zip(tx, sp)]
    transcriptions = _transcriptions(data_file)
    zs = _blockwise_zscore(feats, block_index_ranges, apply_zscore=True)
    kept = [i for rng in block_index_ranges for i in rng]
    return zs, [transcriptions[i] for i in kept]


def _fn_preprocess_single_feature(
    feature: Literal["tx1", "spikePow"], apply_zscore: bool
) -> Callable:
    def preprocess_single_feature(
        data_file: dict, block_index_ranges: List[np.ndarray], area: Area
    ) -> Tuple[List[np.ndarray], List[str]]:
        feats = _iter_trials(data_file, feature, area)
        transcriptions = _transcriptions(data_file)
        zs = _blockwise_zscore(feats, block_index_ranges, apply_zscore=apply_zscore)
        kept = [i for rng in block_index_ranges for i in rng]
        return zs, [transcriptions[i] for i in kept]

    return preprocess_single_feature


preprocess_only_tx_unnormalized = _fn_preprocess_single_feature("tx1", False)
preprocess_only_tx_zscored = _fn_preprocess_single_feature("tx1", True)
preprocess_only_spikepow_unnormalized = _fn_preprocess_single_feature(
    "spikePow", False
)
preprocess_only_spikepow_zscored = _fn_preprocess_single_feature("spikePow", True)


def preprocess_seperate_zscoring(
    data_file: dict, block_index_ranges: List[np.ndarray], area: Area
) -> Tuple[List[np.ndarray], List[str]]:
    """Z-score tx and spikePow separately, concat over channels → 256 ch
    (the default; ref: preprocessing.py:134-159)."""
    tx, transcriptions = preprocess_only_tx_zscored(data_file, block_index_ranges, area)
    sp, _ = preprocess_only_spikepow_zscored(data_file, block_index_ranges, area)
    assert len(tx) == len(sp), "Length of tx and spike features must be equal."
    feats = [np.concatenate([tx[i], sp[i]], axis=1) for i in range(len(tx))]
    return feats, transcriptions


def preprocess_seperate_zscoring_2channels(
    data_file: dict, block_index_ranges: List[np.ndarray], area: Area
) -> Tuple[List[np.ndarray], List[str]]:
    tx, transcriptions = preprocess_only_tx_zscored(data_file, block_index_ranges, area)
    sp, _ = preprocess_only_spikepow_zscored(data_file, block_index_ranges, area)
    assert len(tx) == len(sp), "Length of tx and spike features must be equal."
    feats = [np.stack([tx[i], sp[i]], axis=0) for i in range(len(tx))]
    return feats, transcriptions


def preprocess_seperate_zscoring_4channels(
    data_file: dict, block_index_ranges: List[np.ndarray], area: Area
) -> Tuple[List[np.ndarray], List[str]]:
    tx, transcriptions = preprocess_only_tx_zscored(data_file, block_index_ranges, area)
    sp, _ = preprocess_only_spikepow_zscored(data_file, block_index_ranges, area)
    feats = [
        np.stack(
            [tx[i][:, :64], tx[i][:, 64:], sp[i][:, :64], sp[i][:, 64:]], axis=0
        )
        for i in range(len(tx))
    ]
    return feats, transcriptions


PreprocessingFunctions: Dict[str, Callable] = {
    "competition_recommended": preprocess_competition_recommended,
    "seperate_zscoring": preprocess_seperate_zscoring,
    "only_tx_unnormalized": preprocess_only_tx_unnormalized,
    "only_tx_zscored": preprocess_only_tx_zscored,
    "only_spikepow_unnormalized": preprocess_only_spikepow_unnormalized,
    "only_spikepow_zscored": preprocess_only_spikepow_zscored,
    "seperate_zscoring_2channels": preprocess_seperate_zscoring_2channels,
    "seperate_zscoring_4channels": preprocess_seperate_zscoring_4channels,
}
