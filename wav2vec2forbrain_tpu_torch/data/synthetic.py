"""Synthetic data made with numpy from a seed (the port's counterpart of
wav2vec2forbrain_tpu/data/synthetic.py).

`make_session_mat` / `make_synthetic_splits_dir` write T12-schema `.mat`
session files (keys sentenceText / tx1 / spikePow / blockIdx) into train/
and test/ split dirs, the same arrays as the JAX package's writer for the
same seed, for the CLI (run.py) and its tests.

`make_requests` makes serving requests directly: each batch has zero-padded (B, T, 256) f32 neural features with valid lengths
drawn from [min_len, T], day indices 0..23, and short sentences of common
English words encoded with the port's tokenizer, kept well inside the CTC-
feasible length ((len - 32) // 4 output frames) so the loss is never the
infeasible 0.
"""

import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer

WORDS = ("THE", "A", "OF", "AND", "TO", "IN", "IS", "IT", "YOU", "THAT", "WAS", "HE",
         "FOR", "ON", "ARE", "WITH", "AS", "I", "HIS", "THEY", "BE", "AT", "ONE", "HAVE")


def make_requests(n_batches: int, batch: int, frames: int, seed: int, min_len: int = 100) -> List[B2tBatch]:
    tok = Wav2Vec2CTCTokenizer()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        lens = rng.integers(min_len, frames + 1, batch).astype(np.int32)
        x = rng.standard_normal((batch, frames, 256)).astype(np.float32)
        x[np.arange(frames)[None, :] >= lens[:, None]] = 0.0
        sentences = []
        for ln in lens:
            budget = ((int(ln) - 32) // 4) // 2  # chars: half the output frames
            words: List[str] = []
            while True:
                word = WORDS[rng.integers(len(WORDS))]
                if len(" ".join(words + [word])) > budget:
                    break
                words.append(word)
            sentences.append(" ".join(words) or "A")
        ids = [tok.encode(s) for s in sentences]
        target = np.zeros((batch, max(len(i) for i in ids)), np.int32)
        for i, seq in enumerate(ids):
            target[i, : len(seq)] = seq
        out.append(B2tBatch(
            input=x,
            target=target,
            day_idxs=rng.integers(0, 24, batch).astype(np.int32),
            input_lens=lens,
            target_lens=np.array([len(i) for i in ids], np.int32),
        ))
    return out


_WORDS = (
    "the quick brown fox jumps over a lazy dog and runs far away today "
    "we like to test brain to text decoding with neural networks"
).split()


def _random_sentence(rng: np.random.Generator, n_words: int) -> str:
    return " ".join(rng.choice(_WORDS, size=n_words))


def _char_patterns(n_channels: int) -> np.ndarray:
    """Deterministic per-character channel patterns (27 x C): a fixed
    pseudo-'articulator' code for a-z + space. Seeded independently of the
    trial RNG so every session encodes characters the same way."""
    rng = np.random.default_rng(20260818)
    return rng.normal(size=(27, n_channels))


def _char_ids(sentence: str) -> np.ndarray:
    ids = []
    for ch in sentence.lower():
        if ch == " ":
            ids.append(26)
        elif "a" <= ch <= "z":
            ids.append(ord(ch) - ord("a"))
    return np.asarray(ids, dtype=np.int64)


def _signal_track(sentence: str, t: int, n_channels: int) -> np.ndarray:
    """(T, C) additive signal: the sentence's characters stretched uniformly
    over the trial's frames, each frame carrying its character's pattern.
    This gives the synthetic data a learnable neural code (monotonically
    aligned, like real articulation), so end-to-end runs can drive WER down
    instead of only memorizing the text marginal."""
    ids = _char_ids(sentence)
    if ids.size == 0:
        return np.zeros((t, n_channels))
    frame_char = ids[np.minimum((np.arange(t) * ids.size) // t, ids.size - 1)]
    return _char_patterns(n_channels)[frame_char]


def _trial_frames(
    rng: np.random.Generator, min_frames: int, max_frames: int, dist: str
) -> int:
    """One trial's frame count. 'uniform' (default) draws U[min, max];
    't12' draws the real corpus's right-skewed shape: T12 sentence trials
    run ~100-700 frames at 50 Hz, with a mode near ~250 and a
    long tail to the max — modeled as a clipped lognormal (median ~270,
    p95 ~520)."""
    if dist == "t12":
        t = int(np.exp(rng.normal(np.log(270.0), 0.4)))
        return int(np.clip(t, min_frames, max_frames))
    return int(rng.integers(min_frames, max_frames + 1))


def make_session_mat(
    path: str,
    n_trials: int = 6,
    n_blocks: int = 2,
    min_frames: int = 150,
    max_frames: int = 250,
    n_channels: int = 256,
    seed: int = 0,
    signal_strength: float = 0.0,
    length_distribution: str = "uniform",
) -> None:
    """Write one session .mat with the loader's expected schema.

    Frames must comfortably exceed the unfold contraction ((T-32)//4 output
    frames) vs the sentence length in characters, or every sample is
    CTC-infeasible and the loss is identically zero.

    signal_strength > 0 adds a character-aligned channel code to the noise
    (see _signal_track), making the task learnable — the data regime for
    end-to-end WER-convergence demos. 0 (default) keeps pure noise, the
    regime every existing throughput/e2e-mechanics test uses."""
    rng = np.random.default_rng(seed)
    tx1 = np.empty((1, n_trials), dtype=object)
    spike_pow = np.empty((1, n_trials), dtype=object)
    sentences: List[str] = []
    block_idx = np.zeros((n_trials, 1), dtype=np.float64)
    for i in range(n_trials):
        t = _trial_frames(rng, min_frames, max_frames, length_distribution)
        # keep target_len (chars) well under the (t-32)//4 encoder frames so
        # CTC stays feasible; ~12 frames per word (avg 5 chars + space)
        hi = max(5, min(((t - 32) // 4) // 12, 10))
        sentence = _random_sentence(rng, int(rng.integers(2, hi)))
        sentences.append(sentence)
        sig = (
            signal_strength * _signal_track(sentence, t, n_channels)
            if signal_strength > 0.0
            else 0.0
        )
        tx1[0, i] = (
            rng.poisson(2.0, size=(t, n_channels)).astype(np.float64) + sig
        )
        spike_pow[0, i] = (
            rng.gamma(2.0, 1.0, size=(t, n_channels)).astype(np.float64) + sig
        )
        block_idx[i, 0] = float(i * n_blocks // n_trials + 1)
    from scipy.io import savemat

    savemat(
        path,
        {
            "sentenceText": np.asarray(sentences),
            "tx1": tx1,
            "spikePow": spike_pow,
            "blockIdx": block_idx,
        },
    )


def make_synthetic_splits_dir(
    root: str,
    session_names: Optional[List[str]] = None,
    n_trials: int = 6,
    n_blocks: int = 2,
    seed: int = 0,
    with_competition_holdout: bool = False,
    test_dir_n_trials: Optional[int] = None,
    min_frames: int = 150,
    max_frames: int = 250,
    signal_strength: float = 0.0,
    length_distribution: str = "uniform",
) -> str:
    """Create train/ and test/ split dirs populated with synthetic sessions.

    The block split policy (data/dataset.py) reads the val split from test/, and carves test off train/'s first block — so
    `test_dir_n_trials` sizes the VAL split independently of the train-dir
    trial count (benchmarks want realistic train epochs with a small val
    epoch, like the real T12 layout).
    """
    from wav2vec2forbrain_tpu_torch.data.dataset import sessionNames

    if session_names is None:
        session_names = sessionNames[:2]
    root_path = Path(root)
    dirs = ["train", "test"] + (
        ["competitionHoldOut"] if with_competition_holdout else []
    )
    for split_dir in dirs:
        os.makedirs(root_path / split_dir, exist_ok=True)
        trials = (
            test_dir_n_trials
            if split_dir == "test" and test_dir_n_trials is not None
            else n_trials
        )
        for k, name in enumerate(session_names):
            make_session_mat(
                str(root_path / split_dir / f"{name}.mat"),
                n_trials=trials,
                n_blocks=n_blocks,
                min_frames=min_frames,
                max_frames=max_frames,
                seed=seed + 1000 * dirs.index(split_dir) + k,
                signal_strength=signal_strength,
                length_distribution=length_distribution,
            )
    return str(root_path)
