"""The reference's own inputs: each trial's features worked out again from
the raw sessions (per-block z-scoring of the two feature kinds, the 6v
area), its sentence tokenised with the wav2vec2 CTC vocabulary, and a batch
of named trials padded as the brain2text collate pads it."""

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# wav2vec2's English CTC vocabulary (facebook/wav2vec2-base-960h vocab.json); "|" separates words
VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "E": 5, "T": 6, "A": 7, "O": 8, "N": 9, "I": 10,
         "H": 11, "S": 12, "R": 13, "D": 14, "L": 15, "U": 16, "M": 17, "W": 18, "C": 19, "F": 20, "G": 21,
         "Y": 22, "P": 23, "B": 24, "V": 25, "K": 26, "'": 27, "X": 28, "J": 29, "Q": 30, "Z": 31}
AREA_6V = 128
_STRIP = set(',?.!-;:"')


def tokens(sentence: str) -> List[int]:
    text = "".join(ch for ch in sentence.upper() if ch not in _STRIP).replace(" ", "|")
    return [VOCAB.get(ch, VOCAB["<unk>"]) for ch in text]


def _zscored(arrays: List[np.ndarray]) -> List[np.ndarray]:
    block = np.concatenate(arrays, axis=0).astype(np.float64)
    mean, std = block.mean(axis=0), block.std(axis=0)
    return [((a - mean) / (std + 1e-8)) for a in arrays]


class Trials:
    """{(day, frames): (features (frames, 256) float64, token ids)}."""

    def __init__(self, sessions):
        self.by_key: Dict[Tuple[int, int], Tuple[np.ndarray, List[int]]] = {}
        for s in sessions:
            for b in np.unique(s.blocks):
                idx = np.flatnonzero(s.blocks == b)
                tx = _zscored([s.tx1[i][:, :AREA_6V] for i in idx])
                sp = _zscored([s.spike_pow[i][:, :AREA_6V] for i in idx])
                for j, i in enumerate(idx):
                    key = (s.day, s.tx1[i].shape[0])
                    if key in self.by_key:
                        raise ValueError(f"two trials of session {s.day} have {key[1]} frames")
                    self.by_key[key] = (np.concatenate([tx[j], sp[j]], axis=1), tokens(s.sentences[i]))

    def batch(self, keys: Sequence[Tuple[int, int]], rows: int, device) -> dict:
        """The named trials zero-padded to the longest, then up to `rows`
        with masked copies of the last (the program's row padding)."""
        real = len(keys)
        keys = list(keys) + [keys[-1]] * (rows - real)
        feats = [self.by_key[k][0] for k in keys]
        toks = [self.by_key[k][1] for k in keys]
        t, u = max(f.shape[0] for f in feats), max(len(x) for x in toks)
        x = np.zeros((len(keys), t, feats[0].shape[1]), np.float32)
        y = np.zeros((len(keys), u), np.int32)
        for i, (f, tok) in enumerate(zip(feats, toks)):
            x[i, : f.shape[0]] = f
            y[i, : len(tok)] = tok
        mask = np.zeros(len(keys), np.float32)
        mask[:real] = 1.0
        return {
            "input": torch.from_numpy(x).to(device),
            "target": torch.from_numpy(y).to(device),
            "day_idxs": torch.tensor([k[0] for k in keys], dtype=torch.int64, device=device),
            "input_lens": torch.tensor([k[1] for k in keys], dtype=torch.int64, device=device),
            "target_lens": torch.tensor([len(tk) for tk in toks], dtype=torch.int64, device=device),
            "sample_mask": torch.from_numpy(mask).to(device),
        }
