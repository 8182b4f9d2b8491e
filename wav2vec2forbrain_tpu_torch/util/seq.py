"""Sequence-length helpers (host side; counterpart of
wav2vec2forbrain_tpu/util/seq.py)."""

import numpy as np


def calc_seq_len(index_seq) -> int:
    """Length of a token sequence = index of the last id > 0, plus one
    (id 0, the pad / blank token, counts as padding)."""
    arr = np.asarray(index_seq)
    nz = np.nonzero(arr > 0)[0]
    return int(nz[-1]) + 1 if nz.size else 0


def round_up(n: int, multiple: int) -> int:
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple
