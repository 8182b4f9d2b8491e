"""The one traffic generator: T12-schema sessions from a traffic file and a
seed.

Every seed gets the same multiset of trial lengths (a grid over the
file's range, the same in every session and dealt to the blocks so that
each block holds every block_count-th length), in another order within
each block, and its own sentences and neural features. So runs on
different seeds do the same amount of work. Within a session no two trials
share a length: (session, frames) names a trial, which is how the plain
reference finds the trials of the program's batches.

Features are float32: `tx1` threshold-crossing counts in 0..4 and
`spikePow` exponential powers, `area_channels` columns each (the program
reads the 6v area, the first 128 columns; the area-44 columns are not
written). Sentences are common words within half the unfolded frames, so
every trial is CTC-feasible.
"""

import os
from dataclasses import dataclass
from typing import List

import numpy as np

# the 24 T12 recording sessions, in the order the dataset lists them
SESSIONS = sorted([
    "t12.2022.04.28", "t12.2022.05.26", "t12.2022.06.21", "t12.2022.07.21", "t12.2022.08.13", "t12.2022.05.05",
    "t12.2022.06.02", "t12.2022.06.23", "t12.2022.07.27", "t12.2022.08.18", "t12.2022.05.17", "t12.2022.06.07",
    "t12.2022.06.28", "t12.2022.07.29", "t12.2022.08.23", "t12.2022.05.19", "t12.2022.06.14", "t12.2022.07.05",
    "t12.2022.08.02", "t12.2022.08.25", "t12.2022.05.24", "t12.2022.06.16", "t12.2022.07.14", "t12.2022.08.11",
])
WORDS = ("THE", "A", "OF", "AND", "TO", "IN", "IS", "IT", "YOU", "THAT", "WAS", "HE", "FOR", "ON", "ARE", "WITH",
         "AS", "I", "HIS", "THEY", "BE", "AT", "ONE", "HAVE", "THIS", "FROM", "BY", "HOT", "WORD", "BUT", "WHAT",
         "SOME", "WE", "CAN", "OUT", "OTHER", "WERE", "ALL", "THERE", "WHEN", "UP", "USE", "YOUR", "HOW", "SAID")


@dataclass
class Session:
    day: int
    tx1: List[np.ndarray]  # (frames, area_channels) float32 per trial
    spike_pow: List[np.ndarray]
    sentences: List[str]
    blocks: np.ndarray  # block number of each trial (1, 2, ...), non-decreasing

    @property
    def lengths(self) -> List[int]:
        return [a.shape[0] for a in self.tx1]


def lengths_by_block(traffic: dict) -> List[List[int]]:
    """Each block's trial lengths (before the seed orders them)."""
    n, nb = traffic["trials_per_session"], traffic["blocks_per_session"]
    if n % nb:
        raise ValueError(f"{n} trials do not split into {nb} equal blocks")
    grid = np.round(np.linspace(traffic["min_frames"], traffic["max_frames"], n)).astype(int)
    if len(set(grid.tolist())) != n:
        raise ValueError("the length grid repeats a length: a trial would not be named by its session and length")
    return [grid[b::nb].tolist() for b in range(nb)]


def sentence(rng: np.random.Generator, frames: int, kernel: int = 32, stride: int = 4) -> str:
    budget = ((frames - kernel) // stride) // 2  # characters, spaces included
    words: List[str] = []
    while True:
        word = WORDS[int(rng.integers(len(WORDS)))]
        if len(" ".join(words + [word])) > budget:
            break
        words.append(word)
    return " ".join(words) or "A"


def make_sessions(traffic: dict, seed: int) -> List[Session]:
    rng = np.random.default_rng([int(seed), 12])
    blocks = lengths_by_block(traffic)
    width = traffic["area_channels"]
    out = []
    for day in range(traffic["sessions"]):
        order = [rng.permutation(b).tolist() for b in blocks]
        lens = [t for b in order for t in b]
        out.append(Session(
            day=day,
            tx1=[rng.integers(0, 5, (t, width), dtype=np.uint8).astype(np.float32) for t in lens],
            spike_pow=[rng.standard_exponential((t, width), dtype=np.float32) for t in lens],
            sentences=[sentence(rng, t) for t in lens],
            blocks=np.repeat(np.arange(1, len(blocks) + 1), [len(b) for b in blocks]),
        ))
    return out


def write_splits(sessions: List[Session], root: str) -> str:
    """train/<session>.mat for every session (the program carves its test
    split off each file's first block and trains on the rest), and an empty
    test/ (the validation split, which no cell reads)."""
    from scipy.io import savemat

    for split in ("train", "test"):
        os.makedirs(os.path.join(root, split), exist_ok=True)
    for s in sessions:
        n = len(s.tx1)
        tx1, sp = np.empty((1, n), dtype=object), np.empty((1, n), dtype=object)
        for i in range(n):
            tx1[0, i], sp[0, i] = s.tx1[i], s.spike_pow[i]
        savemat(os.path.join(root, "train", f"{SESSIONS[s.day]}.mat"),
                {"sentenceText": np.asarray(s.sentences), "tx1": tx1, "spikePow": sp,
                 "blockIdx": s.blocks.astype(np.float64)[:, None]})
    return root
