"""Host-side batch loader (counterpart of wav2vec2forbrain_tpu/data/loader.py).

Shuffled fixed-size batching, the day-homogeneous batch sampler
(--day_batches) and length-sorted composition (--length_sorted_batches),
all from python `random.Random` streams, so the same seed gives the same
index batches as the JAX package's loader.
"""

import random
from typing import Callable, Dict, Iterator, List, Optional

from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch
from wav2vec2forbrain_tpu_torch.util import profiling


class Brain2TextBatchSampler:
    """Batches that never mix recording days. With `length_key`, each day's
    samples are length-sorted before they are sliced into batches (the
    composition becomes deterministic; the batch order still shuffles)."""

    def __init__(self, data, batch_size: int, shuffle: bool = True, rng=None, length_key=None):
        self.shuffle = shuffle
        self.batch_size = batch_size
        self._rng = rng if rng is not None else random.Random()
        self.length_key = length_key
        self.day_index = self.build_day_index(data)
        self.batches = self.build_batches()

    def __iter__(self):
        if self.shuffle:
            self._rng.shuffle(self.batches)
        for batch in self.batches:
            yield batch

    def __len__(self):
        return len(self.batches)

    def build_batches(self) -> List[List[int]]:
        batches: List[List[int]] = []
        batch: List[int] = []
        for indices in self.day_index.values():
            if self.length_key is not None:
                indices.sort(key=self.length_key)
            else:
                self._rng.shuffle(indices)
            for index in indices:
                batch.append(index)
                if len(batch) == self.batch_size:
                    batches.append(batch)
                    batch = []
            if len(batch) > 0:
                batches.append(batch)
                batch = []
        return batches

    def build_day_index(self, data) -> Dict[int, List[int]]:
        day_idx: Dict[int, List[int]] = {}
        for i in range(len(data)):
            day_idx.setdefault(data.samples[i].day_idx, []).append(i)
        return day_idx


class DataLoader:
    """Shuffling batch iterator over a dataset with a collate fn."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable[[list], B2tBatch],
        shuffle: bool = False,
        batch_sampler: Optional[Brain2TextBatchSampler] = None,
        seed: int = 0,
        length_key=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.batch_sampler = batch_sampler
        self.length_key = length_key
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def rng_state(self):
        """The shuffle streams' state (a train-state checkpoint keeps it, so
        a resumed run draws the epochs a straight run would)."""
        sampler = self.batch_sampler
        return {"loader": self._rng.getstate(), "sampler": None if sampler is None else sampler._rng.getstate()}

    def set_rng_state(self, state) -> None:
        self._rng.setstate(_as_state(state["loader"]))
        if self.batch_sampler is not None and state["sampler"] is not None:
            self.batch_sampler._rng.setstate(_as_state(state["sampler"]))

    def iter_index_batches(self) -> Iterator[List[int]]:
        """The epoch's batch compositions as index lists."""
        if self.batch_sampler is not None:
            yield from self.batch_sampler
            return
        order = list(range(len(self.dataset)))
        if self.length_key is not None:
            order.sort(key=self.length_key)
            batches = [order[s : s + self.batch_size] for s in range(0, len(order), self.batch_size)]
            if self.shuffle:
                self._rng.shuffle(batches)
            yield from batches
            return
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            yield order[start : start + self.batch_size]

    def __iter__(self) -> Iterator[B2tBatch]:
        """Each batch collated as it is asked for: a `collate` span
        (util/profiling.py) keyed on its index in the epoch."""
        for k, idxs in enumerate(self.iter_index_batches()):
            with profiling.span("collate", k):
                batch = self.collate_fn([self.dataset[i] for i in idxs])
            yield batch


def _as_state(state):
    """random.Random state back from a checkpoint (lists where it had tuples)."""
    version, internal, gauss = state
    return (version, tuple(internal), gauss)
