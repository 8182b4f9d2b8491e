"""The train steps' seed streams, drawn by the benchmark from --seed and
handed to both sides: each step's dropout seeds (GRU, encoder and head
streams), its LayerDrop decisions, and the seed of the device generator
that draws the augmentation noise.

LayerDrop drops layerdrop x layers of a step on average, as the model's
Bernoulli draws do, but as a fixed count a step (the running total rounded,
from a phase the seed draws: 2 or 3 of 24 layers at 0.1), the layers
themselves drawn from the seed. So every seed's steps do the same work and
the window's rate does not move with how many layers a seed happened to
drop."""

import math
from typing import List

import numpy as np

INT31 = 2**31 - 1


def seeds_per_step(n_layers: int) -> int:
    """Enough seeds for every stream of a step: eight sites a layer and some."""
    return 16 + 8 * n_layers


class StepDraws:
    """What one train step was handed."""

    def __init__(self, rng: np.random.Generator, n_layers: int, layerdrop: float, n_seeds: int, index: int,
                 phase: float):
        self.gru = rng.integers(0, INT31, n_seeds).tolist()
        self.enc = rng.integers(0, INT31, n_seeds).tolist()
        self.head = rng.integers(0, INT31, n_seeds).tolist()
        per_step = layerdrop * n_layers
        k = math.floor((index + 1) * per_step + phase) - math.floor(index * per_step + phase)
        dropped = set(rng.choice(n_layers, size=k, replace=False).tolist())
        self.layerdrop = [i in dropped for i in range(n_layers)]


def bench_rng(seed: int, device, n_layers: int, layerdrop: float):
    """A program StepRng whose forwards replay StepDraws drawn on demand
    from the seed; `draws` lists them in the order the steps took them."""
    from wav2vec2forbrain_tpu_torch.models.seeds import ForwardRng, SeedStream, StepRng

    n_seeds = seeds_per_step(n_layers)

    class BenchRng(StepRng):
        def __init__(self):
            self._draw = np.random.default_rng([int(seed), 7])
            self.noise_seed = int(self._draw.integers(2**62))
            self._phase = float(self._draw.random())
            super().__init__(self.noise_seed, device)
            self.draws: List[StepDraws] = []

        def next_forward(self, row0: int = 0, group=None):
            d = StepDraws(self._draw, n_layers, layerdrop, n_seeds, len(self.draws), self._phase)
            self.draws.append(d)
            fr = ForwardRng(SeedStream(seeds=d.gru), SeedStream(seeds=d.enc, layerdrop=[d.layerdrop]),
                            SeedStream(seeds=d.head))
            fr.place(row0, group)
            self.forwards.append(fr)
            return fr

        def mark(self):
            return super().mark(), self._draw.bit_generator.state, len(self.draws)

        def rewind(self, mark) -> None:
            base, state, n = mark
            super().rewind(base)
            self._draw.bit_generator.state = state
            del self.draws[n:]

    return BenchRng()
