"""Where train mode's randomness comes from: dropout seeds, LayerDrop
decisions and the augmentation noise.

The JAX package draws every dropout site's int32 seed and the LayerDrop
uniforms from a `jax.random` key chain (ops/hash_dropout.py::
dropout_with_rng, ops/pallas_attention.py::mha_with_rng,
models/wav2vec2.py::layerdrop_mask), which torch cannot reproduce. The port
draws the same things in the same site order from explicit generators
instead, or replays a sequence that a test supplies:

- `SeedStream`: one chain of sites. `seed()` gives the next site's seed in
  [0, 2^31 - 1), `layerdrop_mask(n, rate)` the next LayerDrop decisions.
- `ForwardRng`: the forward's three streams, kept apart as the JAX forward
  splits its key into gru_rng, enc_rng and head_rng
  (models/assembly.py::forward), so each can be replayed on its own.
- `StepRng`: a train step's source: a `ForwardRng` per step and the
  white-noise / constant-offset augmentation noise on the batch's device.

Seeds and LayerDrop uniforms come from CPU generators: drawing them never
waits on the card.

Under data parallelism every rank seeds the same generators, so the ranks
draw the same seeds, LayerDrop decisions and noise: a layer dropped on one
rank is dropped on all. A stream also says where its forward's rows sit in
the global batch: `row0`, the global index of local row 0, on which every
dropout mask is keyed (ops/hash_dropout.py, the attention kernels), and
`group`, the process group whose ranks hold the other rows, over which
train-mode BatchNorm takes its batch statistics (models/conformer.py).
One process: row0 0, group None. On a (data, model) grid (parallel/mesh.py)
row0 follows the rank's data index and group is its data group: the ranks
of a model group hold the same rows and draw the same masks. The augmentation noise is drawn at the
global batch's shape and sliced to the rank's rows (`StepRng.normal`).

The dropout sites of one encoder layer, in the order the JAX layer draws
their seeds (each config field names a site's rate; a site whose rate is 0
draws nothing), are CONFORMER_LAYER_SITES and W2V_LAYER_SITES;
`sites_per_layer` counts the live ones, which is also how many seeds a
layer that LayerDrop skips consumes.
"""

from typing import List, NamedTuple, Optional, Sequence

import torch

INT32_MAX = 2**31 - 1

# models/conformer.py::conformer_layer: each FFN half's activation and
# output, the attention probabilities and output, the conv module
CONFORMER_LAYER_SITES = (
    "activation_dropout", "hidden_dropout",
    "attention_dropout", "attention_dropout",
    "conformer_conv_dropout",
    "activation_dropout", "hidden_dropout",
)
# models/wav2vec2.py::encoder_layer (both LN forms): the attention
# probabilities, the attention output, the FFN activation, the FFN output
W2V_LAYER_SITES = ("attention_dropout", "hidden_dropout", "activation_dropout", "hidden_dropout")


def sites_per_layer(cfg, sites) -> int:
    """Seeds one train-mode layer of encoder config `cfg` draws."""
    return sum(getattr(cfg, name) > 0.0 for name in sites)


class SeedStream:
    """One stream of dropout seeds and LayerDrop decisions.

    Either from a CPU torch.Generator, or a replay of `seeds` (one int per
    site, in site order) and `layerdrop` (one sequence of n bools per
    layerdrop_mask call); a replay that runs out raises."""

    def __init__(
        self,
        generator: Optional[torch.Generator] = None,
        seeds: Optional[Sequence[int]] = None,
        layerdrop: Optional[Sequence[Sequence[bool]]] = None,
    ):
        if (generator is None) == (seeds is None and layerdrop is None):
            raise ValueError("SeedStream: give a generator or a replay (seeds / layerdrop), not both")
        self._gen = generator
        self._seeds = None if seeds is None else [int(s) for s in seeds]
        self._layerdrop = None if layerdrop is None else [list(map(bool, m)) for m in layerdrop]
        self.row0 = 0  # global batch index of the forward's local row 0
        self.group = None  # data-parallel process group of the other rows (None: one process)
        self.n_seeds = 0  # seeds handed out so far
        self.layerdrop_drawn: List[List[bool]] = []  # every LayerDrop mask handed out

    def seed(self) -> int:
        if self._gen is not None:
            s = int(torch.randint(0, INT32_MAX, (), generator=self._gen))
        else:
            if self._seeds is None or self.n_seeds >= len(self._seeds):
                raise RuntimeError(f"SeedStream replay ran out of seeds after {self.n_seeds}")
            s = self._seeds[self.n_seeds]
        self.n_seeds += 1
        return s

    def skip(self, n: int) -> None:
        """Advance past n sites (a layer that LayerDrop skips consumes its
        sites' seeds, as the JAX forward computes it and masks it out)."""
        for _ in range(n):
            self.seed()

    def mark(self):
        """Where the stream stands now; `rewind(mark)` goes back there."""
        return None if self._gen is None else self._gen.get_state(), self.n_seeds, len(self.layerdrop_drawn)

    def rewind(self, mark) -> None:
        state, self.n_seeds, n_masks = mark
        if state is not None:
            self._gen.set_state(state)
        del self.layerdrop_drawn[n_masks:]

    def layerdrop_mask(self, n: int, rate: float) -> List[bool]:
        """n decisions, True = skip the layer (u < rate, u ~ U[0, 1))."""
        if self._gen is not None:
            mask = (torch.rand(n, generator=self._gen) < rate).tolist()
        else:
            i = len(self.layerdrop_drawn)
            if self._layerdrop is None or i >= len(self._layerdrop):
                raise RuntimeError("SeedStream replay has no LayerDrop mask left")
            mask = self._layerdrop[i]
            if len(mask) != n:
                raise ValueError(f"replayed LayerDrop mask has {len(mask)} entries, the encoder {n} layers")
        self.layerdrop_drawn.append(mask)
        return mask


class ForwardRng(NamedTuple):
    """The forward's three streams (JAX: gru_rng, enc_rng, head_rng)."""

    gru: SeedStream
    enc: SeedStream
    head: SeedStream

    def place(self, row0: int, group) -> "ForwardRng":
        """Set where the forward's rows sit in the global batch (every stream)."""
        for s in self:
            s.row0, s.group = row0, group
        return self


def _sub_generator(parent: torch.Generator) -> torch.Generator:
    return torch.Generator().manual_seed(int(torch.randint(0, 2**62, (), generator=parent)))


def forward_rng(generator: torch.Generator) -> ForwardRng:
    """Three independent streams, each seeded from `generator` (CPU)."""
    return ForwardRng(*(SeedStream(_sub_generator(generator)) for _ in range(3)))


class StepRng:
    """A train step's random source.

    seed: seeds a CPU generator (dropout seeds, LayerDrop) and a generator
    on `device` (augmentation noise; the card unless the caller asks for
    another, and it raises where there is no card). replay: a list of
    ForwardRng, one per step, handed out in order instead of generated ones
    (tests)."""

    def __init__(self, seed: int = 0, device="cuda", replay: Optional[List[ForwardRng]] = None):
        self._host = torch.Generator().manual_seed(int(seed))
        self._device = torch.Generator(device=device).manual_seed(int(seed))
        self._replay = None if replay is None else list(replay)
        self.forwards: List[ForwardRng] = []  # every ForwardRng handed out, in order

    def next_forward(self, row0: int = 0, group=None) -> ForwardRng:
        """The next step's streams, placed at rows [row0, ...) of a global
        batch split over `group` (models/seeds.py's header)."""
        if self._replay is not None:
            if not self._replay:
                raise RuntimeError("StepRng replay ran out of steps")
            fr = self._replay.pop(0)
        else:
            fr = forward_rng(self._host)
        fr.place(row0, group)
        self.forwards.append(fr)
        return fr

    def mark(self):
        """Where the source stands now, a replay's streams included;
        `rewind(mark)` goes back there (a step run again draws what it drew
        the first time)."""
        replay = None if self._replay is None else [(fr, [s.mark() for s in fr]) for fr in self._replay]
        return self._host.get_state(), self._device.get_state(), len(self.forwards), replay

    def rewind(self, mark) -> None:
        host, device, n_forwards, replay = mark
        self._host.set_state(host)
        self._device.set_state(device)
        del self.forwards[n_forwards:]
        if replay is not None:
            for fr, marks in replay:
                for stream, m in zip(fr, marks):
                    stream.rewind(m)
            self._replay = [fr for fr, _ in replay]

    def normal(self, shape, device, rows: Optional[slice] = None) -> torch.Tensor:
        """f32 N(0, 1) noise of `shape` on the device generator; with rows,
        shape is the global batch's and the noise those rows of it."""
        x = torch.randn(shape, generator=self._device, device=device, dtype=torch.float32)
        return x if rows is None else x[rows]
