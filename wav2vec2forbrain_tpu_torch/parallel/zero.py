"""ZeRO-1: the Adam moments split over the data axis (counterpart of
wav2vec2forbrain_tpu/parallel/zero.py, --optimizer_state_sharding=zero1).

The JAX package's layout (`zero1_pspec`): each moment leaf is split over
the dp ranks on its FIRST dimension divisible by dp that the model axis
does not already split (parallel/tensor.py), and a leaf with no such
dimension (or a scalar, the step count) stays whole on every rank. Here
data index d keeps the d-th of the dp equal pieces of that dimension of
its (model-axis) piece. A step (train/optim.py::Optimizer.step) updates,
on every rank, its piece of each split leaf (params, gradient and moments
narrowed alike) and the whole of every other leaf; then the params' pieces
are all-gathered over the data group, so every rank holds its whole
model-axis piece of the params again. Each element takes the same
arithmetic as in the replicated update, so the params come out bitwise the
same. The gradients stay summed by an all-reduce before the update (gloo
has no reduce-scatter): what ZeRO-1 saves is the moments' memory, (dp - 1)
/ dp of it on every rank.
"""

from typing import Optional, Tuple

import torch

from wav2vec2forbrain_tpu_torch.parallel import distributed
from wav2vec2forbrain_tpu_torch.parallel.mesh import DataShard
from wav2vec2forbrain_tpu_torch.parallel.tensor import split_dims
from wav2vec2forbrain_tpu_torch.tree import tree_map


def zero1_dim(shape, dp: int, model_dim: Optional[int] = None) -> Optional[int]:
    """The dimension a leaf of `shape` is split on over dp ranks, or None
    (not split): the first one divisible by dp other than model_dim (the
    dim the model axis splits), as zero1_pspec picks it. Every other dim
    has the same length in the whole leaf and in a model-axis piece."""
    if dp <= 1:
        return None
    for d, n in enumerate(shape):
        if d != model_dim and n % dp == 0:
            return d
    return None


class Zero1:
    """This rank's pieces of the split leaves. Methods that take trees find
    each leaf's model-axis dim from its path (parallel/tensor.py)."""

    def __init__(self, shard: DataShard):
        self.shard = shard

    def model_dims(self, tree):
        """Each leaf's model-axis dim (None without a model axis)."""
        if self.shard.model is None:
            return tree_map(lambda _: None, tree)
        return split_dims(tree)

    def piece(self, shape, model_dim: Optional[int] = None) -> Optional[Tuple[int, int, int]]:
        """(dim, start, length) of this rank's piece of a leaf of `shape`,
        or None where the leaf is not split."""
        d = zero1_dim(shape, self.shard.size, model_dim)
        if d is None:
            return None
        n = shape[d] // self.shard.size
        return d, self.shard.rank * n, n

    def local(self, t: torch.Tensor, model_dim: Optional[int] = None) -> torch.Tensor:
        """A view of this rank's piece of t (t itself where not split)."""
        p = self.piece(t.shape, model_dim)
        return t if p is None else t.narrow(*p)

    def shard_moments(self, tree):
        """Whole moment leaves -> this rank's pieces (copies)."""
        return tree_map(lambda t, md: None if t is None else self.local(t, md).clone(), tree,
                        self.model_dims(tree))

    def full_moments(self, tree, params):
        """This rank's moment pieces -> whole leaves, shaped like `params`'
        leaves (a collective: every rank calls it)."""
        jobs = []

        def whole(m, p, md):
            if m is None:
                return None
            piece = self.piece(p.shape, md)
            if piece is None:
                return m.clone()
            full = torch.empty(p.shape, dtype=m.dtype, device=m.device)
            jobs.append((full, m, piece[0]))
            return full

        out = tree_map(whole, tree, params, self.model_dims(params))
        distributed.all_gather_pieces(jobs, self.shard.group)
        return out

    def gather_params(self, params, labels) -> None:
        """Every rank's updated pieces of the split trainable params, in
        place (a collective: every rank calls it)."""
        jobs = []

        def add(p, label, md):
            piece = self.piece(p.shape, md)
            if label != "frozen" and piece is not None:
                jobs.append((p, p.narrow(*piece), piece[0]))

        tree_map(add, params, labels, self.model_dims(params))
        distributed.all_gather_pieces(jobs, self.shard.group)
