"""ZeRO-1: the Adam moments split over the data axis (counterpart of
wav2vec2forbrain_tpu/parallel/zero.py, --optimizer_state_sharding=zero1).

The JAX package's layout (`zero1_pspec` without a model axis): each moment
leaf is split over the dp ranks on its FIRST dimension divisible by dp, and
a leaf with no such dimension (or a scalar, the step count) stays whole on
every rank. Here rank r keeps the r-th of the dp equal pieces of that
dimension. A step (train/optim.py::Optimizer.step) updates, on every rank,
its piece of each split leaf (params, gradient and moments narrowed alike)
and the whole of every other leaf; then the params' pieces are
all-gathered, so every rank holds the whole params again. Each element
takes the same arithmetic as in the replicated update, so the params come
out bitwise the same. The gradients stay summed by an all-reduce before
the update (gloo has no reduce-scatter): what ZeRO-1 saves is the
moments' memory, (dp - 1) / dp of it on every rank.
"""

from typing import List, Optional, Tuple

import torch

from wav2vec2forbrain_tpu_torch.parallel import distributed
from wav2vec2forbrain_tpu_torch.parallel.mesh import DataShard
from wav2vec2forbrain_tpu_torch.tree import tree_map


def zero1_dim(shape, dp: int) -> Optional[int]:
    """The dimension a leaf of `shape` is split on over dp ranks, or None
    (not split): the first one divisible by dp, as zero1_pspec picks it."""
    if dp <= 1:
        return None
    for d, n in enumerate(shape):
        if n % dp == 0:
            return d
    return None


class Zero1:
    """This rank's pieces of the split leaves."""

    def __init__(self, shard: DataShard):
        self.shard = shard

    def piece(self, shape) -> Optional[Tuple[int, int, int]]:
        """(dim, start, length) of this rank's piece of a leaf of `shape`,
        or None where the leaf is not split."""
        d = zero1_dim(shape, self.shard.size)
        if d is None:
            return None
        n = shape[d] // self.shard.size
        return d, self.shard.rank * n, n

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """A view of this rank's piece of t (t itself where not split)."""
        p = self.piece(t.shape)
        return t if p is None else t.narrow(*p)

    def shard_moments(self, tree):
        """Whole moment leaves -> this rank's pieces (copies)."""
        return tree_map(lambda t: None if t is None else self.local(t).clone(), tree)

    def full_moments(self, tree, params):
        """This rank's moment pieces -> whole leaves, shaped like `params`'
        leaves (a collective: every rank calls it)."""
        jobs = []

        def whole(m, p):
            if m is None:
                return None
            if self.piece(p.shape) is None:
                return m.clone()
            full = torch.empty(p.shape, dtype=m.dtype, device=m.device)
            jobs.append((full, m))
            return full

        out = tree_map(whole, tree, params)
        self._all_gather(jobs)
        return out

    def gather_params(self, params, labels) -> None:
        """Every rank's updated pieces of the split trainable params, in
        place (a collective: every rank calls it)."""
        jobs = []

        def add(p, label):
            if label != "frozen" and self.piece(p.shape) is not None:
                jobs.append((p, self.local(p)))

        tree_map(add, params, labels)
        self._all_gather(jobs)

    def _all_gather(self, jobs: List[Tuple[torch.Tensor, torch.Tensor]]) -> None:
        """For each (whole, piece): every rank's piece written into its place
        of `whole`, in flat buckets of one dtype."""
        for idx in distributed.buckets([piece for _, piece in jobs]):
            bucket = [jobs[i] for i in idx]
            flat = torch.cat([piece.reshape(-1) for _, piece in bucket])
            parts = distributed.gather_rows(flat, self.shard.group).split(flat.numel())
            sizes = [piece.numel() for _, piece in bucket]
            for r, part in enumerate(parts):
                for (whole, piece), got in zip(bucket, part.split(sizes)):
                    d, _, n = self.piece(whole.shape)
                    whole.narrow(d, r * n, n).copy_(got.view(piece.shape))
