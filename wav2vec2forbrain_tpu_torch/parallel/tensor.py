"""Tensor parallelism: the Megatron column / row split of the encoder
matmuls over the 'model' axis (counterpart of the model-axis rules of
wav2vec2forbrain_tpu/parallel/mesh.py::param_pspec, and of the head
partitioning of wav2vec2forbrain_tpu/parallel/kernel_partition.py's
attention kernel).

The JAX package lets GSPMD split the sharded matmuls and place their
collectives. The port writes the pattern out: rank m of the mp ranks of a
model group (parallel/mesh.py) holds

- column-split kernels (q / k / v projections, the FFN's up-projection):
  columns [m * n / mp, (m + 1) * n / mp) of the output dim, and the same
  slice of their biases (a scan-stacked leaf keeps its leading layer dim
  whole);
- row-split kernels (the attention's output projection, the FFN's
  down-projection): the same rows of the input dim;
- every other leaf whole: the row-split layers' biases, the LayerNorms, the
  conv module, BatchNorm, the pos-conv, the brain encoder, the lm_head.

So a rank holds heads [m * H / mp, (m + 1) * H / mp) of every attention
layer and that slice of every FFN's intermediate columns. The encoder
blocks (models/conformer.py, models/wav2vec2.py) enter the column-split
linears through `enter` (identity forward, dX all-reduced over the model
group in the backward) and leave the row-split ones through `row_linear`
(the f32 partial products all-reduced in the forward, then the bias added
once and the result cast; identity backward). Every rank of a model group
then holds the same block output, and the same loss.

Trees: every rank builds or loads the whole tree, then keeps its pieces
(`split_tree`); a file is written from the whole tree, gathered over the
model group (`gather_tree`), so it reads at any (dp, mp).
"""

import re
from typing import Any, NamedTuple, Optional, Tuple

import torch

from wav2vec2forbrain_tpu_torch.models.fc import matmul_f32
from wav2vec2forbrain_tpu_torch.parallel import distributed
from wav2vec2forbrain_tpu_torch.tree import tree_map, tree_map_with_path

# the JAX package's patterns (wav2vec2forbrain_tpu/parallel/mesh.py), on the
# port's "/"-joined tree paths
_COLUMN = r"(q_proj|k_proj|v_proj|linear_q|linear_k|linear_v|intermediate_dense)"
_ROW = r"(out_proj|linear_out|output_dense)"
COLUMN_KERNEL = re.compile(_COLUMN + r"/kernel$")
ROW_KERNEL = re.compile(_ROW + r"/kernel$")
COLUMN_BIAS = re.compile(_COLUMN + r"/bias$")


def split_dim(path: str, ndim: int) -> Optional[int]:
    """The dim a leaf at `path` (tree.py's "/a/0/b" form) of `ndim` dims is
    split on over the model axis, or None (whole on every rank)."""
    if COLUMN_KERNEL.search(path) or COLUMN_BIAS.search(path):
        return ndim - 1
    if ROW_KERNEL.search(path):
        return ndim - 2
    return None


def split_dims(tree):
    """A tree like `tree` of each leaf's split dim (None: whole, and at None
    leaves). Paths are matched by suffix, so a moment tree that mirrors the
    params matches as they do."""
    return tree_map_with_path(lambda path, t: None if t is None else split_dim(path, t.dim()), tree)


def check_divides(mp: int, num_heads: int, intermediate_size: int) -> None:
    """The model axis must split the heads and the FFN's columns evenly."""
    if mp > 1 and (num_heads % mp or intermediate_size % mp):
        raise ValueError(f"--mesh_model_parallel={mp} must divide the encoder's {num_heads} attention heads and "
                         f"its intermediate size {intermediate_size}")


class TensorShard(NamedTuple):
    """This rank's place on the model axis: index `rank` of `size`, and the
    process group of the ranks that hold the other pieces (the same data
    index)."""

    rank: int
    size: int
    group: Any

    def span(self, n: int) -> Tuple[int, int]:
        """(start, length) of this rank's piece of n (heads, columns, rows)."""
        if n % self.size:
            raise ValueError(f"{n} does not split over {self.size} model ranks")
        local = n // self.size
        return self.rank * local, local

    def local(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """A view of this rank's piece of whole t (t itself where dim is None)."""
        if dim is None:
            return t
        start, n = self.span(t.shape[dim])
        return t.narrow(dim, start, n)


def heads_of(tp: Optional[TensorShard], num_heads: int) -> Tuple[int, int]:
    """(the heads this rank holds, the global index of its first)."""
    if tp is None:
        return num_heads, 0
    start, n = tp.span(num_heads)
    return n, start


def col0_of(tp: Optional[TensorShard], local_cols: int) -> int:
    """The global index of this rank's first column of a column-split output
    that holds local_cols columns here."""
    return 0 if tp is None else tp.rank * local_cols


def split_tree(tree, tp: Optional[TensorShard]):
    """Whole leaves -> this rank's pieces (contiguous copies of the split
    leaves; the whole leaves themselves)."""
    if tp is None:
        return tree
    return tree_map(lambda t, d: t if t is None or d is None else tp.local(t, d).clone(), tree, split_dims(tree))


def gather_tree(tree, tp: Optional[TensorShard]):
    """This rank's pieces -> whole leaves, on every rank (a collective over
    the model group: every rank calls it); a whole leaf comes back as
    itself."""
    if tp is None:
        return tree
    jobs = []

    def whole(t, d):
        if t is None or d is None:
            return t
        shape = list(t.shape)
        shape[d] *= tp.size
        full = torch.empty(shape, dtype=t.dtype, device=t.device)
        jobs.append((full, t, d))
        return full

    out = tree_map(whole, tree, split_dims(tree))
    distributed.all_gather_pieces(jobs, tp.group)
    return out


# --- the split blocks' ends ----------------------------------------------------------


def enter(x: torch.Tensor, tp: Optional[TensorShard]) -> torch.Tensor:
    """x on its way into column-split linears: the identity forward; the
    backward sums dX over the model group (each rank's dX covers its
    columns only)."""
    return x if tp is None else distributed.enter_split(x, tp.group)


def row_product(params: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The f32 product of a row-split linear's kernel and x: under tensor
    parallelism this rank's rows times its columns of x, a partial sum."""
    kernel = params["kernel"]
    cd = compute_dtype or torch.promote_types(x.dtype, kernel.dtype)
    return matmul_f32(x.to(cd), kernel.to(cd))


def row_finish(params: dict, y: torch.Tensor, tp: Optional[TensorShard], out_dtype) -> torch.Tensor:
    """A row-split linear after its product: the partial products summed
    over the model group (the backward passes dY through to each rank's
    partial product), then the whole bias added once and the sum cast to
    out_dtype."""
    if tp is not None:
        y = distributed.sum_partials(y, tp.group)
    return (y + params["bias"]).to(out_dtype)


def row_linear(params: dict, x: torch.Tensor, tp: Optional[TensorShard], compute_dtype, out_dtype):
    """A row-split linear (models/fc.py::apply_linear's dtype contract, which
    it is without tp): row_product, then row_finish."""
    return row_finish(params, row_product(params, x, compute_dtype), tp, out_dtype)
