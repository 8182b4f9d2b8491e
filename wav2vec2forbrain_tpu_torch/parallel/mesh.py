"""The (data, model) process grid (counterpart of
wav2vec2forbrain_tpu/parallel/mesh.py::make_mesh and its batch sharding).

The JAX package lays its devices out as `devices.reshape(dp, mp)` with axes
('data', 'model'). The port runs one process a rank and lays the ranks out
alike: global rank r sits at data index r // mp and model index r % mp.
Two kinds of process group join them (every rank creates every group, in
the same order: `dist.new_group` is collective):

- a data group per model index: the ranks that hold the other rows of the
  batch and the same pieces of the params. The gradient all-reduce, the
  BatchNorm batch sums, the loss and the gathered eval outputs run over it;
- a model group per data index: the ranks that hold the same rows and the
  other pieces of the split encoder matmuls (parallel/tensor.py).

Each batch is split over the data axis: every rank loads the same global
batch, pads it to the same row count, chooses its width, and keeps the
rows of its data index d: [d * B / dp, (d + 1) * B / dp). That is the
layout of P('data') on the leading dim, so the ranks compute what the mesh
devices compute. The ranks of a model group hold the same rows.
"""

from typing import Any, NamedTuple, Optional

from wav2vec2forbrain_tpu_torch.parallel import distributed
from wav2vec2forbrain_tpu_torch.parallel.tensor import TensorShard


class DataShard(NamedTuple):
    """This rank's place on the grid: data index `rank` of `size`, the data
    group whose ranks hold the other rows, and its place on the model axis
    (`model`, None without one)."""

    rank: int
    size: int
    group: Any
    model: Optional[TensorShard] = None

    def rows(self, global_rows: int) -> slice:
        """This rank's rows of a batch of global_rows (a multiple of size)."""
        if global_rows % self.size:
            raise ValueError(f"{global_rows} rows do not split over {self.size} ranks")
        local = global_rows // self.size
        return slice(self.rank * local, (self.rank + 1) * local)


def make_mesh(data_parallel: int = 0, model_parallel: int = 1) -> Optional[DataShard]:
    """The grid over the ranks of the process group: model_parallel ranks a
    model group, data_parallel 0 meaning world // model_parallel; any other
    value must make data_parallel x model_parallel the world size. None in
    one process (a 1 x 1 grid), where nothing is split or reduced."""
    world = distributed.world_size()
    mp = max(1, model_parallel)
    if world % mp:
        raise ValueError(f"--mesh_model_parallel={mp} does not divide the world size {world} "
                         "(run one process a rank: python -m torch.distributed.run --nproc_per_node=N ...)")
    dp = world // mp if data_parallel <= 0 else data_parallel
    if dp * mp != world:
        raise ValueError(f"--mesh_data_parallel={data_parallel} x --mesh_model_parallel={mp} needs {dp * mp} "
                         f"ranks; the process group has {world} "
                         "(run one process a rank: python -m torch.distributed.run --nproc_per_node=N ...)")
    if world == 1:
        return None
    import torch.distributed as dist

    r = distributed.rank()
    if mp == 1:
        return DataShard(r, dp, dist.group.WORLD)
    data_groups = [dist.new_group([d * mp + m for d in range(dp)]) for m in range(mp)]
    model_groups = [dist.new_group([d * mp + m for m in range(mp)]) for d in range(dp)]
    d, m = divmod(r, mp)
    return DataShard(d, dp, data_groups[m], TensorShard(m, mp, model_groups[d]))


def padded_rows(batch_size: int, true_rows: int, dp: int) -> int:
    """A batch's rows after padding: --batch_size (or more, for a larger
    batch) rounded up to the data axis, as the JAX Trainer._put pads."""
    target = max(batch_size, true_rows)
    return -(-target // dp) * dp
