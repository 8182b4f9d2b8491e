"""The data-parallel layout (counterpart of
wav2vec2forbrain_tpu/parallel/mesh.py::make_mesh and its batch sharding).

The JAX package shards each batch over the 'data' axis of a ('data',
'model') mesh. In the port every rank loads the same global batch, pads it
to the same row count, chooses its width, and keeps its own contiguous
rows: rank r of dp holds rows [r * B / dp, (r + 1) * B / dp). That is the
layout of P('data') on the leading dim, so rank r computes what mesh
device r computes. Tensor parallelism (a 'model' axis above 1) is not
ported.
"""

from typing import Any, NamedTuple, Optional

from wav2vec2forbrain_tpu_torch.parallel import distributed

TENSOR_PARALLEL_NOT_PORTED = "tensor parallelism (--mesh_model_parallel > 1) is not ported: ROADMAP.md, Queue 1"


class DataShard(NamedTuple):
    """This rank's place on the data axis: rank r of `size`, and the
    process group whose ranks hold the other rows."""

    rank: int
    size: int
    group: Any

    def rows(self, global_rows: int) -> slice:
        """This rank's rows of a batch of global_rows (a multiple of size)."""
        if global_rows % self.size:
            raise ValueError(f"{global_rows} rows do not split over {self.size} ranks")
        local = global_rows // self.size
        return slice(self.rank * local, (self.rank + 1) * local)


def make_mesh(data_parallel: int = 0, model_parallel: int = 1) -> Optional[DataShard]:
    """The data axis over the ranks of the process group: data_parallel 0
    means every rank, any other value must equal the world size. None in
    one process (data axis 1), where nothing is split or reduced."""
    if model_parallel > 1:
        raise NotImplementedError(f"{TENSOR_PARALLEL_NOT_PORTED} (--mesh_model_parallel={model_parallel})")
    world = distributed.world_size()
    dp = world if data_parallel <= 0 else data_parallel
    if dp != world:
        raise ValueError(f"--mesh_data_parallel={data_parallel} needs {dp} ranks; the process group has {world} "
                         "(run one process a rank: python -m torch.distributed.run --nproc_per_node=N ...)")
    if dp == 1:
        return None
    import torch.distributed as dist

    return DataShard(distributed.rank(), dp, dist.group.WORLD)


def padded_rows(batch_size: int, true_rows: int, dp: int) -> int:
    """A batch's rows after padding: --batch_size (or more, for a larger
    batch) rounded up to the data axis, as the JAX Trainer._put pads."""
    target = max(batch_size, true_rows)
    return -(-target // dp) * dp
