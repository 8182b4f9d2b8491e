"""CLI entry point of the port (counterpart of the repository's run.py).

    python -m wav2vec2forbrain_tpu_torch.run --experiment_type=b2p2t_gru+w2v_conformer \
        --w2v_skip_loading_weights=true [flags...]

Data-parallel training, one process a card (NCCL; rank r on cuda:r):

    python -m torch.distributed.run --nproc_per_node=N -m wav2vec2forbrain_tpu_torch.run \
        --experiment_type=... --mesh_data_parallel=0 [--optimizer_state_sharding=zero1] [flags...]

Takes the JAX CLI's flags, reads ./config.yaml (the first run writes a
template and exits 0) and runs the experiment on the CUDA card; it raises
where there is no card. `main(argv, device="cpu")` runs it on the CPU, and
under torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) as one rank of a gloo group.

WAV2VEC2FORBRAIN_TPU_TRACE_DIR=<dir> (the JAX package's trace variable)
records the port's host spans over the run and writes them to
<dir>/spans-<pid>.json at its end (README, "Tracing").
"""

import sys
from typing import Optional

from wav2vec2forbrain_tpu_torch.args.argparsing import get_experiment_from_args
from wav2vec2forbrain_tpu_torch.util import profiling


def main(argv: Optional[list] = None, device: str = "cuda"):
    """Build the experiment from argv (sys.argv[1:] by default), run it and
    return it. With WAV2VEC2FORBRAIN_TPU_TRACE_DIR set, the span recorder
    is on for the whole run and writes its spans there
    (util/profiling.py::trace)."""
    with profiling.trace():
        experiment = get_experiment_from_args(sys.argv[1:] if argv is None else argv, device=device)
        experiment.run()
    return experiment


if __name__ == "__main__":
    main()
    from wav2vec2forbrain_tpu_torch.parallel import distributed

    if distributed.initialized():
        import torch.distributed as dist

        dist.destroy_process_group()
