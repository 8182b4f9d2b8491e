"""Process-group set-up and the collectives of data-parallel training
(counterpart of wav2vec2forbrain_tpu/parallel/distributed.py).

The JAX package joins its processes through jax.distributed and lets XLA
place the collectives of a sharded step. The port runs one process a rank
under torchrun (`python -m torch.distributed.run --nproc_per_node=N -m
wav2vec2forbrain_tpu_torch.run ...`) and calls the collectives itself, all
of them here: NCCL on the card (each rank on cuda:$LOCAL_RANK), gloo on the
CPU. Only collectives both backends have are used: all_reduce, all_gather,
broadcast and barrier (gloo has no reduce_scatter).

- `maybe_initialize_distributed`: joins torchrun's group, a no-op without
  its environment;
- `is_coordinator`, `barrier`, `shared_uuid`, `broadcast_object`: the rank
  that writes files, and the points where the others wait for it or take
  its values (a results dir's timestamp, the best model's path);
- `all_reduce_tensors` / `broadcast_tensors`: many tensors in flat buckets
  (gradients, the initial params);
- `gather_rows`: each rank's rows of a batch's outputs, in rank order (the
  counterpart of `host_fetchable`);
- `sum_across` / `loss_across`: differentiable sums over the ranks, for
  BatchNorm's batch statistics and for the loss;
- `enter_split` / `sum_partials`: the two ends of a tensor-parallel block
  (parallel/tensor.py): identity forward with summed gradients, and summed
  partial products with an identity backward;
- `all_gather_pieces`: split leaves made whole again (ZeRO-1's moments and
  params, tensor parallelism's trees).
"""

import os
import uuid
from typing import List, Optional

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
BUCKET_BYTES = 64 << 20  # flat buffer size of the bucketed collectives


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def maybe_initialize_distributed(device) -> torch.device:
    """Join torchrun's process group when its environment is set (NCCL for a
    CUDA device, gloo for the CPU: never one for the other) and return the
    device this rank computes on: cuda:$LOCAL_RANK for a CUDA device, else
    `device`. Without torchrun's environment, or with a group already
    initialized by the caller, nothing is joined."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if initialized() or not all(k in os.environ for k in TORCHRUN_ENV):
        return device
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return device


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_coordinator() -> bool:
    """True on the rank that writes files (checkpoints, logs, results);
    the results and cache dirs must be readable by every rank."""
    return rank() == 0


def barrier(name: str) -> None:
    """Wait until every rank got here (a no-op in one process); `name` says
    where, for a reader of a hung run's stack."""
    del name
    if world_size() > 1:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's value of a picklable object, on every rank."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def any_across(flags: List[bool], device) -> List[bool]:
    """Each flag OR-ed over every rank (a no-op in one process); the flags
    travel in a tensor on `device`, which the backend must take (NCCL:
    the card)."""
    if world_size() == 1:
        return list(flags)
    t = torch.tensor([float(f) for f in flags], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [bool(v) for v in t.tolist()]


def shared_uuid() -> str:
    """A uuid4 string, rank 0's on every rank: paths that rank 0 writes
    and every rank reads back (the best-model checkpoint)."""
    return broadcast_object(str(uuid.uuid4()))


def buckets(tensors: List[torch.Tensor]):
    """Index lists of consecutive tensors of one dtype and device, each
    list at most BUCKET_BYTES (or one larger tensor)."""
    bucket, size, key = [], 0, None
    for i, t in enumerate(tensors):
        nb = t.numel() * t.element_size()
        k = (t.dtype, t.device)
        if bucket and (k != key or size + nb > BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(i)
        size += nb
        key = k
    if bucket:
        yield bucket


def _bucketed(tensors: List[torch.Tensor], collective) -> None:
    for idx in buckets(tensors):
        bucket = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(piece.view_as(t))


def all_reduce_tensors(tensors: List[torch.Tensor], group=None) -> None:
    """Sum each tensor over the ranks, in place, in flat buckets. Every rank
    must pass tensors of the same shapes in the same order."""
    _bucketed(tensors, lambda flat: dist.all_reduce(flat, group=group))


def broadcast_tensors(tensors: List[torch.Tensor], src: int = 0, group=None) -> None:
    """Rank src's values of each tensor, in place on every rank."""
    _bucketed(tensors, lambda flat: dist.broadcast(flat, src=src, group=group))


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's x (the same shape on each) stacked along dim 0 in rank
    order: a batch's outputs at the global rows."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_across(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks, differentiable: its gradient is summed
    over the ranks too. For a statistic (BatchNorm's batch sums) whose
    users on every rank contribute to the gradient of each rank's part."""
    return _SumAcross.apply(x, group)


class _LossAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def loss_across(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks, for a loss that every rank then computes
    the same function of: the gradient of the local part is that of the
    sum (d L / d x_r = d L / d sum), so the backward passes it through
    unchanged, and the SUM all-reduce of the params' gradients adds the
    ranks' parts once."""
    return _LossAcross.apply(x, group)


class _EnterSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def enter_split(x: torch.Tensor, group) -> torch.Tensor:
    """x unchanged, on its way into work that the ranks of `group` split
    between them (tensor parallelism's column-split linears): the backward
    sums the ranks' gradients, each of which covers its own part of that
    work only."""
    return _EnterSplit.apply(x, group)


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial results (tensor parallelism's
    row-split products), which every rank then uses alike: forward an
    all-reduce, backward the identity, as `loss_across`."""
    return _LossAcross.apply(x.contiguous(), group)


def all_gather_pieces(jobs, group) -> None:
    """For each (whole, piece, dim): every rank's piece of `whole` (the same
    shape on each rank) written into its place along dim, rank r's at r *
    piece.shape[dim], in flat buckets of one dtype (a collective: every
    rank of `group` calls it with the same jobs)."""
    for idx in buckets([piece for _, piece, _ in jobs]):
        bucket = [jobs[i] for i in idx]
        flat = torch.cat([piece.reshape(-1) for _, piece, _ in bucket])
        parts = gather_rows(flat, group).split(flat.numel())
        sizes = [piece.numel() for _, piece, _ in bucket]
        for r, part in enumerate(parts):
            for (whole, piece, d), got in zip(bucket, part.split(sizes)):
                n = piece.shape[d]
                whole.narrow(d, r * n, n).copy_(got.view(piece.shape))


def group_size(group: Optional[object]) -> int:
    return 1 if group is None else dist.get_world_size(group)
