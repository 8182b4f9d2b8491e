"""Activation checkpointing of the encoder layers under --remat_policy
(counterpart of wav2vec2forbrain_tpu/models/wav2vec2.py::remat_layer_fn and
the tensors its policies name, "blk" and "ffn_wide").

A train-mode layer runs as `layer(stream, *args)` through `checkpoint_layer`.
Under a policy other than "none" (and only with autograd recording: eval
mode and torch.no_grad never checkpoint) its activations are dropped after
the forward and recomputed in the backward by
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)` (the
reentrant form would drop the gradients of the params the layer reaches
through its param dicts). What the forward keeps besides the region's
inputs is chosen by a selective-checkpoint policy on the products it runs:

- "min": the outputs of `mm` / `addmm`, the products without batch dims
  (JAX's dots_with_no_batch_dims_saveable: the linears);
- "dots": also `bmm` / `baddbmm` (JAX's dots_saveable; only the plain
  attention runs them);
- "dots_nowide": "dots" minus the FFN's up projections, the products run
  under `named("ffn_wide")` (JAX bans the products whose output is as wide
  as intermediate_size: the same products at every config the repo runs,
  and under tensor parallelism the same whatever a rank's share of the
  columns);
- "blocks": the products run under `named("blk")`: q, k, v, the attention's
  out projection, the FFN's down projection and the conv module's second
  pointwise conv, whose outputs are the tensors JAX names "blk"; the glue
  between them is recomputed, and so is the attention core (JAX names its
  context "blk" too, but on the card the kernel writes it into a buffer
  the dispatch-level policy cannot hold);
- "all_but_wide": the layer itself is not checkpointed; its (B, T, wide)
  sections are (`wide`): each FFN from its up projection to its down
  projection's product (the product kept), and the conformer's conv module
  from its first pointwise conv to the activation after BatchNorm. Those
  are the tensors JAX names "ffn_wide"; everything else is kept as without
  remat.

The hand-written kernels launch through ctypes into buffers from
`torch.empty*`, which a dispatch-level policy sees as allocations only: the
policies keep products and nothing else, so no allocation that a kernel
fills is ever held, and a recompute launches the layer's kernels again
(attention, conv_glu, LayerNorm: each forward kernel of a checkpointed layer
twice a step; under "all_but_wide" conv_glu's).

That is also why "all_but_wide" is a second mechanism (`wide`, and the
layer code's split of its wide sections) rather than one more policy
function, and why "blocks" recomputes the attention context: a policy that
kept "everything but", or a kernel's output, would have to hold the
`torch.empty` buffers the kernels fill. One policy function over named ops
would need each kernel wrapper registered with `torch.library.custom_op`:
a schema, a fake (shape-only) implementation and the autograd formula for
each of the eleven forward and backward wrappers, on both the card's path
and the CPU's. Checkpointing the wide sections as regions of their own
gives JAX's saved set with none of that.

Dropout seeds: a region's dropout sites draw their seeds from the forward's
stream before the region runs and replay them in both of its runs (a
`SeedStream(seeds=...)` at the stream's row0 and group), so the recompute
draws the same hash masks and the stream advances exactly as without remat.
BatchNorm's new running stats come from the first run; the recompute's are
discarded, and its data-parallel sums run again on every rank in the same
order (every rank checkpoints the same layers: LayerDrop's decisions are
shared).

`SavedBytes` counts what a forward keeps for its backward: the tensors
saved outside checkpointed regions (saved_tensors_hooks; each storage once,
parameters left out), the regions' input activations and the products the
policies keep.
"""

import contextlib
import contextvars
from typing import Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from wav2vec2forbrain_tpu_torch.models.seeds import SeedStream

POLICIES = ("none", "min", "dots", "dots_nowide", "blocks", "all_but_wide")
# --remat_policy=auto's candidates, fastest first (train/steps.py::RematAuto)
AUTO_CANDIDATES = ("none", "blocks", "dots_nowide", "min")

_aten = torch.ops.aten
_UNBATCHED = (_aten.mm, _aten.addmm)
_BATCHED = (_aten.bmm, _aten.baddbmm)

# the context a layer's code runs in: the name of the tensors being computed (`named`), whether the layer runs
# under "all_but_wide", and the SavedBytes counting this forward (`counting`), if any
_NAME = contextvars.ContextVar("remat_name", default=None)
_IN_WIDE_LAYER = contextvars.ContextVar("remat_in_wide_layer", default=False)
_COUNTER = contextvars.ContextVar("remat_counter", default=None)


@contextlib.contextmanager
def _set(var, value):
    token = var.set(value)
    try:
        yield value
    finally:
        var.reset(token)


def named(name: str):
    """Name the tensors computed inside (JAX's checkpoint_name): "blk" for
    the block boundaries "blocks" keeps, "ffn_wide" for the FFN's up
    projection that "dots_nowide" drops."""
    return _set(_NAME, name)


def _product_bytes(func, args, kwargs) -> int:
    """Bytes of a product's output, from its operands (and mm's out_dtype)."""
    a, b = args[1:3] if func in (_aten.addmm, _aten.baddbmm) else args[:2]
    dtype = kwargs.get("out_dtype", args[2] if func is _aten.mm and len(args) > 2 else a.dtype)
    return a.shape[:-1].numel() * b.shape[-1] * dtype.itemsize


def keeps(policy: str, func) -> bool:
    """Does `policy` keep the output of the aten op packet `func`, run now
    (under the current `named` name)?"""
    if func in _UNBATCHED:
        product = True
    elif func in _BATCHED:
        product = policy != "min"
    else:
        return False
    if policy == "blocks":
        return _NAME.get() == "blk"
    if policy == "dots_nowide":
        return product and _NAME.get() != "ffn_wide"
    return product


def _policy_fn(policy: str):
    def fn(ctx, op, *args, **kwargs):
        func = op.overloadpacket
        if not keeps(policy, func):
            return CheckpointPolicy.PREFER_RECOMPUTE
        counter = _COUNTER.get()
        if counter is not None and not ctx.is_recompute:
            counter.kept += _product_bytes(func, args, kwargs)
        return CheckpointPolicy.MUST_SAVE

    return fn


def _region(fn, policy: str, stream: Optional[SeedStream], n_sites: int, *args):
    """fn(stream, *args) as one checkpointed region keeping what `policy`
    keeps, its n_sites dropout seeds drawn now and replayed in both runs."""
    seeds = [stream.seed() for _ in range(n_sites)]
    if _COUNTER.get() is not None:
        _COUNTER.get().add_inputs(args)

    def run(*a):
        replay = SeedStream(seeds=seeds)
        if stream is not None:
            replay.row0, replay.group = stream.row0, stream.group
        out = fn(replay, *a)
        if replay.n_seeds != len(seeds):
            raise RuntimeError(f"a checkpointed region drew {replay.n_seeds} dropout seeds, not {len(seeds)}")
        return out

    # the layers draw nothing from torch's global generators (their masks are hashed from the seeds)
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(_policy_fn(policy)))


def checkpoint_layer(fn, policy: str, stream: Optional[SeedStream], n_sites: int, *args):
    """One encoder layer, fn(stream, *args), under `policy`: as it is for
    "none" or without autograd recording; else checkpointed (the module's
    header). n_sites: the dropout seeds the layer draws
    (models/seeds.py::sites_per_layer)."""
    if policy not in POLICIES:
        raise ValueError(f"remat policy {policy!r}: expected one of {POLICIES} ('auto' resolves before the model runs)")
    if policy == "none" or not torch.is_grad_enabled():
        return fn(stream, *args)
    if policy == "all_but_wide":
        with _set(_IN_WIDE_LAYER, True):
            return fn(stream, *args)
    return _region(fn, policy, stream, n_sites, *args)


def wide(fn, stream: Optional[SeedStream], n_sites: int, *args):
    """A layer's (B, T, wide) section, fn(stream, *args): checkpointed while
    its layer runs under "all_but_wide" (keeping the products "dots_nowide"
    keeps), else run as it is. n_sites: the dropout seeds it draws."""
    if not (_IN_WIDE_LAYER.get() and torch.is_grad_enabled()):
        return fn(stream, *args)
    return _region(fn, "dots_nowide", stream, n_sites, *args)


def _is_param(t: torch.Tensor) -> bool:
    return t.is_leaf and t.requires_grad


class SavedBytes:
    """What a forward run inside `counting()` keeps for its backward, in
    bytes: `saved` (saved tensors outside checkpointed regions, each storage
    once, parameters left out), `inputs` (the regions' input activations)
    and `kept` (the products the policies keep); `total` their sum."""

    def __init__(self):
        self.saved = self.inputs = self.kept = 0
        self._seen = set()

    def _add(self, t: torch.Tensor) -> int:
        storage = t.untyped_storage()
        key = (storage.data_ptr(), t.device)
        if _is_param(t) or key in self._seen:
            return 0
        self._seen.add(key)
        return storage.nbytes()

    def add_inputs(self, args) -> None:
        self.inputs += sum(self._add(a) for a in args if isinstance(a, torch.Tensor))

    def pack(self, t: torch.Tensor) -> torch.Tensor:
        self.saved += self._add(t)
        return t

    @property
    def total(self) -> int:
        return self.saved + self.inputs + self.kept


@contextlib.contextmanager
def counting():
    """Count what the forward run inside keeps for its backward (SavedBytes)."""
    with _set(_COUNTER, SavedBytes()) as counter:
        with torch.autograd.graph.saved_tensors_hooks(counter.pack, lambda t: t):
            yield counter
