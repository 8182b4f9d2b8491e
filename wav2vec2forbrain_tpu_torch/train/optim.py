"""Optimizer and per-epoch LR schedules with torch-Adam semantics
(counterpart of wav2vec2forbrain_tpu/train/optim.py).

- Adam, not AdamW: weight decay is added to the gradient before the moment
  update (`g + wd * p`), as torch.optim.Adam and the JAX package do.
- The update has optax's bias-corrected form (m / bc1) / (sqrt(v / bc2) +
  eps), computed in f32, so the port can be held tightly to the JAX
  package.
- Labels "brain", "w2v" and "frozen" (models/assembly.py::param_labels):
  the two trained groups take their own LR, set by the host each step or
  epoch; frozen leaves keep no state and never move.
- mu_dtype / nu_dtype (--adam_mu_dtype / --adam_nu_dtype) set how the
  moments are STORED; they are computed in f32 every step. With only
  mu_dtype set the arithmetic follows stock optax.scale_by_adam (the decay
  term b1 * mu is taken in the storage dtype); with nu_dtype set, the JAX
  package's scale_by_adam_nu_dtype (everything in f32).
- SGD (--optimizer=sgd) as torch.optim.SGD at momentum 0 and the JAX
  package: the weight decay is added to the gradient, p -= lr * (g + wd * p);
  it keeps no moments (its state's mu / nu are None).
- clip_by_global_norm: torch clip_grad_norm_ over the whole tree.
- ZeRO-1 (--optimizer_state_sharding=zero1, parallel/zero.py): with a
  `Zero1`, init keeps this rank's piece of each split moment leaf, and
  step updates this rank's piece of each split param (the whole of the
  others) and then all-gathers the pieces.
- Tensor parallelism (parallel/tensor.py): the params, gradients and
  moments are this rank's model-axis pieces, each updated element by
  element as the whole; `global_norm` with the rank's TensorShard sums the
  split leaves' squares over the model group and counts each whole leaf
  once, so clipping and the logged norm are the whole tree's.

Adam updates the params and moments in place. Its CUDA leaves go to one
multi-tensor kernel (ops/adam.py, csrc/adam.cu: a table of the leaves,
one launch a step) while the "adam" kernel is enabled (ops/select.py); a
CUDA leaf the kernel does not take raises. CPU leaves, and every leaf under
`--pallas_kernels=none`, take the loop over the leaves in PyTorch ops: the
plain version, whose arithmetic the kernel computes bit for bit. The loop
divides by the bias corrections as PyTorch divides a CUDA tensor by a
scalar, by a multiply with the f32 reciprocal, so the CPU computes the
same bits. The JAX package runs the update as XLA. SGD is the loop on
every device.
"""

from typing import Callable, NamedTuple, Optional

import torch

from wav2vec2forbrain_tpu_torch.ops import adam
from wav2vec2forbrain_tpu_torch.ops.select import kernel_enabled
from wav2vec2forbrain_tpu_torch.parallel.tensor import TensorShard, split_dims
from wav2vec2forbrain_tpu_torch.tree import tree_leaves, tree_map


class LRSchedules(NamedTuple):
    """Host-side per-epoch LR functions: epoch -> absolute lr."""

    brain: Callable[[int], float]
    w2v: Callable[[int], float]


def step_lr(base_lr: float, step_size: int, gamma: float) -> Callable[[int], float]:
    """torch StepLR: lr = base * gamma ** (epoch // step_size)."""

    def lr(epoch: int) -> float:
        return base_lr * (gamma ** (epoch // step_size))

    return lr


def two_module_warmup_schedules(
    module1_baselr: float,
    module2_warmup_start_step: int,
    module2_warmup_steps: int,
    module2_target_lr: float,
    adjust_module1_lr_to_module2_postwarmup_lr: bool,
) -> LRSchedules:
    """The reference's get_2module_warmup_scheduler lambdas as absolute-lr
    functions (brain = module 1, w2v = module 2)."""

    def module2_lr(step: int) -> float:
        if step < module2_warmup_start_step:
            return 0.0
        factor = (step - module2_warmup_start_step) / module2_warmup_steps if module2_warmup_steps > 0 else 1.0
        return module2_target_lr * min(1.0, factor)

    def module1_lr(step: int) -> float:
        if not adjust_module1_lr_to_module2_postwarmup_lr or not module2_target_lr:
            return module1_baselr
        if step < module2_warmup_start_step:
            return module1_baselr
        target_factor = module2_target_lr / module1_baselr
        if step >= module2_warmup_start_step + module2_warmup_steps:
            return module1_baselr * target_factor
        return module1_baselr * (
            1.0 + (target_factor - 1.0) * (step - module2_warmup_start_step) / module2_warmup_steps
        )

    return LRSchedules(brain=module1_lr, w2v=module2_lr)


def global_norm(grads, tp: Optional[TensorShard] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (f32 0-d tensor). With tp,
    grads holds this rank's pieces of the model-split leaves: their squares
    are summed over the model group, the whole leaves' added once."""
    leaves = tree_leaves(grads)
    if not leaves:
        return torch.zeros(())
    if tp is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    pairs = []
    tree_map(lambda g, d: None if g is None else pairs.append((g, d)), grads, split_dims(grads))
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    split_sq = sum((torch.sum(torch.square(g.float())) for g, d in pairs if d is not None), zero)
    torch.distributed.all_reduce(split_sq, group=tp.group)
    return torch.sqrt(split_sq + sum((torch.sum(torch.square(g.float())) for g, d in pairs if d is None), zero))


def clip_by_global_norm(grads, max_norm: float, norm: Optional[torch.Tensor] = None,
                        tp: Optional[TensorShard] = None):
    """torch clip_grad_norm_ over the whole tree: coef = max_norm / (norm +
    1e-6), clamped to 1. Returns (clipped grads, norm); tp as global_norm's."""
    if norm is None:
        norm = global_norm(grads, tp)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: None if g is None else g * scale, grads), norm


# --- Adam ------------------------------------------------------------------------------


class AdamState(NamedTuple):
    """count: steps taken; mu / nu: trees shaped like the params, None at
    frozen leaves, in their storage dtypes."""

    count: int
    mu: dict
    nu: dict


B1, B2 = 0.9, 0.999  # torch.optim.Adam's default betas, as the JAX package uses


class Optimizer:
    """make_optimizer's result: init(params) -> state; step(params, grads,
    state, brain_lr, w2v_lr) -> new state, with params updated in place."""

    def __init__(self, labels, weight_decay=0.0, eps=1e-8, mu_dtype=None, nu_dtype=None, kind="adam", zero=None):
        self.kind = kind
        self.zero = zero  # parallel/zero.py::Zero1, or None (moments whole on every rank)
        self.labels = labels
        self.weight_decay = weight_decay
        self.eps = eps
        self.mu_dtype = mu_dtype
        self.nu_dtype = nu_dtype

    def init(self, params) -> AdamState:
        if self.kind == "sgd":
            return AdamState(0, None, None)

        dims = self._model_dims(params)

        def zeros(p, label, md, dtype):
            if label == "frozen":
                return None
            if self.zero is not None:
                p = self.zero.local(p, md)
            return torch.zeros_like(p, dtype=dtype or p.dtype)

        mu = tree_map(lambda p, l, md: zeros(p, l, md, self.mu_dtype), params, self.labels, dims)
        nu = tree_map(lambda p, l, md: zeros(p, l, md, self.nu_dtype), params, self.labels, dims)
        return AdamState(0, mu, nu)

    @torch.no_grad()
    def step(self, params, grads, state: AdamState, brain_lr: float, w2v_lr: float) -> AdamState:
        """grads: tree like params; None at a leaf means a zero gradient
        (a parameter the forward did not reach, such as a layer that
        LayerDrop skipped)."""
        count = state.count + 1
        if self.kind == "sgd":
            lr_of = {"brain": float(brain_lr), "w2v": float(w2v_lr)}

            def sgd_leaf(p, g, label):
                if label == "frozen" or (g is None and self.weight_decay == 0.0):
                    return
                g = torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                if self.weight_decay != 0.0:
                    g = g + self.weight_decay * p
                p.add_((g * (-lr_of[label])).to(p.dtype))

            tree_map(sgd_leaf, params, grads, self.labels)
            return AdamState(count, None, None)
        trained = self.trained_leaves(params, grads, state, brain_lr, w2v_lr)
        scalars = self.scalars(count)
        kernel = kernel_enabled("adam")
        on_card = [t for t in trained if kernel and t.p.is_cuda]
        if on_card:
            adam.adam_update(on_card, scalars)
        for p, g, m, v, lr in trained:
            if kernel and p.is_cuda:
                continue
            g = torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
            if self.weight_decay != 0.0:
                g = g + self.weight_decay * p
            m32, v32 = self._moments(g, m, v)
            u = (m32 * scalars.inv_bc1) / (torch.sqrt(v32 * scalars.inv_bc2) + self.eps)
            p.add_((u * (-lr)).to(p.dtype))
            m.copy_(m32)
            v.copy_(v32)
        if self.zero is not None:
            self.zero.gather_params(params, self.labels)
        return AdamState(count, state.mu, state.nu)

    def trained_leaves(self, params, grads, state: AdamState, brain_lr: float, w2v_lr: float):
        """[adam.AdamLeaf] of the trained leaves, in tree order: under
        ZeRO-1 this rank's piece of each param and gradient (the whole leaf
        where it is not split); frozen leaves left out."""
        lr_of = {"brain": float(brain_lr), "w2v": float(w2v_lr)}
        zero = self.zero
        trained = []

        def leaf(p, g, label, m, v, md=None):
            if label == "frozen":
                return
            if zero is not None:
                p = zero.local(p, md)
                g = None if g is None else zero.local(g, md)
            trained.append(adam.AdamLeaf(p, g, m, v, lr_of[label]))

        if zero is None:  # no model-axis dims to walk
            tree_map(leaf, params, grads, self.labels, state.mu, state.nu)
        else:
            tree_map(leaf, params, grads, self.labels, state.mu, state.nu, zero.model_dims(params))
        return trained

    def scalars(self, count: int) -> adam.AdamScalars:
        """Step `count`'s scalars; the reciprocals of the f32 bias
        corrections 1 - b ** count as python floats (exact f32 values, so
        no per-leaf device copies)."""
        return adam.AdamScalars(B1, B2, self.eps, self.weight_decay,
                                _f32_reciprocal(1.0 - torch.tensor(B1) ** float(count)),
                                _f32_reciprocal(1.0 - torch.tensor(B2) ** float(count)), self.nu_dtype is None)

    def _model_dims(self, params):
        """Each leaf's model-axis dim, which ZeRO-1's data-axis split skips."""
        return tree_map(lambda _: None, params) if self.zero is None else self.zero.model_dims(params)

    def _moments(self, g, m, v):
        if self.nu_dtype is None:
            # stock optax: (1 - b) * g^k + b * t, with b * t in t's dtype
            m32 = (1 - B1) * g + (m * float(torch.tensor(B1, dtype=m.dtype))).float()
            v32 = (1 - B2) * (g * g) + (v * float(torch.tensor(B2, dtype=v.dtype))).float()
        else:
            m32 = B1 * m.float() + (1.0 - B1) * g
            v32 = B2 * v.float() + (1.0 - B2) * torch.square(g)
        return m32, v32


def _f32_reciprocal(x: torch.Tensor) -> float:
    """1 / x in f32 (x an f32 0-d tensor), as a python float: the factor
    PyTorch's CUDA division of a tensor by the scalar x multiplies by."""
    return float(torch.ones((), dtype=torch.float32) / x)


def make_optimizer(labels, optimizer: str = "adam", weight_decay: float = 0.0, eps: float = 1e-8,
                   mu_dtype=None, nu_dtype=None, zero=None) -> Optimizer:
    """The two trained groups share one rule ("adam" or "sgd"); frozen
    leaves get no update. zero: a parallel/zero.py::Zero1 (ZeRO-1), or None."""
    if optimizer not in ("adam", "sgd"):
        raise ValueError(f"Optimizer {optimizer} not implemented")
    return Optimizer(labels, weight_decay, eps, mu_dtype, nu_dtype, kind=optimizer, zero=zero)
