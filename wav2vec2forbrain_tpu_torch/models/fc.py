"""Fully-connected layers (counterpart of wav2vec2forbrain_tpu/models/fc.py).

Kernels are stored (in, out) like the JAX package, so params cross the
bridge unchanged and `x @ kernel` reads the same in both.
"""

import math
from typing import List, Sequence

import torch

from wav2vec2forbrain_tpu_torch.models.activations import ACT2FN


def uniform(generator, shape, bound, device) -> torch.Tensor:
    """U(-bound, bound) f32, drawn on `device` from `generator`."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (2.0 * bound) - bound


class _MatmulF32(torch.autograd.Function):
    """2-D a @ b of compute-dtype CUDA operands with an f32 result.

    torch.mm's out_dtype has no autograd formula, so the backward is written
    out: both products in the operands' dtype with f32 accumulation (g
    rounded to it first, as a bf16 tensor-core GEMM takes it), each result
    rounded to its operand's dtype, as JAX's transpose of a dot_general
    with preferred_element_type=f32 converts it back."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(g, b.t(), out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.mm(a.t(), g, out_dtype=torch.float32).to(b.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b contracted in the operands' dtype with an f32 result (JAX's
    `preferred_element_type=float32`). b is 2-D (in, out).

    A bf16 torch.matmul returns bf16, so a bf16 product is taken with an f32
    output explicitly: on CUDA through torch.mm's out_dtype (bf16 tensor-core
    GEMM, f32 accumulate and f32 store; differentiable through _MatmulF32);
    elsewhere by upcasting the bf16-valued operands to f32, which gives
    exact products and f32 sums."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        out = _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def init_linear(generator, in_size: int, out_size: int, device) -> dict:
    """torch nn.Linear default init: U(-1/sqrt(in), 1/sqrt(in)) for both."""
    bound = 1.0 / math.sqrt(in_size)
    return {
        "kernel": uniform(generator, (in_size, out_size), bound, device),
        "bias": uniform(generator, (out_size,), bound, device),
    }


def apply_linear(params: dict, x: torch.Tensor, compute_dtype=None, out_dtype=None):
    """Contract in compute_dtype, f32 result plus bias, then cast to
    out_dtype (default f32) — the JAX `apply_linear` dtype contract."""
    kernel = params["kernel"]
    cd = compute_dtype or torch.promote_types(x.dtype, kernel.dtype)
    y = matmul_f32(x.to(cd), kernel.to(cd)) + params["bias"]
    return y if out_dtype is None else y.to(out_dtype)


def init_fc(generator, input_size: int, output_size: int, hidden_sizes: Sequence[int], device):
    sizes = [input_size] + list(hidden_sizes) + [output_size]
    layers: List[dict] = [
        init_linear(generator, sizes[i], sizes[i + 1], device) for i in range(len(sizes) - 1)
    ]
    return {"layers": layers}


def apply_fc(params: dict, x: torch.Tensor, activation: str = "gelu", compute_dtype=None):
    act = ACT2FN[activation]
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        x = apply_linear(layer, x, compute_dtype)
        if i < n - 1:
            x = act(x)
    return x
