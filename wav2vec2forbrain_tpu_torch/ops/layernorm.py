"""Row LayerNorm: the CUDA kernels' wrapper and the plain versions
(counterpart of wav2vec2forbrain_tpu/ops/pallas_layernorm.py::
layer_norm_fused and its custom VJP).

Forward, per row of x (B, T, C) in the activation-stream dtype, in f32:
    mu = mean(x); xc = x - mu; var = mean(xc^2); rstd = rsqrt(var + eps)
    y = (xc * rstd) * scale + bias      emitted in x's dtype
Backward (the Pallas `_bwd_kernel`), stats recomputed from x, for dy cast
to x's dtype first (the JAX `_vjp_bwd` does `dy.astype(x.dtype)`):
    xhat = xc * rstd; w = dy * scale
    dx = rstd * (w - mean(w) - xhat * mean(w * xhat))   in x's dtype
    dscale = sum_b sum_t dy * xhat;  dbias = sum_b sum_t dy
The backward kernel is one launch over (batch element, T chunk) tiles and
emits (B, chunks, C) f32 partials; `_bwd_kernel` sums them over the chunks
into per-batch-element partials (B, C), and the autograd backward sums
those over B and casts to the params' dtype, as in the JAX VJP. Each sum
runs in a fixed order: the result is deterministic. The kernels are in
csrc/layernorm.cu and take C <= 1024.
"""

import functools

import torch

from wav2vec2forbrain_tpu_torch.ops import kernels

_MAX_C = 1024


def _stats(x32: torch.Tensor, eps: float):
    mu = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc, torch.rsqrt(var + eps)


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version of the forward kernel (any leading dims; differentiable
    by autograd): f32 math, result in x's dtype."""
    xc, rstd = _stats(x.float(), eps)
    return ((xc * rstd) * scale + bias).to(x.dtype)


def layer_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float):
    """Plain version of the backward kernel for x, dy (B, T, C) in the
    stream dtype: (dx in x's dtype, dscale partials (B, C) f32, dbias
    partials (B, C) f32)."""
    dy32 = dy.float()
    xc, rstd = _stats(x.float(), eps)
    xhat = xc * rstd
    w = dy32 * scale.float()
    m1 = w.mean(dim=-1, keepdim=True)
    m2 = (w * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (w - m1 - xhat * m2)).to(x.dtype)
    return dx, (dy32 * xhat).sum(dim=1), dy32.sum(dim=1)


def _check(name, x, scale):
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be (B, T, C) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    if x.shape[-1] > _MAX_C or scale.numel() != x.shape[-1]:
        raise ValueError(f"{name}: C = {x.shape[-1]} must be <= {_MAX_C} and match scale {tuple(scale.shape)}")


def _fwd_kernel(x, scale, bias, eps):
    _check("layer_norm_fused", x, scale)
    x = x.contiguous()
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    kernels.require_cuda("layer_norm_fused", x, scale, bias)
    y = torch.empty_like(x)
    b, t, c = x.shape
    lib = kernels.lib()
    with torch.cuda.device(x.device):
        code = lib.w2vb_layernorm_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            int(x.dtype == torch.bfloat16), b * t, c, float(eps), kernels.stream_of(x),
        )
    kernels.check("layernorm", code)
    kernels.LAUNCHES["layernorm"] += 1
    return y


@functools.lru_cache(maxsize=None)
def _bwd_chunks(io_bf16: int, b: int, t: int, c: int, device_index: int) -> int:
    """T chunks per batch element that fill the card's SMs once with the
    backward kernel's blocks (asked of csrc/layernorm.cu once per shape)."""
    with torch.cuda.device(device_index):
        n = kernels.lib().w2vb_layernorm_bwd_chunks(io_bf16, b, t, c)
    kernels.check("layernorm_bwd", -n if n < 0 else 0)  # a count >= 1, or a CUDA error code negated
    return n


def _bwd_kernel(x, scale, dy, eps):
    _check("layer_norm_fused backward", x, scale)
    x, dy = x.contiguous(), dy.to(x.dtype).contiguous()
    scale = scale.float().contiguous()
    kernels.require_cuda("layer_norm_fused backward", x, scale, dy)
    b, t, c = x.shape
    dx = torch.empty_like(x)
    if b * t == 0:
        return dx, *torch.zeros((2, b, c), dtype=torch.float32, device=x.device)
    io_bf16 = int(x.dtype == torch.bfloat16)
    chunks = _bwd_chunks(io_bf16, b, t, c, x.device.index)
    parts = torch.empty((2, b, chunks, c), dtype=torch.float32, device=x.device)  # dscale, dbias partials
    lib = kernels.lib()
    with torch.cuda.device(x.device):
        code = lib.w2vb_layernorm_bwd(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), parts[0].data_ptr(),
            parts[1].data_ptr(), io_bf16, b, t, c, chunks, float(eps), kernels.stream_of(x),
        )
    kernels.check("layernorm_bwd", code)
    kernels.LAUNCHES["layernorm_bwd"] += 1
    dg, db = parts.sum(dim=2)
    return dx, dg, db


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        if x.is_cuda:
            return _fwd_kernel(x, scale, bias, eps)
        return layer_norm_plain(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        dy = dy.to(x.dtype)  # the JAX VJP rounds dy to the stream dtype first
        fn = _bwd_kernel if x.is_cuda else layer_norm_bwd_plain
        dx, dg, db = fn(x, scale, dy, ctx.eps)
        return dx, dg.sum(dim=0).to(scale.dtype), db.sum(dim=0).to(bias.dtype), None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Same contract as layer_norm_plain for x (B, T, C); differentiable in
    x, scale and bias. On CUDA tensors the kernels run (or raise); on CPU
    tensors their plain versions."""
    return _LayerNorm.apply(x, scale, bias, float(eps))
