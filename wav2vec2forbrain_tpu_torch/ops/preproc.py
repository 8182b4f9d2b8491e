"""Fused preprocessing: the CUDA kernels' wrapper and the plain versions
(counterpart of wav2vec2forbrain_tpu/ops/pallas_preproc.py::fused_preproc
and its custom VJP).

smooth (20 taps, 'same') -> x @ W[day] + b[day] -> softsign -> unfold
(k=32, stride 4, channel-major). Backward (the Pallas `_bwd_kernel`), for
g (B, T', 256 * k):
    y = smooth(x), pre = y @ W[day] + b[day]      recomputed, not saved
    dz = d unfold(g) / (1 + |pre|)^2
    dW_b = y^T dz, db_b = sum_t dz                 per sample
    dx = smooth with the reversed taps of (dz @ W[day]^T)
and the per-sample dW/db are summed into the day tables outside the kernel
(`day_sum`, the JAX package's segment_sum, in a fixed order: a run is
bitwise reproducible in them). The kernels are in
csrc/preproc.cu; see its header for the design. The forward is two
launches: the smoothing, the affine on split-TF32 tensor-core products and
the softsign into a scratch z, held in pieces of four rows of one channel;
then the unfold, one stream of 16-byte stores. The backward is
three launches (the d unfold streamed from g; the smoothing, pre, dz and
dy; dW, db and dx) on the same products. Both take their scratch from the
wrapper and at most 32 smoothing taps. On a CPU tensor the wrapper runs the
plain versions; on a CUDA tensor it launches the kernels or raises.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

from wav2vec2forbrain_tpu_torch.models.preprocessing import (
    NEURAL_DIM,
    day_affine_softsign,
    gaussian_smooth,
    preproc_out_lens,
    unfold_time,
)
from wav2vec2forbrain_tpu_torch.ops import kernels

MAX_TAPS = 32  # smoothing taps the kernels take (the models use 20)


def fused_preproc_plain(x, day_weights, day_bias, day_idxs, taps, kernel_len=32, stride=4):
    """Plain PyTorch version of the forward kernel: x (B, T, 256) -> (B, T', 256*k) f32."""
    params = {"day_weights": day_weights, "day_bias": day_bias}
    y = day_affine_softsign(gaussian_smooth(x.float(), taps), params, day_idxs.long())
    return unfold_time(y, kernel_len, stride)


def fused_preproc_bwd_plain(x, day_weights, day_bias, day_idxs, taps, g, kernel_len=32, stride=4):
    """Plain version of the backward kernel: (dx (B, T, 256), per-sample dW
    (B, 256, 256), per-sample db (B, 1, 256)), all f32."""
    b, t, c = x.shape
    t_out = (t - kernel_len) // stride + 1
    days = day_idxs.long()
    y = gaussian_smooth(x.float(), taps)
    w = day_weights[days]
    pre = torch.bmm(y, w) + day_bias[days]
    g4 = g.float().reshape(b, t_out, c, kernel_len)
    dz = torch.zeros((b, t, c), dtype=torch.float32, device=x.device)
    for j in range(kernel_len):
        dz[:, j : j + (t_out - 1) * stride + 1 : stride] += g4[..., j]
    denom = 1.0 + torch.abs(pre)
    dz = dz / (denom * denom)
    db = torch.sum(dz, dim=1, keepdim=True)
    dw = torch.bmm(y.transpose(1, 2), dz)
    dy = torch.bmm(dz, w.transpose(1, 2))
    # the smoothing's adjoint: correlation with the reversed taps, padding swapped
    k = taps.shape[0]
    yp = F.pad(dy, (0, 0, k // 2, (k - 1) // 2))
    dx = torch.zeros_like(dy)
    for i in range(k):
        dx = dx + taps[k - 1 - i] * yp[:, i : i + t]
    return dx, dw, db


def _check(x, day_weights, day_bias, day_idxs, taps, kernel_len, stride):
    b, t, c = x.shape
    n_days = day_weights.shape[0]
    if c != NEURAL_DIM or x.dtype != torch.float32:
        raise ValueError(f"fused_preproc: x must be (B, T, {NEURAL_DIM}) float32, got {tuple(x.shape)} {x.dtype}")
    if day_weights.shape != (n_days, c, c) or day_bias.shape != (n_days, 1, c):
        raise ValueError("fused_preproc: day_weights (D, 256, 256) and day_bias (D, 1, 256) expected")
    if day_weights.dtype != torch.float32 or day_bias.dtype != torch.float32 or taps.dtype != torch.float32:
        raise ValueError("fused_preproc: day tables and taps must be float32")
    if day_idxs.shape != (b,) or taps.dim() != 1:
        raise ValueError("fused_preproc: day_idxs (B,) and taps (n,) expected")
    if not 1 <= taps.shape[0] <= MAX_TAPS:
        raise ValueError(f"fused_preproc: {taps.shape[0]} smoothing taps (the kernels take 1 .. {MAX_TAPS})")
    t_out = (t - kernel_len) // stride + 1
    if t_out <= 0:
        raise ValueError(f"fused_preproc: T={t} is shorter than the unfold window {kernel_len}")
    return b, t, c, n_days, t_out


def _fwd_kernel(x, day_weights, day_bias, day_idxs, taps, kernel_len, stride):
    b, t, c, n_days, t_out = _check(x, day_weights, day_bias, day_idxs, taps, kernel_len, stride)
    day32 = day_idxs.to(torch.int32).contiguous()
    x = x.contiguous()
    kernels.require_cuda("fused_preproc", x, day_weights, day_bias, day32, taps)
    day_weights = _aligned(day_weights)
    # scratch: z in pieces of four rows of one channel, (B, ceil(T / 4), 256, 4)
    z = torch.empty((b, 4 * ((t + 3) // 4), c), dtype=torch.float32, device=x.device)
    out = torch.empty((b, t_out, c * kernel_len), dtype=torch.float32, device=x.device)
    lib = kernels.lib()
    with torch.cuda.device(x.device):
        code = lib.w2vb_preproc_fwd(
            x.data_ptr(), day_weights.data_ptr(), day_bias.data_ptr(), day32.data_ptr(),
            taps.data_ptr(), z.data_ptr(), out.data_ptr(),
            b, t, c, taps.shape[0], n_days, kernel_len, stride, t_out, kernels.stream_of(x),
        )
    kernels.check("preproc", code)
    kernels.LAUNCHES["preproc"] += 1
    return out


def _aligned(t):
    """t, or a copy of it where its data does not start on a 16-byte boundary
    (the kernels stage W, and the backward g, with 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bwd_kernel(x, day_weights, day_bias, day_idxs, taps, g, kernel_len, stride):
    b, t, c, n_days, t_out = _check(x, day_weights, day_bias, day_idxs, taps, kernel_len, stride)
    if g.shape != (b, t_out, c * kernel_len):
        raise ValueError(f"fused_preproc backward: g {tuple(g.shape)} != {(b, t_out, c * kernel_len)}")
    day32 = day_idxs.to(torch.int32).contiguous()
    x, g = x.contiguous(), g.float().contiguous()
    kernels.require_cuda("fused_preproc backward", x, day_weights, day_bias, day32, taps, g)
    day_weights, g = _aligned(day_weights), _aligned(g)
    ys = torch.empty((b, t, c), dtype=torch.float32, device=x.device)  # scratch: y = smooth(x)
    dz = torch.empty_like(ys)  # scratch
    dy = torch.empty_like(ys)  # scratch
    dx = torch.empty_like(ys)
    dw = torch.empty((b, c, c), dtype=torch.float32, device=x.device)
    db = torch.empty((b, 1, c), dtype=torch.float32, device=x.device)
    lib = kernels.lib()
    with torch.cuda.device(x.device):
        code = lib.w2vb_preproc_bwd(
            x.data_ptr(), day_weights.data_ptr(), day_bias.data_ptr(), day32.data_ptr(),
            taps.data_ptr(), g.data_ptr(), ys.data_ptr(), dz.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
            b, t, c, taps.shape[0], n_days, kernel_len, stride, t_out, kernels.stream_of(x),
        )
    kernels.check("preproc_bwd", code)
    kernels.LAUNCHES["preproc_bwd"] += 1
    return dx, dw, db


class _FusedPreproc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, day_weights, day_bias, day_idxs, taps, kernel_len, stride):
        ctx.save_for_backward(x, day_weights, day_bias, day_idxs, taps)
        ctx.args = (kernel_len, stride)
        fn = _fwd_kernel if x.is_cuda else fused_preproc_plain
        return fn(x, day_weights, day_bias, day_idxs, taps, kernel_len, stride)

    @staticmethod
    def backward(ctx, g):
        x, day_weights, day_bias, day_idxs, taps = ctx.saved_tensors
        fn = _bwd_kernel if x.is_cuda else fused_preproc_bwd_plain
        dx, dw_b, db_b = fn(x, day_weights, day_bias, day_idxs, taps, g, *ctx.args)
        n_days = day_weights.shape[0]
        return dx, day_sum(dw_b, day_idxs, n_days), day_sum(db_b, day_idxs, n_days), None, None, None, None


def day_sum(parts: torch.Tensor, day_idxs: torch.Tensor, n_days: int) -> torch.Tensor:
    """Per-day sums (n_days, ...) of per-sample parts (B, ...) f32: one f32
    product with the (n_days, B) one-hot of the days, whose sums run in a
    fixed order (index_add_ adds with float atomics on the card, in the
    order they land)."""
    days = torch.arange(n_days, device=parts.device)
    onehot = (days[:, None] == day_idxs.to(parts.device).long()[None, :]).to(parts.dtype)
    return (onehot @ parts.reshape(parts.shape[0], -1)).reshape(n_days, *parts.shape[1:])


def fused_preproc(
    x: torch.Tensor,
    day_weights: torch.Tensor,
    day_bias: torch.Tensor,
    day_idxs: torch.Tensor,
    taps: torch.Tensor,
    kernel_len: int = 32,
    stride: int = 4,
) -> torch.Tensor:
    """x (B, T, 256) f32; day_weights (D, 256, 256) f32; day_bias (D, 1, 256)
    f32; day_idxs (B,) int; taps (n,) f32 -> features (B, T', 256*kernel_len)
    f32 with T' = (T - kernel_len) // stride + 1. Differentiable in x and
    the day tables."""
    return _FusedPreproc.apply(x.float(), day_weights, day_bias, day_idxs, taps, kernel_len, stride)


def apply_preproc_fused(
    params: dict,
    x: torch.Tensor,
    day_idxs: torch.Tensor,
    input_lens: torch.Tensor,
    taps: torch.Tensor,
    kernel_len: int = 32,
    stride: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for models.preprocessing.apply_preproc through the kernels."""
    feats = fused_preproc(
        x, params["day_weights"], params["day_bias"], day_idxs, taps, kernel_len, stride
    )
    return feats, preproc_out_lens(input_lens, kernel_len, stride)
