"""Fused GLU -> depthwise conv: the CUDA kernels' wrapper and the plain
versions (counterpart of wav2vec2forbrain_tpu/ops/pallas_conv_glu.py::
glu_dwconv and its custom VJP).

y (B, T, 2C) in the stream dtype, taps w (ks, C):
    g = a * sigmoid(gate)              f32, then rounded to the compute dtype
    z = depthwise 'same' conv of g     f32 accumulation over compute-dtype
                                       values, rounded through the compute
                                       dtype, emitted in y's dtype
Backward (the Pallas `_bwd_kernel`), for dz (B, T, C):
    dK[b, k] = sum_t g_pad[t + k] * dz[t]      per-sample partials, f32
    dg[s] = sum_k w_cd[k] * dz[s + left - k]   the flipped taps
    da = dg * sig;  dgate = dg * a * sig * (1 - sig)   f32, emitted in y's dtype
and dw = sum over the batch of the dK partials, outside the kernel as in
the JAX package. The kernels are in csrc/conv_glu.cu: both take any T, in
96-frame chunks staged once a block (32 channels, one sample), and slide
16-value register windows over the taps; every output is summed by one
thread in a fixed order.
"""

import torch
import torch.nn.functional as F

from wav2vec2forbrain_tpu_torch.ops import kernels


def depthwise_conv_same(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'same' depthwise conv over time as shifted multiply-adds, f32
    accumulation. g (B, T, C) and w (ks, C) hold compute-dtype values;
    returns f32 (B, T, C)."""
    ks = w.shape[0]
    t = g.shape[1]
    gp = F.pad(g.float(), (0, 0, (ks - 1) // 2, ks // 2))
    wf = w.float()
    acc = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    for k in range(ks):
        acc = acc + gp[:, k : k + t] * wf[k]
    return acc


def glu_dwconv_plain(y: torch.Tensor, w: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (same contract as glu_dwconv)."""
    a, gate = y.float().chunk(2, dim=-1)
    g = (a * torch.sigmoid(gate)).to(compute_dtype)
    z = depthwise_conv_same(g, w.to(compute_dtype))
    return z.to(compute_dtype).to(y.dtype)


def glu_dwconv_bwd_plain(y: torch.Tensor, w: torch.Tensor, dz: torch.Tensor, compute_dtype=torch.float32):
    """Plain version of the backward kernel: (dy (B, T, 2C) in y's dtype,
    dK partials (B, ks, C) f32)."""
    ks = w.shape[0]
    t = y.shape[1]
    left, right = (ks - 1) // 2, ks // 2
    a, gate = y.float().chunk(2, dim=-1)
    sig = torch.sigmoid(gate)
    g = (a * sig).to(compute_dtype).float()
    dz = dz.float()
    gpad = F.pad(g, (0, 0, left, right))
    dk = torch.stack([torch.sum(gpad[:, k : k + t] * dz, dim=1) for k in range(ks)], dim=1)
    wf = w.to(compute_dtype).float()
    dzpad = F.pad(dz, (0, 0, right, left))
    dg = torch.zeros_like(dz)
    for k in range(ks):
        dg = dg + dzpad[:, k : k + t] * wf[ks - 1 - k]
    da = dg * sig
    dgate = dg * a * sig * (1.0 - sig)
    return torch.cat([da, dgate], dim=-1).to(y.dtype), dk


def _check(name, y, w, compute_dtype):
    c2 = y.shape[-1]
    ks = w.shape[0]
    if c2 % 2 or w.shape != (ks, c2 // 2):
        raise ValueError(f"{name}: y {tuple(y.shape)} and w {tuple(w.shape)} do not agree")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: stream dtype {y.dtype} not supported")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {compute_dtype} not supported")
    if ks > 64:
        raise ValueError(f"{name}: kernel size {ks} > 64 not supported")


def _fwd_kernel(y, w, compute_dtype):
    """The forward kernel, any T (time in chunks): z (B, T, C) in y's dtype."""
    _check("glu_dwconv", y, w, compute_dtype)
    b, t, c2 = y.shape
    c = c2 // 2
    ks = w.shape[0]
    wf = w.float().contiguous()
    kernels.require_cuda("glu_dwconv", y, wf)
    z = torch.empty((b, t, c), dtype=y.dtype, device=y.device)
    if b * t == 0:
        return z
    lib = kernels.lib()
    with torch.cuda.device(y.device):
        code = lib.w2vb_conv_glu_fwd(
            y.data_ptr(), wf.data_ptr(), z.data_ptr(),
            int(y.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
            b, t, c, ks, kernels.stream_of(y),
        )
    kernels.check("conv_glu", code)
    kernels.LAUNCHES["conv_glu"] += 1
    return z


def _bwd_kernel(y, w, dz, compute_dtype):
    """The backward kernel, any T (time in chunks): (dy (B, T, 2C) in y's
    dtype, dK partials (B, ks, C) f32, per sample, each summed in a fixed
    order)."""
    _check("glu_dwconv backward", y, w, compute_dtype)
    b, t, c2 = y.shape
    c = c2 // 2
    ks = w.shape[0]
    wf = w.float().contiguous()
    dz = dz.contiguous()
    kernels.require_cuda("glu_dwconv backward", y, wf, dz)
    if dz.shape != (b, t, c) or dz.dtype != y.dtype:
        raise ValueError(f"glu_dwconv backward: dz {tuple(dz.shape)} {dz.dtype} vs y {tuple(y.shape)} {y.dtype}")
    dy = torch.empty_like(y)
    dk = torch.empty((b, ks, c), dtype=torch.float32, device=y.device)
    if b * t == 0:
        return dy, dk.zero_()
    lib = kernels.lib()
    with torch.cuda.device(y.device):
        code = lib.w2vb_conv_glu_bwd(
            y.data_ptr(), wf.data_ptr(), dz.data_ptr(), dy.data_ptr(), dk.data_ptr(),
            int(y.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
            b, t, c, ks, kernels.stream_of(y),
        )
    kernels.check("conv_glu_bwd", code)
    kernels.LAUNCHES["conv_glu_bwd"] += 1
    return dy, dk


class _GluDwconv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, w, compute_dtype):
        ctx.save_for_backward(y, w)
        ctx.compute_dtype = compute_dtype
        if y.is_cuda:
            return _fwd_kernel(y, w, compute_dtype)
        return glu_dwconv_plain(y, w, compute_dtype)

    @staticmethod
    def backward(ctx, dz):
        y, w = ctx.saved_tensors
        fn = _bwd_kernel if y.is_cuda else glu_dwconv_bwd_plain
        dy, dk = fn(y, w, dz.to(y.dtype), ctx.compute_dtype)
        return dy, dk.sum(dim=0).to(w.dtype), None


def glu_dwconv(y: torch.Tensor, w: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """y (B, T, 2C) f32/bf16; w (ks, C) -> z (B, T, C) in y's dtype;
    differentiable in y and w. On CUDA tensors the kernels run (or raise);
    on CPU tensors their plain versions."""
    return _GluDwconv.apply(y.contiguous(), w, compute_dtype)
