"""Multi-head attention on (B, T, H*D) operands with train-mode hash
dropout: the CUDA kernels' wrapper and the plain versions (counterparts of
wav2vec2forbrain_tpu/ops/pallas_attention.py::mha_fused_bth and
wav2vec2forbrain_tpu/ops/xla_attention.py::mha_dense_bth).

Forward, per (batch, head):
    s = (q_cd . k_cd^T) * scale   f32 accumulation
    p = softmax(s, -1)            f32, whole row
    p = p * mask * (1/keep)       train only; mask = hash_keep_mask(seed, ...)
    o = p_cd . v_cd               f32 accumulation, emitted in q's dtype
Backward (the Pallas `_bwd_kernel`), recomputing p and the mask:
    dv = pd_cd^T . g_cd;  dp = (g_cd . v_cd^T) * mask * (1/keep)
    ds = p * (dp - sum(dp * p, -1));  dq = ds_cd . k_cd * scale;
    dk = ds_cd^T . q_cd * scale       all emitted in q's dtype
There is no key-padding mask: like the JAX path, queries attend over pad
frames too. The mask is keyed on (seed, batch row, head, q row, k col), so
the kernel, the plain versions and the JAX package all drop the same
probabilities. The batch row is global: `row0` is the global index of the
operands' row 0 (a data-parallel rank's first row, 0 in one process), as
the JAX kernel takes a row-id vector that shards with q. So is the head:
`head0` is the global index of the operands' head 0 (a tensor-parallel
rank's first head, parallel/tensor.py), as the JAX kernel's head ids are
the layer's under a head-partitioned call.

The kernels are chosen by the compute dtype (`_fwd_route`). For heads up
to 128 wide, at any T, the forward is one tensor-core launch and the
backward two (dq with the row statistics, then dk and dv): at bf16 compute
on bf16 operands ("mma"); at f32 compute ("tf32x3") on TF32 operands with
each product split in three, a_big.b_small + a_small.b_big + a_big.b_big
where big = tf32(x) and small = tf32(x - big), which keeps ~22 bits of each
product (single-pass TF32 keeps 11): at logits of unit scale the f32
route holds the f32 tolerances of the plain versions, and at logits 8x
larger, where f32 rounding of the scores dominates, it stays within twice
the plain f32 version's own error of the f64 result. Where an f32
accumulator is fed back as the next product's operand, that product sums
over its keys in a permuted order (key 2t in k-slot t, 2t + 1 in t + 4),
the fragment layout of the TF32 product; a sum does not depend on its
order (csrc/attention.cu's header). At f32 compute a head wider than 128 takes a SIMT forward that
holds the head's K and V in shared memory, where they fit ("resident"); no
backward kernel takes such heads. A CUDA tensor launches its kernel or
raises; nothing falls back.
"""

import math
from typing import Optional

import torch

from wav2vec2forbrain_tpu_torch.ops import kernels
from wav2vec2forbrain_tpu_torch.ops.hash_dropout import hash_keep_mask
from wav2vec2forbrain_tpu_torch.ops.select import kernel_enabled

_MAX_SMEM = 227 * 1024
_WARPS, _ROWS = 4, 4  # warps per block and query rows per warp in the SIMT forward
_MAX_HEAD_DIM = 128  # the widest head of the tensor-core kernels; any T


def _heads(x, num_heads, cd):
    """(B, T, H*D) -> (B*H, T, D) f32 holding compute-dtype values."""
    b, t, hd = x.shape
    d = hd // num_heads
    x = x.to(cd).float().reshape(b, t, num_heads, d)
    return x.permute(0, 2, 1, 3).reshape(b * num_heads, t, d)


def _unheads(x, b, num_heads, dtype):
    """(B*H, T, D) f32 -> (B, T, H*D) in dtype."""
    _, t, d = x.shape
    return x.reshape(b, num_heads, t, d).permute(0, 2, 1, 3).reshape(b, t, num_heads * d).to(dtype)


def _scaled_mask(seed, b, num_heads, t, rate, device, row0=0, head0=0):
    """(mask (B*H, T, T) of 0/1, 1/keep), or None at rate 0."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention: dropout rate {rate} outside [0, 1)")
    if rate == 0.0:
        return None
    keep = hash_keep_mask(seed, (b, num_heads, t, t), 1.0 - rate, device, row0, head0)
    return keep.reshape(b * num_heads, t, t), 1.0 / (1.0 - rate)


def mha_dense_bth(q, k, v, num_heads: int, scale: float, dropout_rate: float, compute_dtype, seed: int = 0,
                  row0: int = 0, head0: int = 0):
    """Plain dense attention: q/k/v (B, T, H*D) -> ctx (B, T, H*D) in
    q.dtype; seed, row0 and head0 are used only when dropout_rate > 0."""
    b, t, _ = q.shape
    cd = compute_dtype
    s = torch.bmm(_heads(q, num_heads, cd), _heads(k, num_heads, cd).transpose(1, 2)) * scale
    p = torch.softmax(s, dim=-1)
    masked = _scaled_mask(seed, b, num_heads, t, dropout_rate, q.device, row0, head0)
    if masked is not None:
        p = p * masked[0] * masked[1]
    ctx = torch.bmm(p.to(cd).float(), _heads(v, num_heads, cd))
    return _unheads(ctx, b, num_heads, q.dtype)


def mha_bwd_plain(q, k, v, g, num_heads: int, scale: float, dropout_rate: float, compute_dtype, seed: int = 0,
                  row0: int = 0, head0: int = 0):
    """Plain version of the backward kernel: (dq, dk, dv), each (B, T, H*D)
    in q.dtype, for the upstream gradient g of the context."""
    b, t, _ = q.shape
    cd = compute_dtype
    qh, kh, vh = (_heads(x, num_heads, cd) for x in (q, k, v))
    gh = _heads(g.to(q.dtype), num_heads, cd)
    p = torch.softmax(torch.bmm(qh, kh.transpose(1, 2)) * scale, dim=-1)
    masked = _scaled_mask(seed, b, num_heads, t, dropout_rate, q.device, row0, head0)
    mask = None if masked is None else masked[0] * masked[1]
    pd = p if mask is None else p * mask
    dv = torch.bmm(pd.to(cd).float().transpose(1, 2), gh)
    dp = torch.bmm(gh, vh.transpose(1, 2))
    if mask is not None:
        dp = dp * mask
    ds = (p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))).to(cd).float()
    dq = torch.bmm(ds, kh) * scale
    dk = torch.bmm(ds.transpose(1, 2), qh) * scale
    return tuple(_unheads(x, b, num_heads, q.dtype) for x in (dq, dk, dv))


def _check(name, q, k, v, num_heads, compute_dtype):
    b, t, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape or hd % num_heads:
        raise ValueError(f"{name}: q/k/v shapes {q.shape}, {k.shape}, {v.shape}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must share a float32 or bfloat16 dtype")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {compute_dtype} not supported")


def _dropout_args(dropout_rate, seed, row0, head0):
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"attention: dropout rate {dropout_rate} outside [0, 1)")
    if not 0 <= row0 < 2**31:
        raise ValueError(f"attention: row0 {row0} outside [0, 2^31)")
    if not 0 <= head0 < 2**31:
        raise ValueError(f"attention: head0 {head0} outside [0, 2^31)")
    keep = 1.0 - dropout_rate
    return int(seed), int(row0), int(head0), float(keep), float(1.0 / keep)


def _simt_fits(t, d):
    """Whether the SIMT forward, which holds a head's K and V (f32) in shared
    memory with 4 x 4 rows of q and p, fits the block's shared memory."""
    return (t * (2 * d + 1) + _WARPS * _ROWS * (d + t)) * 4 <= _MAX_SMEM


def _fwd_route(t, d, compute_dtype):
    """The forward kernel for the shape: "mma" (bf16 compute) or "tf32x3" (f32
    compute) on the tensor cores for D <= 128 at any T; for wider heads at f32
    compute "resident" (the SIMT kernel) where it fits; else None."""
    if d <= _MAX_HEAD_DIM:
        return "mma" if compute_dtype == torch.bfloat16 else "tf32x3"
    if compute_dtype == torch.float32 and _simt_fits(t, d):
        return "resident"
    return None


def _fwd_kernel(q, k, v, num_heads, scale, dropout_rate, compute_dtype, seed, row0=0, head0=0):
    _check("mha_fused_bth", q, k, v, num_heads, compute_dtype)
    b, t, hd = q.shape
    d = hd // num_heads
    route = _fwd_route(t, d, compute_dtype)
    if route is None:
        raise ValueError(f"mha_fused_bth: head dim {d} > {_MAX_HEAD_DIM} at T={t}: no kernel takes it")
    kernels.require_cuda("mha_fused_bth", q, k, v)
    o = torch.empty_like(q)
    lib = kernels.lib()
    with torch.cuda.device(q.device):
        code = lib.w2vb_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            int(q.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16), int(route == "resident"),
            b, t, num_heads, d, float(scale), *_dropout_args(dropout_rate, seed, row0, head0),
            kernels.stream_of(q),
        )
    kernels.check("attention", code)
    kernels.LAUNCHES["attention"] += 1
    return o


def _bwd_kernel(q, k, v, g, num_heads, scale, dropout_rate, compute_dtype, seed, row0=0, head0=0):
    _check("mha_fused_bth backward", q, k, v, num_heads, compute_dtype)
    b, t, hd = q.shape
    d = hd // num_heads
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"mha_fused_bth backward: head dim {d} > {_MAX_HEAD_DIM}")
    g = g.to(q.dtype).contiguous()
    kernels.require_cuda("mha_fused_bth backward", q, k, v, g)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((3, b, num_heads, t), dtype=torch.float32, device=q.device)  # softmax max, sum, D_i
    lib = kernels.lib()
    with torch.cuda.device(q.device):
        code = lib.w2vb_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            int(q.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
            b, t, num_heads, d, float(scale), *_dropout_args(dropout_rate, seed, row0, head0),
            kernels.stream_of(q),
        )
    kernels.check("attention_bwd", code)
    kernels.LAUNCHES["attention_bwd"] += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale, dropout_rate, compute_dtype, seed, row0, head0):
        ctx.save_for_backward(q, k, v)
        ctx.args = (num_heads, scale, dropout_rate, compute_dtype, seed, row0, head0)
        fn = _fwd_kernel if q.is_cuda else mha_dense_bth
        return fn(q, k, v, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        fn = _bwd_kernel if q.is_cuda else mha_bwd_plain
        dq, dk, dv = fn(q, k, v, g, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def mha_fused_bth(q, k, v, num_heads: int, scale: float, dropout_rate: float, compute_dtype, seed: int = 0,
                  row0: int = 0, head0: int = 0):
    """Same contract as mha_dense_bth; differentiable. On CUDA tensors the
    forward and backward kernels run (or raise); on CPU tensors their plain
    versions (mha_dense_bth, mha_bwd_plain)."""
    return _FusedAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), num_heads, float(scale),
        float(dropout_rate), compute_dtype, int(seed), int(row0), int(head0),
    )


def attention(q, k, v, num_heads: int, compute_dtype, dropout_rate: float = 0.0, seed: int = 0,
              scale: Optional[float] = None, row0: int = 0, head0: int = 0):
    """Model-side entry (counterpart of mha_with_rng): the kernels when the
    policy routes "attention" to them, else the dense version. Pass
    dropout_rate 0 in eval mode. num_heads is the heads q holds; scale
    defaults to head_dim ** -0.5 (the wav2vec2 encoder pre-scales q and
    passes 1.0); row0 and head0 are the global batch index of row 0 and the
    global index of head 0 (the dropout mask's coordinates)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    fn = mha_fused_bth if kernel_enabled("attention") else mha_dense_bth
    return fn(q, k, v, num_heads, scale, dropout_rate, compute_dtype, seed, row0, head0)
