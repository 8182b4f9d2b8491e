"""Stateless hash dropout (counterpart of
wav2vec2forbrain_tpu/ops/hash_dropout.py and of the mask in
wav2vec2forbrain_tpu/ops/xla_attention.py::hash_keep_mask).

The keep decision of an element is a murmur3-finalizer hash of its
coordinates mixed with an int32 seed, so the backward recomputes the mask
from the seed instead of saving it. Both masks here equal the JAX package's
bit for bit: the uint32 arithmetic is emulated in int64 and cut to 32 bits
after every add, multiply and shift (the low 32 bits of an int64 product
are exact even when the product wraps), and the uniform is the 24 high bits
times 2^-24 in f32, compared with keep_prob rounded to f32.

These are plain PyTorch ops: in the JAX package too they run outside any
Pallas kernel. The attention kernel (csrc/attention.cu) computes the same
attention mask in its own body.

Under data parallelism a rank holds rows [row0, row0 + B) of the global
batch, and the JAX package keys every mask on the GLOBAL coordinates (a
sharded iota; the attention kernel's row-id vector). `row0` adds that
offset on dim 0, so a rank's mask is bit for bit its slice of the whole
batch's mask (row0 0: one process). Under tensor parallelism a rank holds
columns [col0, col0 + n) of the FFN's intermediate activation and heads
[head0, head0 + H) of the attention: `col0` offsets the last dim of
`hash_uniform` / `hash_dropout`, `head0` the head dim of `hash_keep_mask`
(every offset 0: the unsplit masks, bit for bit).
"""

import torch

_M32 = 0xFFFFFFFF
_SEED_MIX = 0x27D4EB2F
_COORD_MIX = (0x165667B1, 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35)


def _finalize(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64 (in place)."""
    x ^= x >> 16
    x.mul_(0x7FEB352D).bitwise_and_(_M32)
    x ^= x >> 15
    x.mul_(0x846CA68B).bitwise_and_(_M32)
    x ^= x >> 16
    return x


def _to_uniform(x: torch.Tensor) -> torch.Tensor:
    """24 high bits of the uint32 hash -> exact f32 uniform in [0, 1)."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hash_uniform(shape, seed: int, device=None, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """Per-element f32 uniform in [0, 1) of `shape`, keyed on (seed, element
    coordinates), dim 0's counted from row0 and the last dim's from col0:
    the JAX `hash_dropout._uniform`, bit for bit."""
    x = torch.full((), (int(seed) * _SEED_MIX) & _M32, dtype=torch.int64, device=device)
    nd = len(shape)
    starts = [0] * nd
    if nd:
        starts[0] += int(row0)
        starts[-1] += int(col0)
    for d, n in enumerate(shape):
        view = [1] * nd
        view[d] = n
        start = starts[d]
        i = torch.arange(start, start + n, dtype=torch.int64, device=device).reshape(view)
        x = (x + (i * _COORD_MIX[d % 4]).bitwise_and_(_M32)).bitwise_and_(_M32)
    x = x.expand(*shape).contiguous() if nd else x.clone()
    return _to_uniform(_finalize(x))


def _rounded(value: float, dtype) -> float:
    """value rounded to dtype, as a python float (exact in that dtype, so
    using it as a scalar operand rounds no further). Python scalars keep
    the device queue free of host-to-device copies."""
    return float(torch.tensor(value, dtype=dtype))


def _apply(x: torch.Tensor, seed: int, rate: float, row0: int, col0: int) -> torch.Tensor:
    keep = hash_uniform(x.shape, seed, x.device, row0, col0) < _rounded(1.0 - rate, torch.float32)
    return torch.where(keep, x * _rounded(1.0 / (1.0 - rate), x.dtype), 0.0)


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate, row0, col0):
        ctx.args = (seed, rate, row0, col0)
        return _apply(x, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        # the same mask by construction: same seed, same coordinates
        return _apply(g, *ctx.args), None, None, None, None


def hash_dropout(x: torch.Tensor, seed: int, rate: float, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """x with elements dropped and survivors scaled by 1/(1 - rate), in x's
    dtype; seed is a python int in [0, 2^31 - 1), row0 the global index of
    x's row 0 and col0 that of its last dim's column 0. The backward
    recomputes the mask from the seed (nothing mask-shaped is saved)."""
    return _HashDropout.apply(x, int(seed), float(rate), int(row0), int(col0))


def hash_keep_mask(seed: int, shape_bhqk, keep_prob: float, device=None, row0: int = 0,
                   head0: int = 0) -> torch.Tensor:
    """(B, H, Tq, Tk) f32 0/1 attention keep mask keyed on (seed, batch row
    counted from row0, head counted from head0, q row, k col): the JAX
    `xla_attention.hash_keep_mask` and the Pallas kernel's
    `_keep_mask`/`_mix`, bit for bit."""
    b, h, tq, tk = shape_bhqk

    def iota(n, dim, mult, start=0):
        view = [1, 1, 1, 1]
        view[dim] = n
        i = torch.arange(start, start + n, dtype=torch.int64, device=device).reshape(view)
        return (i * mult).bitwise_and_(_M32)

    mix = ((int(seed) * _SEED_MIX) & _M32) + iota(b, 0, 0x165667B1, int(row0))
    mix = (mix.bitwise_and_(_M32) + iota(h, 1, 0x9E3779B9, int(head0))).bitwise_and_(_M32)
    rc = (iota(tq, 2, 0x9E3779B9) + iota(tk, 3, 0x85EBCA6B)).bitwise_and_(_M32)
    x = (mix + rc).bitwise_and_(_M32)
    u = _to_uniform(_finalize(x))
    return (u < _rounded(keep_prob, torch.float32)).to(torch.float32)
