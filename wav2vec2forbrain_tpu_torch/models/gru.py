"""Stacked (bi)GRU (counterpart of wav2vec2forbrain_tpu/models/gru.py).

Gate math and weight layout follow torch (gates r, z, n; b_hh inside
r * (...)); kernels are stored transposed like the JAX package: w_ih (in,
3H), w_hh (H, 3H). The input projection of all timesteps is one matmul
outside the recurrence. The backward direction consumes the time-flipped
PADDED sequence with no length awareness, as the reference (unpacked torch
GRU) and the JAX package do.

A bidirectional layer's recurrence runs through ops/gru.py (the CUDA kernels
on CUDA tensors) when the kernel policy routes "gru" there and the kernels
take the shape, else through its plain version (`recurrence_for`, an
explicit shape rule as in the JAX package's models/gru.py): from H = 512
up to the forward kernel's limit, the per-direction entry
(gru_recurrence_dir), whose bf16 dW_hh product is f32 as in the JAX
package's per-direction kernels, which that package runs at the sweep
widths 512 and 1024 (its TPU memory budget at the sweeps' batch picks them;
that budget does not apply here and is not copied); below 512, the fused
entry for H a multiple of 32 (the fused kernels' gate alignment); any other
H, the plain loop. The unidirectional path stays plain. In train mode the
inter-layer dropout (not after the last layer, as torch nn.GRU) is hash
dropout seeded from the forward's GRU SeedStream (models/seeds.py).
Gradients reach a learnable h0 through its broadcast to the batch.
"""

import math

import torch

from wav2vec2forbrain_tpu_torch.models.fc import matmul_f32, uniform
from wav2vec2forbrain_tpu_torch.ops.hash_dropout import hash_dropout
from wav2vec2forbrain_tpu_torch.ops.gru import (
    DIR_MAX_HIDDEN, gru_recurrence, gru_recurrence_dir, gru_recurrence_plain,
)
from wav2vec2forbrain_tpu_torch.ops.select import kernel_enabled

PER_DIRECTION_MIN_HIDDEN = 512  # the sweep widths the JAX package runs per direction


def init_gru_params(
    generator,
    in_size: int,
    hidden_size: int,
    num_layers: int,
    bidirectional: bool = True,
    bias: bool = True,
    learnable_initial_state: bool = False,
    device=None,
) -> dict:
    """torch nn.GRU default init: U(-1/sqrt(H), 1/sqrt(H)) for all weights;
    the learnable h0 is N(0, 1), (num_layers * num_directions, H)."""
    num_directions = 2 if bidirectional else 1
    bound = 1.0 / math.sqrt(hidden_size)
    layers = []
    for layer in range(num_layers):
        layer_in = in_size if layer == 0 else hidden_size * num_directions
        directions = []
        for _ in range(num_directions):
            d = {
                "w_ih": uniform(generator, (layer_in, 3 * hidden_size), bound, device),
                "w_hh": uniform(generator, (hidden_size, 3 * hidden_size), bound, device),
            }
            if bias:
                d["b_ih"] = uniform(generator, (3 * hidden_size,), bound, device)
                d["b_hh"] = uniform(generator, (3 * hidden_size,), bound, device)
            directions.append(d)
        layers.append({"directions": directions})
    params = {"layers": layers}
    if learnable_initial_state:
        params["hidden_start"] = torch.randn(
            (num_layers * num_directions, hidden_size), generator=generator, device=device
        )
    return params


def _gru_direction(d_params: dict, x: torch.Tensor, h0: torch.Tensor, compute_dtype=None):
    """One forward-in-time direction of one layer. x: (B, T, in) -> (B, T, H)."""
    cd = compute_dtype or x.dtype
    gi = matmul_f32(x.to(cd), d_params["w_ih"].to(cd))
    if "b_ih" in d_params:
        gi = gi + d_params["b_ih"]
    b_hh = d_params.get("b_hh")
    if b_hh is None:
        b_hh = torch.zeros(d_params["w_hh"].shape[-1], device=x.device)
    ys = gru_recurrence_plain(
        gi.transpose(0, 1)[:, None], d_params["w_hh"][None], b_hh[None], h0[None], cd
    )
    return ys[:, 0].transpose(0, 1)


def bigru_inputs(dirs: list, x: torch.Tensor, compute_dtype):
    """The recurrence's operands for one bidirectional layer: gi (T, 2, B,
    3H) f32 = [x, flip(x)] @ W_ih + b_ih (one matmul per direction, compute
    dtype, f32 result), w_hh (2, H, 3H) and b_hh (2, 1, 3H)."""
    xs = (x, torch.flip(x, dims=(1,)))
    gi = torch.stack([matmul_f32(xs[d].to(compute_dtype), dirs[d]["w_ih"].to(compute_dtype)) for d in range(2)])
    if "b_ih" in dirs[0]:
        gi = gi + torch.stack([d["b_ih"] for d in dirs])[:, None, None, :]
    gi = gi.permute(2, 0, 1, 3).contiguous()
    w_hh = torch.stack([d["w_hh"] for d in dirs])
    if "b_hh" in dirs[0]:
        b_hh = torch.stack([d["b_hh"] for d in dirs])[:, None, :]
    else:
        b_hh = torch.zeros((2, 1, w_hh.shape[-1]), device=x.device)
    return gi, w_hh, b_hh


def recurrence_for(hidden_size: int, use_kernel: bool):
    """The recurrence entry of a bidirectional layer of width hidden_size:
    a kernel entry only where its kernels take that H (module docstring)."""
    if not use_kernel:
        return gru_recurrence_plain
    if PER_DIRECTION_MIN_HIDDEN <= hidden_size <= DIR_MAX_HIDDEN:
        return gru_recurrence_dir
    if hidden_size < PER_DIRECTION_MIN_HIDDEN and hidden_size % 32 == 0:
        return gru_recurrence
    return gru_recurrence_plain


def bigru_layer(dirs: list, x: torch.Tensor, h0: torch.Tensor, compute_dtype=None, use_kernel=False):
    """Both directions of one layer. x: (B, T, in); h0: (2, B, H) f32 ->
    (B, T, 2H) f32 (counterpart of _bigru_layer_fused / bigru_layer_pallas)."""
    cd = compute_dtype or x.dtype
    gi, w_hh, b_hh = bigru_inputs(dirs, x, cd)
    rec = recurrence_for(w_hh.shape[1], use_kernel)
    ys = rec(gi, w_hh, b_hh, h0.contiguous(), cd)  # (T, 2, B, H)
    fwd = ys[:, 0].transpose(0, 1)
    bwd = torch.flip(ys[:, 1].transpose(0, 1), dims=(1,))
    return torch.cat([fwd, bwd], dim=-1)


def apply_gru(
    params: dict,
    x: torch.Tensor,
    hidden_size: int,
    num_layers: int,
    bidirectional: bool = True,
    use_learnable_initial_state: bool = False,
    compute_dtype=None,
    dropout: float = 0.0,
    train: bool = False,
    stream=None,
) -> torch.Tensor:
    """Full stacked (bi)GRU. x: (B, T, in) -> (B, T, H * num_directions).
    Train mode with dropout > 0 needs `stream` (a SeedStream)."""
    b = x.shape[0]
    num_directions = 2 if bidirectional else 1
    h0_all = params["hidden_start"] if use_learnable_initial_state else None
    use_kernel = bidirectional and kernel_enabled("gru")
    out = x
    for layer in range(num_layers):
        dirs = params["layers"][layer]["directions"]
        lo = layer * num_directions
        if h0_all is not None:
            h0 = h0_all[lo : lo + num_directions, None, :].expand(num_directions, b, hidden_size)
            h0 = h0.float()
        else:
            h0 = torch.zeros((num_directions, b, hidden_size), dtype=torch.float32, device=x.device)
        if num_directions == 2:
            out = bigru_layer(dirs, out, h0, compute_dtype, use_kernel)
        else:
            out = _gru_direction(dirs[0], out, h0[0], compute_dtype)
        if train and dropout > 0.0 and layer < num_layers - 1:
            if stream is None:
                raise ValueError("apply_gru: train-mode dropout needs a seed stream (models/seeds.py)")
            out = hash_dropout(out, stream.seed(), dropout, stream.row0)
    return out
