"""Wav2Vec2-Conformer encoder with rotary position embeddings (counterpart
of wav2vec2forbrain_tpu/models/conformer.py, unscanned layer list).

Per block (macaron):
    x = x + 0.5 * ffn1(LN(x))
    x = x + dropout(attn_rope(LN(x)))
    x = x + conv_module(x)      # LN -> pw-conv(GLU) -> dw-conv -> BN -> act -> pw-conv
    x = LN(x + 0.5 * ffn2(LN(x)))
then a final encoder LayerNorm. RoPE rotates the *hidden states* before the
q/k projections (the HF quirk the JAX package keeps). Dtypes follow the JAX
package: matmuls contract in the compute dtype with f32 results, block
outputs ride the activation-stream dtype (x.dtype), norms run in f32.

Train mode, as the JAX package: hash dropout at the seven sites of a layer
(each FFN half's activation and output, the attention probabilities inside
the attention op, the attention output, the conv module's output) and on
the encoder input, seeded in that order from the forward's encoder
SeedStream (models/seeds.py); BatchNorm on batch statistics (the global
batch's under data parallelism: the stream's group); LayerDrop.

Every LayerNorm (five per layer and the encoder's last) goes through
models/wav2vec2.py::_layer_norm_routed, as in the JAX package: the
layernorm kernel when the policy routes "layernorm" there.

Tensor parallelism (`tp`, parallel/tensor.py): the layer's params are this
rank's pieces. The attention and both FFN halves enter their column-split
linears through `enter` and leave through `row_linear`; the rotary
embedding rotates the whole hidden state with the global head count
before the projections, the attention runs on this rank's heads at their
global head ids, the activation dropout on its FFN columns at their global
column ids, and every other site on whole tensors, as without tp.
"""

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from wav2vec2forbrain_tpu_torch.models import remat
from wav2vec2forbrain_tpu_torch.models.activations import ACT2FN
from wav2vec2forbrain_tpu_torch.models.fc import apply_linear, init_linear, matmul_f32, uniform
from wav2vec2forbrain_tpu_torch.models.seeds import CONFORMER_LAYER_SITES, SeedStream, sites_per_layer
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import (
    _init_layer_norm,
    _layer_norm_routed,
    dropout_site,
    feed_forward,
    init_pos_conv,
)
from wav2vec2forbrain_tpu_torch.ops.attention import attention
from wav2vec2forbrain_tpu_torch.ops.conv_glu import depthwise_conv_same, glu_dwconv
from wav2vec2forbrain_tpu_torch.ops.select import kernel_enabled
from wav2vec2forbrain_tpu_torch.parallel import distributed
from wav2vec2forbrain_tpu_torch.parallel.tensor import enter, heads_of, row_linear


@dataclass
class ConformerEncoderConfig:
    """The JAX ConformerEncoderConfig's fields the forward reads, with the
    JAX defaults."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    # HF config default; the released rope-large-960h-ft checkpoint's
    # config.json specifies "swish" (see rope_large_960h())
    hidden_act: str = "gelu"
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.1
    attention_dropout: float = 0.1
    conformer_conv_dropout: float = 0.1
    final_dropout: float = 0.1
    layerdrop: float = 0.1
    layer_norm_eps: float = 1e-5
    conv_depthwise_kernel_size: int = 31
    rotary_embedding_base: int = 10000
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    vocab_size: int = 32
    batch_norm_momentum: float = 0.1
    batch_norm_eps: float = 1e-5

    @classmethod
    def rope_large_960h(cls) -> "ConformerEncoderConfig":
        return cls(hidden_act="swish")

    @classmethod
    def tiny_test(cls, **kw) -> "ConformerEncoderConfig":
        d = dict(
            hidden_size=96,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=128,
            num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4,
            conv_depthwise_kernel_size=31,
        )
        d.update(kw)
        return cls(**d)


# --- init ----------------------------------------------------------------------


def _init_conv1d_kernel(generator, shape, fan_in: int, device) -> torch.Tensor:
    """torch Conv1d kaiming-uniform init: U(-sqrt(3/fan_in), sqrt(3/fan_in))."""
    return uniform(generator, shape, math.sqrt(3.0) / math.sqrt(fan_in), device)


def init_conformer_layer_params(generator, cfg: ConformerEncoderConfig, device) -> dict:
    h = cfg.hidden_size
    ks = cfg.conv_depthwise_kernel_size
    lin = lambda i, o: init_linear(generator, i, o, device)  # noqa: E731
    return {
        "ffn1_layer_norm": _init_layer_norm(h, device),
        "ffn1": {
            "intermediate_dense": lin(h, cfg.intermediate_size),
            "output_dense": lin(cfg.intermediate_size, h),
        },
        "self_attn_layer_norm": _init_layer_norm(h, device),
        "self_attn": {
            "linear_q": lin(h, h),
            "linear_k": lin(h, h),
            "linear_v": lin(h, h),
            "linear_out": lin(h, h),
        },
        "conv_module": {
            "layer_norm": _init_layer_norm(h, device),
            # pointwise: (in, out); depthwise: (k, 1, C), as in the JAX package
            "pointwise_conv1": {"kernel": _init_conv1d_kernel(generator, (h, 2 * h), h, device)},
            "depthwise_conv": {"kernel": _init_conv1d_kernel(generator, (ks, 1, h), ks, device)},
            "batch_norm": {
                "scale": torch.ones(h, dtype=torch.float32, device=device),
                "bias": torch.zeros(h, dtype=torch.float32, device=device),
            },
            "pointwise_conv2": {"kernel": _init_conv1d_kernel(generator, (h, h), h, device)},
        },
        "ffn2_layer_norm": _init_layer_norm(h, device),
        "ffn2": {
            "intermediate_dense": lin(h, cfg.intermediate_size),
            "output_dense": lin(cfg.intermediate_size, h),
        },
        "final_layer_norm": _init_layer_norm(h, device),
    }


def init_conformer_encoder_params(generator, cfg: ConformerEncoderConfig, device) -> dict:
    h = cfg.hidden_size
    return {
        # dead parity params (HF owns them, its forward never applies them)
        "pos_conv": init_pos_conv(generator, h, cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups,
                                  device),
        "layer_norm": _init_layer_norm(h, device),
        "layers": [
            init_conformer_layer_params(generator, cfg, device)
            for _ in range(cfg.num_hidden_layers)
        ],
    }


def init_conformer_state(cfg: ConformerEncoderConfig, device) -> dict:
    h = cfg.hidden_size
    return {
        "layers": [
            {
                "batch_norm": {
                    "mean": torch.zeros(h, dtype=torch.float32, device=device),
                    "var": torch.ones(h, dtype=torch.float32, device=device),
                }
            }
            for _ in range(cfg.num_hidden_layers)
        ]
    }


# --- rotary ----------------------------------------------------------------------


def rotary_cos_sin(seq_len: int, head_size: int, base: float, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    exponent = torch.arange(0, head_size, 2, dtype=torch.float32, device=device) / head_size
    inv_freq = 1.0 / (base**exponent)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = t[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)  # (T, head_size)
    return torch.cos(emb), torch.sin(emb)


def _apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, num_heads: int):
    """HF quirk: rotate the hidden states (B, T, H) before the q/k projections."""
    b, t, h = x.shape
    head = h // num_heads
    xh = x.reshape(b, t, num_heads, head)
    x1 = xh[..., : head // 2]
    x2 = xh[..., head // 2 :]
    rotated = torch.cat([-x2, x1], dim=-1)
    out = xh * cos[None, :, None, :] + rotated * sin[None, :, None, :]
    return out.reshape(b, t, h).to(x.dtype)


# --- blocks -----------------------------------------------------------------------


def conformer_self_attention(p, x, cfg: ConformerEncoderConfig, cos, sin, compute_dtype, stream=None, train=False,
                             tp=None):
    heads = cfg.num_attention_heads
    cd = compute_dtype or x.dtype
    sd = x.dtype
    x = enter(x, tp)
    qk_states = _apply_rotary(x, cos, sin, heads)  # the whole hidden state, the global heads
    with remat.named("blk"):
        q = apply_linear(p["linear_q"], qk_states, cd, out_dtype=sd)
        k = apply_linear(p["linear_k"], qk_states, cd, out_dtype=sd)
        v = apply_linear(p["linear_v"], x, cd, out_dtype=sd)
    rate = cfg.attention_dropout if train else 0.0
    seed, row0 = (stream.seed(), stream.row0) if rate > 0.0 else (0, 0)
    local_heads, head0 = heads_of(tp, heads)
    ctx = attention(q, k, v, local_heads, cd, rate, seed, row0=row0, head0=head0)
    with remat.named("blk"):
        return row_linear(p["linear_out"], ctx, tp, cd, sd)


def _batch_norm(p: dict, state: dict, x: torch.Tensor, cfg: ConformerEncoderConfig, train: bool = False,
                group=None):
    """BatchNorm over channels of (B, T, C), torch semantics: train mode
    normalises with the biased batch variance over (B, T), pad frames
    included, and moves the running stats by the momentum with the unbiased
    variance; eval mode uses the running stats. Normalises in f32, emits in
    x's dtype. Returns (y, new_state).

    With a data-parallel `group` (the ranks holding the rest of the batch)
    the statistics are the global batch's, as the JAX package's are under a
    sharded batch: the sums over (B, T) are summed over the ranks, mean
    first, then the squared deviations from it, and their gradients are
    summed back (parallel/distributed.py::sum_across); n counts every
    rank's frames."""
    if train:
        x32 = x.float()
        n = x.shape[0] * x.shape[1]
        if group is None:
            mean = x32.mean(dim=(0, 1))
            var = x32.var(dim=(0, 1), unbiased=False)
        else:
            n *= distributed.group_size(group)
            mean = distributed.sum_across(x32.sum(dim=(0, 1)), group) / n
            var = distributed.sum_across(torch.square(x32 - mean).sum(dim=(0, 1)), group) / n
        unbiased = var * n / max(n - 1, 1)
        m = cfg.batch_norm_momentum
        new_state = {
            "mean": (1 - m) * state["mean"] + m * mean.detach(),
            "var": (1 - m) * state["var"] + m * unbiased.detach(),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.rsqrt(var + cfg.batch_norm_eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype), new_state


def _conv_wide(p, state, cfg: ConformerEncoderConfig, compute_dtype, train, stream, y):
    """The conv module's wide section, from its first pointwise conv to the
    activation after BatchNorm: (y, new BN state)."""
    cd = compute_dtype or y.dtype
    sd = y.dtype
    # pointwise conv1 (k=1, no bias) == dense to 2C, then GLU over channels
    y = matmul_f32(y.to(cd), p["pointwise_conv1"]["kernel"].to(cd)).to(sd)
    w_dw = p["depthwise_conv"]["kernel"][:, 0, :]  # (ks, C)
    if kernel_enabled("conv_glu"):
        y = glu_dwconv(y, w_dw, cd)
    else:
        a, gate = y.float().chunk(2, dim=-1)
        y = (a * torch.sigmoid(gate)).to(sd)
        y = depthwise_conv_same(y.to(cd), w_dw.to(cd)).to(cd).to(sd)
    group = stream.group if train else None
    y, new_bn = _batch_norm(p["batch_norm"], state["batch_norm"], y, cfg, train, group)
    return ACT2FN[cfg.hidden_act](y), new_bn


def conformer_conv_module(p, state, x, cfg: ConformerEncoderConfig, compute_dtype, stream=None, train=False):
    """Returns (y, new_state) with new_state = {"batch_norm": ...}; the wide
    section is checkpointed under the "all_but_wide" remat policy
    (models/remat.py)."""
    cd = compute_dtype or x.dtype
    y = _layer_norm_routed(p["layer_norm"], x, cfg.layer_norm_eps)
    y, new_bn = remat.wide(functools.partial(_conv_wide, p, state, cfg, compute_dtype, train), stream, 0, y)
    with remat.named("blk"):
        y = matmul_f32(y.to(cd), p["pointwise_conv2"]["kernel"].to(cd)).to(x.dtype)
    return dropout_site(stream, y, cfg.conformer_conv_dropout, train), {"batch_norm": new_bn}


def conformer_layer(p, state, x, cfg: ConformerEncoderConfig, cos, sin, compute_dtype, stream=None, train=False,
                    tp=None):
    """One macaron block. Returns (x, new_state)."""
    eps = cfg.layer_norm_eps
    residual = x
    y = _layer_norm_routed(p["ffn1_layer_norm"], x, eps)
    y = feed_forward(p["ffn1"], y, cfg, compute_dtype, stream, train, tp)
    x = y * 0.5 + residual

    residual = x
    y = _layer_norm_routed(p["self_attn_layer_norm"], x, eps)
    y = conformer_self_attention(p["self_attn"], y, cfg, cos, sin, compute_dtype, stream, train, tp)
    y = dropout_site(stream, y, cfg.attention_dropout, train)
    x = residual + y

    residual = x
    y, new_state = conformer_conv_module(p["conv_module"], state, x, cfg, compute_dtype, stream, train)
    x = residual + y

    residual = x
    y = _layer_norm_routed(p["ffn2_layer_norm"], x, eps)
    y = feed_forward(p["ffn2"], y, cfg, compute_dtype, stream, train, tp)
    x = y * 0.5 + residual
    return _layer_norm_routed(p["final_layer_norm"], x, eps), new_state


def apply_conformer_encoder(
    params: dict,
    state: dict,
    x: torch.Tensor,
    cfg: ConformerEncoderConfig,
    train: bool = False,
    compute_dtype=None,
    stream: Optional[SeedStream] = None,
    tp=None,
    remat_policy: str = "none",
) -> Tuple[torch.Tensor, dict]:
    """Full encoder. Returns (hidden (B, T, H), new_state). With tp (a
    parallel/tensor.py::TensorShard) the layers' params are this rank's
    pieces (the module's header).

    Train mode needs `stream` (the forward's encoder stream): the input
    dropout's seed, then the LayerDrop decisions, then every layer's sites
    in order. A layer that LayerDrop skips is not computed, but it consumes
    its sites' seeds and keeps its BatchNorm state, as the JAX forward
    computes it and where-masks both out. In train mode each layer that runs
    is checkpointed under remat_policy (models/remat.py)."""
    if train and stream is None:
        raise ValueError("apply_conformer_encoder: train mode needs a seed stream (models/seeds.py)")
    x = dropout_site(stream, x, cfg.hidden_dropout, train)
    head = cfg.hidden_size // cfg.num_attention_heads
    cos, sin = rotary_cos_sin(x.shape[1], head, cfg.rotary_embedding_base, x.device)
    n_layers = len(params["layers"])
    drop = stream.layerdrop_mask(n_layers, cfg.layerdrop) if train and cfg.layerdrop > 0.0 else [False] * n_layers
    n_sites = sites_per_layer(cfg, CONFORMER_LAYER_SITES)
    policy = remat_policy if train else "none"

    def layer(s, p_layer, s_layer, x):
        return conformer_layer(p_layer, s_layer, x, cfg, cos, sin, compute_dtype, s, train, tp)

    new_states = []
    for p_layer, s_layer, dropped in zip(params["layers"], state["layers"], drop):
        if dropped:
            stream.skip(n_sites)
            new_states.append(s_layer)
            continue
        x, new_s = remat.checkpoint_layer(layer, policy, stream, n_sites, p_layer, s_layer, x)
        new_states.append(new_s)
    return _layer_norm_routed(params["layer_norm"], x, cfg.layer_norm_eps), {"layers": new_states}
