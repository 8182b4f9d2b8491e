"""Wav2Vec2 transformer encoder, feature-extractor-free (counterpart of
wav2vec2forbrain_tpu/models/wav2vec2.py, unscanned layer list).

Post-LN (do_stable_layer_norm=False, e.g. base-960h):
    x = x + pos_conv(x); x = LN(x); x = dropout(x)
    per layer: x = LN(x + dropout(attn(x))); x = finalLN(x + ffn(x))
Stable pre-LN (e.g. large-960h):
    x = x + pos_conv(x); x = dropout(x)
    per layer: x = x + dropout(attn(LN(x))); x = x + ffn(finalLN(x)); then the encoder LN
No attention mask: padded frames take part in the softmax, as in the
reference and the JAX package. Dtypes follow the JAX package: matmuls
contract in the compute dtype with f32 results, block outputs ride the
activation-stream dtype (x.dtype), norms run in f32.

Train mode: hash dropout at the encoder input and at the four sites of a
layer (models/seeds.py::W2V_LAYER_SITES), seeded in that order from the
forward's encoder SeedStream; LayerDrop. Every LayerNorm goes through
_layer_norm_routed: the layernorm kernel (ops/layernorm.py) when the policy
routes "layernorm" there, else the plain version.

Tensor parallelism (`tp`, parallel/tensor.py): the layer's params are this
rank's pieces. The attention and the FFN enter their column-split linears
through `enter` and leave through `row_linear`; q keeps its scale from the
whole hidden size and the global head count, the attention runs on this
rank's heads at their global head ids, the activation dropout on its FFN
columns at their global column ids, every other site on whole tensors.
"""

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from wav2vec2forbrain_tpu_torch.models import remat
from wav2vec2forbrain_tpu_torch.models.activations import ACT2FN
from wav2vec2forbrain_tpu_torch.models.fc import apply_linear, init_linear, uniform
from wav2vec2forbrain_tpu_torch.models.seeds import W2V_LAYER_SITES, SeedStream, sites_per_layer
from wav2vec2forbrain_tpu_torch.ops.attention import attention as mha
from wav2vec2forbrain_tpu_torch.ops.hash_dropout import hash_dropout
from wav2vec2forbrain_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain
from wav2vec2forbrain_tpu_torch.ops.select import kernel_enabled
from wav2vec2forbrain_tpu_torch.parallel.tensor import col0_of, enter, heads_of, row_finish, row_linear, row_product


@dataclass
class Wav2Vec2EncoderConfig:
    """The JAX Wav2Vec2EncoderConfig, with its defaults (base-960h)."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.1
    attention_dropout: float = 0.1
    final_dropout: float = 0.1
    layerdrop: float = 0.1
    layer_norm_eps: float = 1e-5
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False
    vocab_size: int = 32
    feat_extract_activation: str = "gelu"

    @classmethod
    def base_960h(cls) -> "Wav2Vec2EncoderConfig":
        return cls()

    @classmethod
    def large_960h(cls) -> "Wav2Vec2EncoderConfig":
        return cls(
            hidden_size=1024,
            num_hidden_layers=24,
            num_attention_heads=16,
            intermediate_size=4096,
            do_stable_layer_norm=True,
        )

    @classmethod
    def tiny_test(cls, **kw) -> "Wav2Vec2EncoderConfig":
        d = dict(
            hidden_size=96,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=128,
            num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4,
        )
        d.update(kw)
        return cls(**d)


# --- init ----------------------------------------------------------------------


def _init_layer_norm(size: int, device) -> dict:
    return {
        "scale": torch.ones(size, dtype=torch.float32, device=device),
        "bias": torch.zeros(size, dtype=torch.float32, device=device),
    }


def init_pos_conv(generator, h: int, k: int, groups: int, device) -> dict:
    """The weight-normed grouped conv: torch's kaiming-uniform v (out,
    in/groups, k), g = ||v|| over dims (0, 1) per tap, uniform bias."""
    bound = 1.0 / math.sqrt((h // groups) * k)
    v = uniform(generator, (h, h // groups, k), math.sqrt(3.0) * bound, device)
    g = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))
    return {"weight_g": g, "weight_v": v, "bias": uniform(generator, (h,), bound, device)}


def init_w2v_encoder_params(generator, cfg: Wav2Vec2EncoderConfig, device) -> dict:
    h = cfg.hidden_size
    lin = lambda i, o: init_linear(generator, i, o, device)  # noqa: E731
    pos_conv = init_pos_conv(generator, h, cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups, device)
    layers = [
        {
            "attention": {"q_proj": lin(h, h), "k_proj": lin(h, h), "v_proj": lin(h, h), "out_proj": lin(h, h)},
            "layer_norm": _init_layer_norm(h, device),
            "feed_forward": {
                "intermediate_dense": lin(h, cfg.intermediate_size),
                "output_dense": lin(cfg.intermediate_size, h),
            },
            "final_layer_norm": _init_layer_norm(h, device),
        }
        for _ in range(cfg.num_hidden_layers)
    ]
    # the stable (pre-LN) form applies the one "layer_norm" after the layers
    return {"pos_conv": pos_conv, "layer_norm": _init_layer_norm(h, device), "layers": layers}


def init_lm_head_params(generator, cfg: Wav2Vec2EncoderConfig, device) -> dict:
    return init_linear(generator, cfg.hidden_size, cfg.vocab_size, device)


# --- forward -------------------------------------------------------------------


def _layer_norm_routed(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LN through the layernorm kernel (3-D x, policy "layernorm"), else
    the plain version (f32 math, emitted in x's dtype)."""
    fn = layer_norm if x.dim() == 3 and kernel_enabled("layernorm") else layer_norm_plain
    return fn(x, p["scale"], p["bias"], eps)


def dropout_site(stream: Optional[SeedStream], x: torch.Tensor, rate: float, train: bool,
                 col0: int = 0) -> torch.Tensor:
    """One dropout site: a hash mask keyed on the stream's next seed, at the
    stream's global rows (and, for a rank's columns of a split tensor, at
    the global index col0 of its last dim's first)."""
    if not train or rate <= 0.0:
        return x
    return hash_dropout(x, stream.seed(), rate, stream.row0, col0)


# The pos-conv's cuDNN backward (dx and dW) picks a non-deterministic
# algorithm unless cuDNN's deterministic flag is set, and then two w2v-base
# trainings from one seed drift apart. _DeterministicConv1d sets the flag
# around both of its passes, for this convolution alone: autograd runs the
# backward later, outside any block around the forward. Off, the pos-conv is
# a plain F.conv1d (profile_train --pos-conv default measures the cost).
DETERMINISTIC_POS_CONV = True


@contextlib.contextmanager
def _cudnn_deterministic():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


class _DeterministicConv1d(torch.autograd.Function):
    """F.conv1d(x, w, padding=padding, groups=groups) with cuDNN's
    deterministic algorithms in the forward and the backward."""

    @staticmethod
    def forward(ctx, x, w, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.padding, ctx.groups = padding, groups
        with _cudnn_deterministic():
            return F.conv1d(x, w, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with _cudnn_deterministic():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [1], [ctx.padding], [1], False, [0], ctx.groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False],
            )
        return gx, gw, None, None


def pos_conv_embed(p: dict, x: torch.Tensor, cfg: Wav2Vec2EncoderConfig) -> torch.Tensor:
    """Grouped weight-normed conv positional embedding. x: (B, T, H)."""
    v = p["weight_v"]  # (out, in/groups, k)
    norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))
    w = p["weight_g"] * v / torch.clamp(norm, min=1e-12)
    k = cfg.num_conv_pos_embeddings
    xt, groups = x.transpose(1, 2), cfg.num_conv_pos_embedding_groups
    if DETERMINISTIC_POS_CONV:
        y = _DeterministicConv1d.apply(xt, w.to(x.dtype), k // 2, groups)
    else:
        y = F.conv1d(xt, w.to(x.dtype), padding=k // 2, groups=groups)
    # the f32 bias add promotes a bf16 conv output: cast back to the stream dtype
    y = (y.transpose(1, 2) + p["bias"]).to(x.dtype)
    if k % 2 == 0:  # SamePadLayer: trim the extra right output
        y = y[:, : x.shape[1], :]
    return ACT2FN[cfg.feat_extract_activation](y)


def self_attention(p, x, cfg: Wav2Vec2EncoderConfig, compute_dtype, stream=None, train=False, tp=None):
    """HF Wav2Vec2Attention (Bart style): q scaled by head_dim ** -0.5 in
    the stream dtype, then attention at scale 1."""
    heads = cfg.num_attention_heads
    cd = compute_dtype or x.dtype
    sd = x.dtype
    scale = (x.shape[-1] // heads) ** -0.5  # the whole hidden size over the global heads
    x = enter(x, tp)
    with remat.named("blk"):
        q = apply_linear(p["q_proj"], x, cd, out_dtype=sd) * scale
        k = apply_linear(p["k_proj"], x, cd, out_dtype=sd)
        v = apply_linear(p["v_proj"], x, cd, out_dtype=sd)
    rate = cfg.attention_dropout if train else 0.0
    seed, row0 = (stream.seed(), stream.row0) if rate > 0.0 else (0, 0)
    local_heads, head0 = heads_of(tp, heads)
    ctx = mha(q, k, v, local_heads, cd, rate, seed, scale=1.0, row0=row0, head0=head0)
    with remat.named("blk"):
        return row_linear(p["out_proj"], ctx, tp, cd, sd)


def _ffn_wide(p, cfg, compute_dtype, train, tp, stream, x):
    """The FFN's (B, T, intermediate) section: the up projection, the
    activation and its dropout, then the down projection's f32 product (this
    rank's partial sum under tp)."""
    with remat.named("ffn_wide"):
        y = apply_linear(p["intermediate_dense"], x, compute_dtype, out_dtype=x.dtype)
    y = ACT2FN[cfg.hidden_act](y)
    y = dropout_site(stream, y, cfg.activation_dropout, train, col0_of(tp, y.shape[-1]))
    with remat.named("blk"):
        return row_product(p["output_dense"], y, compute_dtype)


def feed_forward(p, x, cfg, compute_dtype, stream=None, train=False, tp=None):
    """Both families' FFN (cfg: either encoder config); its wide section is
    checkpointed under the "all_but_wide" remat policy (models/remat.py)."""
    wide = functools.partial(_ffn_wide, p, cfg, compute_dtype, train, tp)
    y = remat.wide(wide, stream, int(train and cfg.activation_dropout > 0.0), enter(x, tp))
    y = row_finish(p["output_dense"], y, tp, x.dtype)
    return dropout_site(stream, y, cfg.hidden_dropout, train)


def encoder_layer(p, x, cfg: Wav2Vec2EncoderConfig, compute_dtype, stream=None, train=False, tp=None):
    eps = cfg.layer_norm_eps
    if cfg.do_stable_layer_norm:
        y = _layer_norm_routed(p["layer_norm"], x, eps)
        y = self_attention(p["attention"], y, cfg, compute_dtype, stream, train, tp)
        x = x + dropout_site(stream, y, cfg.hidden_dropout, train)
        y = feed_forward(p["feed_forward"], _layer_norm_routed(p["final_layer_norm"], x, eps), cfg,
                         compute_dtype, stream, train, tp)
        return x + y
    y = self_attention(p["attention"], x, cfg, compute_dtype, stream, train, tp)
    x = _layer_norm_routed(p["layer_norm"], x + dropout_site(stream, y, cfg.hidden_dropout, train), eps)
    y = feed_forward(p["feed_forward"], x, cfg, compute_dtype, stream, train, tp)
    return _layer_norm_routed(p["final_layer_norm"], x + y, eps)


def apply_w2v_encoder(
    params: dict,
    x: torch.Tensor,
    cfg: Wav2Vec2EncoderConfig,
    train: bool = False,
    compute_dtype=None,
    stream: Optional[SeedStream] = None,
    tp=None,
    remat_policy: str = "none",
) -> torch.Tensor:
    """Full encoder. x: (B, T, H) -> (B, T, H). With tp (a
    parallel/tensor.py::TensorShard) the layers' params are this rank's
    pieces (the module's header).

    Train mode needs `stream` (the forward's encoder stream): the input
    dropout's seed, then the LayerDrop decisions, then every layer's sites
    in order. A layer that LayerDrop skips is not computed, but it consumes
    its sites' seeds, as the JAX forward computes it and where-masks it out.
    In train mode each layer that runs is checkpointed under remat_policy
    (models/remat.py)."""
    if train and stream is None:
        raise ValueError("apply_w2v_encoder: train mode needs a seed stream (models/seeds.py)")
    x = x + pos_conv_embed(params["pos_conv"], x, cfg)
    if not cfg.do_stable_layer_norm:
        x = _layer_norm_routed(params["layer_norm"], x, cfg.layer_norm_eps)
    x = dropout_site(stream, x, cfg.hidden_dropout, train)
    n_layers = len(params["layers"])
    drop = stream.layerdrop_mask(n_layers, cfg.layerdrop) if train and cfg.layerdrop > 0.0 else [False] * n_layers
    n_sites = sites_per_layer(cfg, W2V_LAYER_SITES)
    policy = remat_policy if train else "none"

    def layer(s, p_layer, x):
        return encoder_layer(p_layer, x, cfg, compute_dtype, s, train, tp)

    for p_layer, dropped in zip(params["layers"], drop):
        if dropped:
            stream.skip(n_sites)
            continue
        x = remat.checkpoint_layer(layer, policy, stream, n_sites, p_layer, x)
    if cfg.do_stable_layer_norm:
        x = _layer_norm_routed(params["layer_norm"], x, cfg.layer_norm_eps)
    return x


def apply_lm_head(params: dict, hidden: torch.Tensor, cfg: Wav2Vec2EncoderConfig, compute_dtype=None,
                  stream: Optional[SeedStream] = None, train: bool = False) -> torch.Tensor:
    """ForCTC head: the final dropout, then the vocab projection (f32)."""
    hidden = dropout_site(stream, hidden, cfg.final_dropout, train)
    return apply_linear(params, hidden, compute_dtype)
