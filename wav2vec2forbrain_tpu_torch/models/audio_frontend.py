"""Wav2Vec2 audio conv feature encoder + feature projection (counterpart of
wav2vec2forbrain_tpu/models/audio_frontend.py).

Raw 16 kHz audio -> projected latents, the reference's
Wav2Vec2WithoutTransformerModel (ref: src/model/w2v_no_encoder.py:11-35).
The latent analysis (analysis/latent_analysis.py) embeds speech through it
to compare with the brain-derived latents.

The tree keeps the JAX package's structure and layouts (the conv kernel
(k, in, out), "TIO"; linears (in, out)), so it crosses the bridge leaf for
leaf (bridge.py::frontend_from_jax). Both HF norm variants:
- "group": a per-channel norm over time after conv 0 only (base
  checkpoints; HF's GroupNorm with one group a channel);
- "layer": a LayerNorm over the channels after every conv (large / lv60).

The JAX package computes all of this outside Pallas, so no kernel is owed:
F.conv1d and plain tensor norms. Like JAX, the statistics take the
zero-padded tail of a batch in, and dropout is left out (eval only).
"""

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from wav2vec2forbrain_tpu_torch.models.activations import ACT2FN
from wav2vec2forbrain_tpu_torch.models.convert import _sd, layer_norm_from_torch
from wav2vec2forbrain_tpu_torch.models.fc import apply_linear, init_linear, uniform


@dataclass
class FeatureEncoderConfig:
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" | "layer"
    feat_extract_activation: str = "gelu"
    hidden_size: int = 768
    layer_norm_eps: float = 1e-5
    feat_proj_dropout: float = 0.1


def _norm_params(dim: int, device) -> dict:
    return {"scale": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)}


def init_feature_encoder_params(generator: torch.Generator, cfg: FeatureEncoderConfig, device) -> dict:
    """Random params with the JAX init's distributions (torch Conv1d's
    kaiming-uniform kernels, norms at 1 / 0), drawn on `device` from
    `generator` (which must live on that device)."""
    layers = []
    in_dim = 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        fan_in = in_dim * k
        layer = {"conv": {"kernel": uniform(generator, (k, in_dim, dim), math.sqrt(3.0 / fan_in), device)}}
        if cfg.conv_bias:
            layer["conv"]["bias"] = uniform(generator, (dim,), 1.0 / math.sqrt(fan_in), device)
        if cfg.feat_extract_norm == "group" and i == 0:
            layer["group_norm"] = _norm_params(dim, device)
        if cfg.feat_extract_norm == "layer":
            layer["layer_norm"] = _norm_params(dim, device)
        layers.append(layer)
        in_dim = dim
    return {
        "conv_layers": layers,
        "projection": {
            "layer_norm": _norm_params(cfg.conv_dim[-1], device),
            "projection": init_linear(generator, cfg.conv_dim[-1], cfg.hidden_size, device),
        },
    }


def _normalize(p: dict, x: torch.Tensor, dim: int, eps: float, channel_dim: int) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) over `dim` (population variance, as
    jnp.var), then the per-channel affine along `channel_dim`."""
    x = x.float()
    mean = x.mean(dim=dim, keepdim=True)
    var = x.var(dim=dim, unbiased=False, keepdim=True)
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"].view(shape) + p["bias"].view(shape)


def apply_feature_encoder(params: dict, audio: torch.Tensor, cfg: FeatureEncoderConfig) -> torch.Tensor:
    """audio: (B, S) raw waveform -> (B, T, conv_dim[-1]) extract features.
    VALID strided convs, channels first; the group norm takes each
    channel's statistics over time, the LayerNorm each frame's over the
    channels."""
    act = ACT2FN[cfg.feat_extract_activation]
    x = audio[:, None, :]  # (B, 1, S)
    for i, layer in enumerate(params["conv_layers"]):
        conv = layer["conv"]
        x = F.conv1d(x, conv["kernel"].permute(2, 1, 0).to(x.dtype), conv.get("bias"), stride=cfg.conv_stride[i])
        if "group_norm" in layer:
            x = _normalize(layer["group_norm"], x, 2, cfg.layer_norm_eps, 1)
        if "layer_norm" in layer:
            x = _normalize(layer["layer_norm"], x, 1, cfg.layer_norm_eps, 1)
        x = act(x)
    return x.transpose(1, 2)


def apply_feature_projection(params: dict, extract_features: torch.Tensor, cfg: FeatureEncoderConfig) -> torch.Tensor:
    """LN + linear to hidden_size (dropout omitted: eval-only use here)."""
    p = params["projection"]
    h = _normalize(p["layer_norm"], extract_features, -1, cfg.layer_norm_eps, -1)
    return apply_linear(p["projection"], h)


def apply_audio_frontend(params: dict, audio: torch.Tensor, cfg: FeatureEncoderConfig) -> torch.Tensor:
    """Full Wav2Vec2WithoutTransformerModel.forward equivalent: (B, S) ->
    (B, T, hidden_size)."""
    return apply_feature_projection(params, apply_feature_encoder(params, audio, cfg), cfg)


def feature_encoder_from_torch(sd: Dict, prefix_fe: str = "feature_extractor",
                               prefix_fp: str = "feature_projection", n_layers: int = 7, conv_bias: bool = False,
                               norm: str = "group") -> dict:
    """An HF Wav2Vec2FeatureEncoder + FeatureProjection state dict (a flat
    {name: tensor or ndarray}; a whole model's with prefix
    "wav2vec2.feature_extractor" / "wav2vec2.feature_projection") -> the
    tree, CPU tensors, leaf for leaf the JAX feature_encoder_from_torch's."""
    sd = _sd(sd)
    layers = []
    for i in range(n_layers):
        p = f"{prefix_fe}.conv_layers.{i}"
        layer = {"conv": {"kernel": sd[f"{p}.conv.weight"].permute(2, 1, 0).contiguous()}}  # (out, in, k) -> TIO
        if conv_bias and f"{p}.conv.bias" in sd:
            layer["conv"]["bias"] = sd[f"{p}.conv.bias"]
        if norm == "group" and i == 0:
            layer["group_norm"] = layer_norm_from_torch(sd, f"{p}.layer_norm")
        if norm == "layer":
            layer["layer_norm"] = layer_norm_from_torch(sd, f"{p}.layer_norm")
        layers.append(layer)
    return {
        "conv_layers": layers,
        "projection": {
            "layer_norm": layer_norm_from_torch(sd, f"{prefix_fp}.layer_norm"),
            "projection": {"kernel": sd[f"{prefix_fp}.projection.weight"].t().contiguous(),
                           "bias": sd[f"{prefix_fp}.projection.bias"]},
        },
    }
