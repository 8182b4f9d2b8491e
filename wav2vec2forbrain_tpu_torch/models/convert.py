"""Flat torch state dicts -> the port's param trees (counterpart of
wav2vec2forbrain_tpu/models/convert.py).

The port keeps the JAX package's tree structure, key names and (in, out)
kernel layouts (bridge.py), so each function here builds the tree that its
JAX namesake builds, leaf for leaf and bit for bit, as CPU tensors. Every
function takes a flat {name: tensor or ndarray} dict: an HF checkpoint's
(models/hf_snapshot.py), the original reference repo's model.pt /
brain_encoder.pt, or a live module's state_dict().

Keys the port's model has no place for are dropped by never being read, as
in the JAX converter: the HF audio front end (feature_extractor.*,
feature_projection.*, masked_spec_embed) that the brain encoder replaces,
the rotary inv_freq, and the reference's discriminator / suc_for_ctc heads.
A key the tree needs and the dict lacks raises a KeyError that names it.
"""

from typing import Dict

import numpy as np
import torch


class StateDict(dict):
    """A flat state dict whose missing keys raise with their names."""

    def __missing__(self, key):
        raise KeyError(f"the checkpoint has no {key!r}")


def state_dict_from(module_or_dict) -> StateDict:
    """{name: CPU tensor} copies (so later in-place changes to a module's
    buffers, such as BatchNorm statistics, do not reach the tree, whose
    leaves may share the copies' memory)."""
    if hasattr(module_or_dict, "state_dict"):
        module_or_dict = module_or_dict.state_dict()

    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.detach().to("cpu", copy=True)
        return torch.from_numpy(np.array(v, copy=True))

    return StateDict({k: copy(v) for k, v in module_or_dict.items()})


def _sd(sd) -> StateDict:
    return sd if isinstance(sd, StateDict) else state_dict_from(sd)


def _t(x: torch.Tensor) -> torch.Tensor:
    """A transposed copy, C-contiguous (numpy's `.T.copy()`)."""
    return x.t().contiguous()


# --- Linear / FC -----------------------------------------------------------


def linear_from_torch(sd: Dict, prefix: str) -> dict:
    sd = _sd(sd)
    p = prefix + "." if prefix else ""
    return {"kernel": _t(sd[f"{p}weight"]), "bias": sd[f"{p}bias"]}


def fc_from_torch(sd: Dict, prefix: str, n_layers: int) -> dict:
    """torch nn.Sequential of Linear(+act): linears sit at even indices."""
    sd = _sd(sd)
    p = prefix + "." if prefix else ""
    layers = []
    idx = 0
    while len(layers) < n_layers:
        if f"{p}{idx}.weight" in sd:
            layers.append(linear_from_torch(sd, f"{p}{idx}"))
        idx += 1
        if idx > 10 * n_layers + 10:
            raise KeyError(f"Could not find {n_layers} linears under {prefix}")
    return {"layers": layers}


# --- GRU --------------------------------------------------------------------


def gru_from_torch(sd: Dict, prefix: str, num_layers: int, bidirectional: bool = True, bias: bool = True,
                   hidden_start: torch.Tensor = None) -> dict:
    sd = _sd(sd)
    p = prefix + "." if prefix else ""
    layers = []
    for layer in range(num_layers):
        directions = []
        for sfx in (["", "_reverse"] if bidirectional else [""]):
            d = {"w_ih": _t(sd[f"{p}weight_ih_l{layer}{sfx}"]), "w_hh": _t(sd[f"{p}weight_hh_l{layer}{sfx}"])}
            if bias:
                d["b_ih"] = sd[f"{p}bias_ih_l{layer}{sfx}"]
                d["b_hh"] = sd[f"{p}bias_hh_l{layer}{sfx}"]
            directions.append(d)
        layers.append({"directions": directions})
    params = {"layers": layers}
    if hidden_start is not None:
        params["hidden_start"] = hidden_start
    return params


# --- Wav2Vec2 encoder --------------------------------------------------------


def weight_norm_conv_from_torch(sd: Dict, prefix: str) -> dict:
    """The positional conv with torch weight_norm(dim=2), kept as (g, v).
    A module loaded by transformers names them
    parametrizations.weight.original0 / original1; the checkpoint files
    (pytorch_model.bin, model.safetensors) weight_g / weight_v."""
    sd = _sd(sd)
    if f"{prefix}.parametrizations.weight.original0" in sd:
        g = sd[f"{prefix}.parametrizations.weight.original0"]
        v = sd[f"{prefix}.parametrizations.weight.original1"]
    else:
        g = sd[f"{prefix}.weight_g"]
        v = sd[f"{prefix}.weight_v"]
    return {"weight_g": g, "weight_v": v, "bias": sd[f"{prefix}.bias"]}


def layer_norm_from_torch(sd: Dict, prefix: str) -> dict:
    sd = _sd(sd)
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def w2v_encoder_layer_from_torch(sd: Dict, prefix: str) -> dict:
    sd = _sd(sd)
    attn = f"{prefix}.attention"
    ff = f"{prefix}.feed_forward"
    return {
        "attention": {name: linear_from_torch(sd, f"{attn}.{name}")
                      for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
        "layer_norm": layer_norm_from_torch(sd, f"{prefix}.layer_norm"),
        "feed_forward": {name: linear_from_torch(sd, f"{ff}.{name}")
                         for name in ("intermediate_dense", "output_dense")},
        "final_layer_norm": layer_norm_from_torch(sd, f"{prefix}.final_layer_norm"),
    }


def w2v_encoder_from_torch(sd: Dict, prefix: str, num_layers: int) -> dict:
    sd = _sd(sd)
    p = prefix + "." if prefix else ""
    return {
        "pos_conv": weight_norm_conv_from_torch(sd, f"{p}pos_conv_embed.conv"),
        "layer_norm": layer_norm_from_torch(sd, f"{p}layer_norm"),
        "layers": [w2v_encoder_layer_from_torch(sd, f"{p}layers.{i}") for i in range(num_layers)],
    }


# --- Wav2Vec2-Conformer encoder ----------------------------------------------


def conformer_layer_from_torch(sd: Dict, prefix: str) -> dict:
    sd = _sd(sd)
    conv = f"{prefix}.conv_module"

    def ffn(name):
        return {k: linear_from_torch(sd, f"{prefix}.{name}.{k}") for k in ("intermediate_dense", "output_dense")}

    params = {
        "ffn1_layer_norm": layer_norm_from_torch(sd, f"{prefix}.ffn1_layer_norm"),
        "ffn1": ffn("ffn1"),
        "self_attn_layer_norm": layer_norm_from_torch(sd, f"{prefix}.self_attn_layer_norm"),
        "self_attn": {name: linear_from_torch(sd, f"{prefix}.self_attn.{name}")
                      for name in ("linear_q", "linear_k", "linear_v", "linear_out")},
        "conv_module": {
            "layer_norm": layer_norm_from_torch(sd, f"{conv}.layer_norm"),
            # torch conv1d weights: pw (2C, C, 1) / dw (C, 1, k) / pw2 (C, C, 1)
            "pointwise_conv1": {"kernel": _t(sd[f"{conv}.pointwise_conv1.weight"][:, :, 0])},
            # (C, 1, k) -> (k, 1, C)
            "depthwise_conv": {"kernel": sd[f"{conv}.depthwise_conv.weight"].permute(2, 1, 0).contiguous()},
            "batch_norm": {"scale": sd[f"{conv}.batch_norm.weight"],
                           "bias": sd[f"{conv}.batch_norm.bias"]},
            "pointwise_conv2": {"kernel": _t(sd[f"{conv}.pointwise_conv2.weight"][:, :, 0])},
        },
        "ffn2_layer_norm": layer_norm_from_torch(sd, f"{prefix}.ffn2_layer_norm"),
        "ffn2": ffn("ffn2"),
        "final_layer_norm": layer_norm_from_torch(sd, f"{prefix}.final_layer_norm"),
    }
    # relative position embedding variant (not used by the rope checkpoint)
    if f"{prefix}.self_attn.linear_pos.weight" in sd:
        params["self_attn"]["linear_pos"] = {"kernel": _t(sd[f"{prefix}.self_attn.linear_pos.weight"])}
        params["self_attn"]["pos_bias_u"] = sd[f"{prefix}.self_attn.pos_bias_u"]
        params["self_attn"]["pos_bias_v"] = sd[f"{prefix}.self_attn.pos_bias_v"]
    return params


def conformer_encoder_from_torch(sd: Dict, prefix: str, num_layers: int) -> dict:
    sd = _sd(sd)
    p = prefix + "." if prefix else ""
    return {
        # pos_conv_embed exists in the HF module but is never applied in its
        # forward; kept for checkpoint parity, masked from optimization.
        "pos_conv": weight_norm_conv_from_torch(sd, f"{p}pos_conv_embed.conv"),
        "layer_norm": layer_norm_from_torch(sd, f"{p}layer_norm"),
        "layers": [conformer_layer_from_torch(sd, f"{p}layers.{i}") for i in range(num_layers)],
    }


def conformer_batch_norm_state_from_torch(sd: Dict, prefix: str, num_layers: int) -> dict:
    sd = _sd(sd)
    p = prefix + "." if prefix else ""
    bn = [f"{p}layers.{i}.conv_module.batch_norm" for i in range(num_layers)]
    return {"layers": [{"batch_norm": {"mean": sd[f"{b}.running_mean"], "var": sd[f"{b}.running_var"]}}
                       for b in bn]}


# --- reference brain encoder (B2P2TModel + FC/GRU) ----------------------------


def brain_encoder_from_torch(sd: Dict) -> dict:
    """A reference `brain_encoder.pt` state dict (B2P2TModel(
    B2TBrainFeatureExtractor)) -> the port's params["brain"] subtree.

    GRU geometry is inferred from the key names and shapes. The 24 dead
    `inpLayer{i}` Linears are carried into the parity slot; keys named
    `discriminator` / `suc_for_ctc` are dropped like the reference's
    partial load."""
    sd = StateDict({k: v for k, v in _sd(sd).items()
                    if not (k.startswith("discriminator") or k.startswith("suc_for_ctc"))})
    g = "neural_decoder.encoder.gru"
    num_layers = 0
    while f"{g}.weight_ih_l{num_layers}" in sd:
        num_layers += 1
    if num_layers == 0:
        raise KeyError("no GRU weights found under neural_decoder.encoder.gru")
    bidirectional = f"{g}.weight_ih_l0_reverse" in sd
    bias = f"{g}.bias_ih_l0" in sd
    hidden_start = sd.get("neural_decoder.encoder.hidden_start")
    if hidden_start is not None:
        # torch stores (L*D, 1, H); ours is (L*D, H)
        hidden_start = hidden_start.reshape(hidden_start.shape[0], -1)
    gru = gru_from_torch(sd, g, num_layers, bidirectional, bias, hidden_start)

    n_fc = sum(1 for k in sd if k.startswith("neural_decoder.encoder.fc.") and k.endswith(".weight"))
    fc = fc_from_torch(sd, "neural_decoder.encoder.fc", n_fc)

    n_days = sd["day_weights"].shape[0]
    return {
        "preproc": {
            "day_weights": sd["day_weights"],
            "day_bias": sd["day_bias"],
            "inp_layers": {"weight": torch.stack([sd[f"inpLayer{i}.weight"] for i in range(n_days)]),
                           "bias": torch.stack([sd[f"inpLayer{i}.bias"] for i in range(n_days)])},
        },
        "gru": gru,
        "fc": fc,
    }


def full_model_from_torch(sd: Dict, encoder_family: str, num_layers: int):
    """A reference full-model state dict (W2VBrainEncoderModel /
    W2VConformerBrainEncoderModel) -> (params, state).

    Key layout: brain_encoder.* (B2P2TModel), w2v_encoder.{wav2vec2|
    wav2vec2_conformer}.encoder.*, w2v_encoder.lm_head.*."""
    sd = _sd(sd)
    brain = brain_encoder_from_torch({k[len("brain_encoder."):]: v for k, v in sd.items()
                                      if k.startswith("brain_encoder.")})
    if encoder_family == "conformer":
        enc_prefix = "w2v_encoder.wav2vec2_conformer.encoder"
        encoder = conformer_encoder_from_torch(sd, enc_prefix, num_layers)
        state = {"encoder": conformer_batch_norm_state_from_torch(sd, enc_prefix, num_layers)}
    else:
        encoder = w2v_encoder_from_torch(sd, "w2v_encoder.wav2vec2.encoder", num_layers)
        state = {"encoder": {}}
    head = linear_from_torch(sd, "w2v_encoder.lm_head")
    return {"brain": brain, "w2v": {"encoder": encoder, "lm_head": head}}, state
