"""Pretrained HF encoders -> the port's param trees (counterpart of
wav2vec2forbrain_tpu/models/pretrained.py).

Supported checkpoint families:
- facebook/wav2vec2-base-960h        (post-LN, 12 layers, 768)
- facebook/wav2vec2-large-960h       (pre-LN "stable", 24 layers, 1024)
- facebook/wav2vec2-conformer-rope-large-960h-ft (conformer RoPE, 24, 1024)

`load_pretrained_encoder` converts a checkpoint's HF state dict once
(models/hf_snapshot.py reads it offline from the hub cache,
models/convert.py maps it) and caches the result where the JAX package
does, in the same bytes: `<cache_dir>/converted_encoders/<org>--<name>
.msgpack`, a flax msgpack of {"encoder", "lm_head", "state"} (lists as
{"0": ...} maps). So a cache written on a TPU machine is read on the card,
and the reverse. Later constructions read only the cache.
"""

import os
from typing import Optional, Tuple

from wav2vec2forbrain_tpu_torch.models import convert, hf_snapshot
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig
from wav2vec2forbrain_tpu_torch.train.msgpack_codec import read_msgpack, relistify, to_state_dict, write_msgpack


def encoder_config_for_checkpoint(checkpoint: str):
    """(family, config) for a checkpoint name."""
    if "conformer" in checkpoint:
        return "conformer", ConformerEncoderConfig.rope_large_960h()
    if "base" in checkpoint:
        return "wav2vec2", Wav2Vec2EncoderConfig.base_960h()
    return "wav2vec2", Wav2Vec2EncoderConfig.large_960h()


def converted_cache_path(checkpoint: str, cache_dir: Optional[str]) -> str:
    root = cache_dir or os.path.expanduser("~/.cache/wav2vec2forbrain_tpu")
    return os.path.join(root, "converted_encoders", checkpoint.replace("/", "--") + ".msgpack")


def load_pretrained_encoder(checkpoint: str, cache_dir: Optional[str] = None) -> Tuple[dict, dict, dict]:
    """(encoder params, lm_head params, state) of the checkpoint as CPU
    tensor trees: from the converted cache where it exists, else converted
    from the HF snapshot in `cache_dir`'s hub cache and cached."""
    path = converted_cache_path(checkpoint, cache_dir)
    if os.path.exists(path):
        bundle = relistify(read_msgpack(path))
        return bundle["encoder"], bundle["lm_head"], bundle["state"]
    enc, head, state = convert_from_hf(checkpoint, cache_dir)
    write_msgpack(path, to_state_dict({"encoder": enc, "lm_head": head, "state": state}))
    return enc, head, state


def convert_from_hf(checkpoint: str, cache_dir: Optional[str] = None) -> Tuple[dict, dict, dict]:
    """The one-time HF state dict -> tree conversion (the JAX package's
    _convert_from_hf, whose from_pretrained is hf_snapshot here)."""
    family, cfg = encoder_config_for_checkpoint(checkpoint)
    sd = convert.StateDict(hf_snapshot.read_state_dict(checkpoint, cache_dir))
    if family == "conformer":
        prefix = "wav2vec2_conformer.encoder"
        enc = convert.conformer_encoder_from_torch(sd, prefix, cfg.num_hidden_layers)
        state = {"encoder": convert.conformer_batch_norm_state_from_torch(sd, prefix, cfg.num_hidden_layers)}
    else:
        enc = convert.w2v_encoder_from_torch(sd, "wav2vec2.encoder", cfg.num_hidden_layers)
        state = {"encoder": {}}
    head = convert.linear_from_torch(sd, "lm_head")
    return enc, head, state
