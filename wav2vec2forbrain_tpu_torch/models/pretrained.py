"""Encoder configs of the supported pretrained checkpoints (counterpart of
wav2vec2forbrain_tpu/models/pretrained.py::encoder_config_for_checkpoint).

The config only, offline: loading a checkpoint's pretrained weights needs
files from outside the repository and is not ported; the port's CLI runs
with --w2v_skip_loading_weights=true.
"""

from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig


def encoder_config_for_checkpoint(checkpoint: str):
    """(family, config) for a checkpoint name."""
    if "conformer" in checkpoint:
        return "conformer", ConformerEncoderConfig.rope_large_960h()
    if "base" in checkpoint:
        return "wav2vec2", Wav2Vec2EncoderConfig.base_960h()
    return "wav2vec2", Wav2Vec2EncoderConfig.large_960h()
