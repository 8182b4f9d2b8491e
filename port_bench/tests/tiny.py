"""Tiny cells for the CPU tests (a helper module, not collected): the two
configurations' files with their widths cut to `tiny_test()` sizes, tiny
traffic, and a context that makes the program resolve its checkpoints to
the same tiny encoders."""

import contextlib
import copy
import json
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
CONFORMER_CKPT = "facebook/wav2vec2-conformer-rope-large-960h-ft"
W2V_CKPT = "facebook/wav2vec2-base-960h"
TINY_ENCODER = dict(hidden_size=96, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
                    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
TINY_TRAFFIC = dict(sessions=2, trials_per_session=12, min_frames=60, max_frames=126, area_channels=128)


def config(family: str, layerdrop: float = 0.5) -> dict:
    name = "conformer-rope-large" if family == "conformer" else "w2v-base-fft"
    with open(PB / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg["encoder"].update(TINY_ENCODER, layerdrop=layerdrop)
    cfg["brain"]["gru_hidden_size"] = 32
    cfg["flags"].update(batch_size=4, encoder_gru_hidden_size=32)
    return cfg


def traffic(kind: str) -> dict:
    name = "train-streamed" if kind == "train" else "serve-streamed"
    with open(PB / "traffic" / f"{name}.json") as f:
        t = json.load(f)
    t.update(TINY_TRAFFIC, blocks_per_session=2)
    return t


def cell(family: str, kind: str, limits=None):
    from port_bench.harness import Cell

    lim = limits or ({"loss_rel": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-2} if kind == "train"
                     else {"logit_gap": 1e-4, "logit_rel": 1e-4, "lens_mismatch": 0.0})
    return Cell(f"{family}.{kind}", config(family), traffic(kind), lim)


@contextlib.contextmanager
def tiny_program(cfg: dict):
    """The program resolves both checkpoints to `cfg`'s encoder widths."""
    from wav2vec2forbrain_tpu_torch.args import flags
    from wav2vec2forbrain_tpu_torch.models import pretrained
    from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
    from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig

    enc = copy.deepcopy(cfg["encoder"])

    def resolve(checkpoint):
        if "conformer" in checkpoint:
            fields = {k: v for k, v in enc.items() if k in ConformerEncoderConfig.__dataclass_fields__}
            return "conformer", ConformerEncoderConfig(**fields)
        fields = {k: v for k, v in enc.items() if k in Wav2Vec2EncoderConfig.__dataclass_fields__}
        return "wav2vec2", Wav2Vec2EncoderConfig(**fields)

    saved = pretrained.encoder_config_for_checkpoint, dict(flags.PRETRAINED_LATENT_SIZES)
    pretrained.encoder_config_for_checkpoint = resolve
    flags.PRETRAINED_LATENT_SIZES.update({CONFORMER_CKPT: enc["hidden_size"], W2V_CKPT: enc["hidden_size"]})
    try:
        yield
    finally:
        pretrained.encoder_config_for_checkpoint = saved[0]
        flags.PRETRAINED_LATENT_SIZES.clear()
        flags.PRETRAINED_LATENT_SIZES.update(saved[1])
