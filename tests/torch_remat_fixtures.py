"""Tiny train steps for the remat tests (a helper module, not collected as
tests; it imports no jax, so the ranks of tests/test_torch_remat.py start
quickly): each family's tiny spec under a remat policy, a batch, and a
step's streams with replayed encoder seeds and a LayerDrop mask, and a
RematAuto whose footprints are made up."""

import numpy as np
import torch

from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch, to_device
from wav2vec2forbrain_tpu_torch.models import assembly
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.models.seeds import ForwardRng, SeedStream, StepRng
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig
from wav2vec2forbrain_tpu_torch.train.steps import RematAuto

N_LAYERS = 3
DROPPED = 1  # the layer the replayed LayerDrop mask drops


def tiny_spec(family: str, policy: str = "none") -> assembly.ModelSpec:
    """conformer, w2v (post-LN) or w2v_stable: 3 tiny_test layers, every
    dropout at tiny_test's 0.1, biGRU 2 x 32 with dropout 0.1."""
    if family == "conformer":
        enc = dict(conformer_cfg=ConformerEncoderConfig.tiny_test(num_hidden_layers=N_LAYERS, hidden_act="swish"))
    else:
        enc = dict(encoder_family="wav2vec2", w2v_cfg=Wav2Vec2EncoderConfig.tiny_test(
            num_hidden_layers=N_LAYERS, do_stable_layer_norm=family == "w2v_stable"))
    return assembly.ModelSpec(gru_hidden_size=32, gru_num_layers=2, gru_dropout=0.1, latent_size=96,
                              remat_policy=policy, **enc)


def tiny_batch(rows: int = 3) -> B2tBatch:
    """A seeded batch of 3 trials (80, 64 and 52 frames) on the CPU; rows > 3
    repeats the first trials as padding rows."""
    rng = np.random.default_rng(3)
    t = 80
    lens = np.array([80, 64, 52], np.int32)
    x = rng.standard_normal((3, t, 256)).astype(np.float32)
    x[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    batch = B2tBatch(input=x, target=np.array([[5, 6, 7], [8, 9, 0], [4, 0, 0]], np.int32),
                     day_idxs=np.array([0, 3, 5], np.int32), input_lens=lens, target_lens=np.array([3, 2, 1], np.int32))
    idx = np.arange(rows) % 3
    return to_device(B2tBatch(*(None if a is None else a[idx] for a in batch)), "cpu")


def replayed_rng(steps: int = 1) -> StepRng:
    """Each step's streams: the encoder's replays seeds and a LayerDrop mask
    that drops layer DROPPED; the GRU's and the head's from generators."""
    rs = np.random.default_rng(11)
    forwards = []
    for step in range(steps):
        enc = SeedStream(seeds=rs.integers(0, 2**31 - 1, 256).tolist(),
                         layerdrop=[[i == DROPPED for i in range(N_LAYERS)]])
        forwards.append(ForwardRng(SeedStream(torch.Generator().manual_seed(1 + 2 * step)), enc,
                                   SeedStream(torch.Generator().manual_seed(2 + 2 * step))))
    return StepRng(device="cpu", replay=forwards)


class FootprintAuto(RematAuto):
    """RematAuto on the CPU: a step under a policy peaks at needs[policy]
    bytes; `frees` counts the failed steps it freed."""

    def __init__(self, budget: float, needs: dict):
        super().__init__(budget, torch.device("cpu"))
        self.needs, self.frees = needs, 0

    def reset_peak(self) -> None:
        pass

    def peak(self) -> int:
        return self.needs[self.policy]

    def free(self) -> None:
        self.frees += 1
