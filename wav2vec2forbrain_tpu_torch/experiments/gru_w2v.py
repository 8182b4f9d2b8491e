"""b2p2t_gru+w2v (counterpart of wav2vec2forbrain_tpu/experiments/gru_w2v.py)."""

from wav2vec2forbrain_tpu_torch.args.flags import B2TGruAndW2VArgsModel
from wav2vec2forbrain_tpu_torch.experiments.impl import B2TGruAndW2VExperiment

__all__ = ["B2TGruAndW2VArgsModel", "B2TGruAndW2VExperiment"]
