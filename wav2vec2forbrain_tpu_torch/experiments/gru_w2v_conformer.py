"""b2p2t_gru+w2v_conformer (counterpart of
wav2vec2forbrain_tpu/experiments/gru_w2v_conformer.py)."""

from wav2vec2forbrain_tpu_torch.args.flags import B2TGruAndW2VConformerArgsModel
from wav2vec2forbrain_tpu_torch.experiments.impl import B2TGruAndW2VConformerExperiment

__all__ = ["B2TGruAndW2VConformerArgsModel", "B2TGruAndW2VConformerExperiment"]
