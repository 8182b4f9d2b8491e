"""Experiment registry (counterpart of wav2vec2forbrain_tpu/experiments/registry.py).

The two live experiment types; every other `experiment_type` choice raises
KeyError at dispatch, as in the JAX package. The experiment classes load
lazily, so the flags stay importable without building anything.
"""

from wav2vec2forbrain_tpu_torch.args.flags import B2TGruAndW2VArgsModel, B2TGruAndW2VConformerArgsModel


class _LazyRegistry(dict):
    def __missing__(self, key):
        raise KeyError(key)


class _Lazy:
    def __init__(self, class_name: str, args_model):
        self._class_name = class_name
        self._args_model = args_model

    def get_args_model(self):
        return self._args_model

    def __call__(self, *args, **kwargs):
        from wav2vec2forbrain_tpu_torch.experiments import impl

        return getattr(impl, self._class_name)(*args, **kwargs)


experiments = _LazyRegistry(
    {
        "b2p2t_gru+w2v": _Lazy("B2TGruAndW2VExperiment", B2TGruAndW2VArgsModel),
        "b2p2t_gru+w2v_conformer": _Lazy("B2TGruAndW2VConformerExperiment", B2TGruAndW2VConformerArgsModel),
    }
)
