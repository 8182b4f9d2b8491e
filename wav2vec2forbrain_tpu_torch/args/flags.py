"""The experiment CLI's flags as dataclasses (counterpart of the pydantic
models in wav2vec2forbrain_tpu/args/base_args.py, models/configs.py and
experiments/args_models.py).

The GPU machine has no pydantic, so the port keeps a mirror: the same field
names, defaults, `Literal` choices and `Optional`s, in the same order
(dataclass fields, like pydantic's, are collected over the reversed MRO).
`validate(model, config)` does what `Model(**config)` does in the JAX
package: it coerces each value as pydantic's lax mode does (a string that
argparse passed for a `Union` flag such as `--multi_step_chunk=32` becomes
32, `"auto"` stays `"auto"`), rejects what pydantic rejects, ignores keys
that are not fields, and runs the `pallas_kernels` check against the port's
ops/select.py. tests/test_torch_args.py holds every field to the pydantic
models.
"""

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import List, Literal, Optional, Union

from wav2vec2forbrain_tpu_torch.ops.select import validate_kernel_policy

# Latent sizes of the supported pretrained wav2vec2 checkpoints.
PRETRAINED_LATENT_SIZES = {
    "jonatasgrosman/wav2vec2-large-xlsr-53-english": 1024,
    "facebook/wav2vec2-base-960h": 768,
    "facebook/wav2vec2-large-960h": 1024,
    "facebook/wav2vec2-conformer-rope-large-960h-ft": 1024,
    "facebook/wav2vec2-lv-60-espeak-cv-ft": 1024,
}

PreprocessingName = Literal[
    "competition_recommended",
    "seperate_zscoring",
    "only_tx_unnormalized",
    "only_tx_zscored",
    "only_spikepow_unnormalized",
    "only_spikepow_zscored",
    "seperate_zscoring_2channels",
    "seperate_zscoring_4channels",
]

ExperimentType = Literal[
    "audio_wav2vec2",
    "b2t_audio_wav2vec",
    "onehot_index",
    "b2t_cnn",
    "b2t_gru",
    "b2t_gru+trafo",
    "mvts_transformer",
    "b2t_mamba",
    "ctc_lm",
    "b2t_ctc_lm_mamba_finetuning",
    "b2p2t_mamba",
    "b2p2t_gru",
    "b2p2t_mvtst",
    "timit_w2v_suc",
    "timit_w2v_suc_ctc",
    "b2p_suc",
    "discriminator",
    "b2p2t_gru+w2v",
    "b2p2t_phonemegru+w2v",
    "b2p2t_gru+w2v_conformer",
    "b2p2t_gru_w2vphoneme",
    "a2p_w2vphoneme_head",
    "a2t_w2vphoneme_head",
    "b2p_w2vphoneme_head",
]

ACTIVATION_FUNCTION = Literal[
    "gelu",
    "gelu_10",
    "gelu_fast",
    "gelu_new",
    "gelu_python",
    "gelu_pytorch_tanh",
    "gelu_accurate",
    "laplace",
    "linear",
    "mish",
    "quick_gelu",
    "relu",
    "relu2",
    "relu6",
    "sigmoid",
    "silu",
    "swish",
    "tanh",
]

DEFAULT_UNFOLDER_KERNEL_LEN = 32
# pyctcdecode's defaults
DEFAULT_BEAM_WIDTH = 100
DEFAULT_PRUNE_LOGP = -10.0
DEFAULT_MIN_TOKEN_LOGP = -5.0


@dataclass
class B2TDatasetArgsModel:
    preprocessing: PreprocessingName = "seperate_zscoring"
    competition_mode: bool = False
    limit_samples: Optional[int] = None
    sample_rate: int = 50
    remove_punctuation: bool = True
    area: Literal["6v", "44"] = "6v"


@dataclass
class CTCTextDatasetArgsModel:
    """Flags of the reference's synthetic CTC-text corruption dataset (ref:
    src/args/base_args.py:34-48): no registered experiment reads them, in
    the reference, the JAX package or the port; kept with the same names
    and defaults."""

    limit_samples: Optional[int] = None
    train_ratio: float = 0.8
    val_ratio: float = 0.1
    test_ratio: float = 0.1
    avg_num_blank_after_char: int = 6
    insert_wrong_char_prob: float = 0.05
    remove_char_prob: float = 0.05
    noise_mean: float = -16
    noise_std: float = 2
    correct_as_second_prob: float = 0.2
    random_second_id_in_blank_prob: float = 0.1
    cache_generated_samples: bool = False
    remove_punctuation: bool = True


@dataclass
class BaseExperimentArgsModel:
    batch_size: int = 16
    epochs: int = 10
    learning_rate: float = 0.001
    optimizer: Literal["adam", "sgd"] = "adam"
    loss_function: Literal[
        "ctc",
        "contrastive_loss",
        "cross_entropy",
        "bce",
        "ctc+discriminator",
        "combined_ctc",
    ] = "ctc"
    ctc_loss_reduction: Literal["sum", "mean"] = "mean"
    experiment_name: str = "experiment_1"
    experiment_type: ExperimentType = "b2p2t_gru+w2v"
    log_every_n_batches: int = 10
    scheduler: Literal["step"] = "step"
    scheduler_step_size: int = 10
    scheduler_gamma: float = 0.1
    return_best_model: bool = True
    best_model_metric: str = "loss"
    minimize_best_model_metric: bool = True
    use_wandb: bool = False
    from_checkpoint: Optional[str] = None
    only_test: bool = False
    predict_on_train: bool = False
    gradient_clipping: Optional[float] = None
    weight_decay: float = 0.0
    visualize_predictions_n_batches: int = 1
    use_fast_tokenizer: bool = False
    use_prefix_beam_search: bool = True
    beam_search_language_model: str = "openai-community/gpt2"
    whiteNoiseSD: float = 0.0
    constantOffsetSD: float = 0.0
    seed: int = 42
    optimizer_epsilon: float = 1e-8
    early_stopping_patience: Optional[int] = None
    early_stopping_delta: float = 0.0001
    train_on_val_once: bool = False
    log_results_as_artifact: bool = False
    results_subdir_name: Optional[str] = None
    pad_to_multiple: int = 1
    target_pad_to_multiple: int = 1
    compute_dtype: Literal["float32", "bfloat16"] = "float32"
    activation_dtype: Literal["float32", "bfloat16"] = "float32"
    mesh_data_parallel: int = 0
    mesh_model_parallel: int = 1
    use_pallas: bool = False
    pallas_kernels: str = "auto"
    scan_layers: Union[bool, Literal["auto"]] = "auto"
    host_prefetch: bool = True
    device_data_cache: Literal["auto", "on", "off"] = "auto"
    multi_step_chunk: Union[int, Literal["auto", "off"]] = "auto"
    length_bucket_order: Literal["preserve", "grouped"] = "preserve"
    precompile_buckets: bool = True
    length_sorted_batches: bool = False
    length_buckets: Union[int, Literal["off", "exact"]] = "off"
    device_data_cache_max_bytes: int = 1_500_000_000
    optimizer_state_sharding: Literal["replicated", "zero1"] = "replicated"
    adam_mu_dtype: Literal["float32", "bfloat16"] = "float32"
    adam_nu_dtype: Literal["float32", "bfloat16"] = "float32"
    h2d_dtype: Literal["float32", "float16", "bfloat16"] = "float32"
    remat_policy: Literal["auto", "min", "dots", "dots_nowide", "blocks", "all_but_wide", "none"] = "auto"
    checkpoint_every_n_epochs: Optional[int] = None
    resume_train_state: Optional[str] = None
    greedy_decode_crop_lens: bool = False
    store_final_model: bool = True

    def __post_init__(self):
        validate_kernel_policy(self.pallas_kernels)


@dataclass
class B2P2TModelArgsModel:
    input_layer_nonlinearity: Literal["softsign"] = "softsign"
    unfolder_kernel_len: int = DEFAULT_UNFOLDER_KERNEL_LEN
    unfolder_stride_len: int = 4
    gaussian_smooth_width: float = 0.3


@dataclass
class BrainFeatureExtractorArgsModel:
    encoder_gru_hidden_size: int = 256
    encoder_bidirectional: bool = True
    encoder_num_gru_layers: int = 2
    encoder_bias: bool = True
    encoder_dropout: float = 0.0
    encoder_learnable_inital_state: bool = False
    encoder_fc_hidden_sizes: List[int] = field(default_factory=list)
    encoder_fc_activation_function: ACTIVATION_FUNCTION = "gelu"


@dataclass
class B2P2TBrainFeatureExtractorArgsModel(BrainFeatureExtractorArgsModel, B2P2TModelArgsModel):
    pass


@dataclass
class W2VBrainEncoderModelArgs:
    w2v_do_stable_layer_norm: bool = False


@dataclass
class B2TArgsModel(BaseExperimentArgsModel, B2TDatasetArgsModel):
    tokenizer: Literal["wav2vec_pretrained", "ours"] = "wav2vec_pretrained"
    tokenizer_checkpoint: str = "facebook/wav2vec2-base-100h"
    day_batches: bool = False


@dataclass
class _GruW2VCommonArgs(B2TArgsModel, B2P2TBrainFeatureExtractorArgsModel):
    brain_encoder_path: Optional[str] = None
    unfreeze_strategy: Literal["brain_encoder", "brain_encoder+w2v"] = "brain_encoder"
    w2v_learning_rate: Optional[float] = None
    w2v_warmup_start_step: Optional[int] = None
    w2v_warmup_steps: Optional[int] = None
    lm_decode_test_predictions: bool = False
    adjust_global_lr_to_w2v_postwarmup_lr: Optional[bool] = None
    lm_decode_beam_width: int = DEFAULT_BEAM_WIDTH
    lm_decode_beam_prune_logp: float = DEFAULT_PRUNE_LOGP
    lm_decode_token_min_logp: float = DEFAULT_MIN_TOKEN_LOGP
    lm_decode_alpha: float = 0.5
    lm_decode_beta: float = 0.5
    lm_score_boundary: bool = False
    aux_head_vocab_size: Optional[int] = None
    additional_loss_weight: Optional[float] = None
    additional_loss_squared: Optional[bool] = None


@dataclass
class B2TGruAndW2VArgsModel(_GruW2VCommonArgs, W2VBrainEncoderModelArgs):
    wav2vec_checkpoint: str = "facebook/wav2vec2-base-960h"
    w2v_skip_loading_weights: bool = False
    store_brain_encoder: bool = False


@dataclass
class B2TGruAndW2VConformerArgsModel(_GruW2VCommonArgs):
    wav2vec_checkpoint: str = "facebook/wav2vec2-conformer-rope-large-960h-ft"
    w2v_skip_loading_weights: bool = False


# --- pydantic's lax-mode coercion -----------------------------------------------------

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _is_optional(annotation) -> bool:
    return typing.get_origin(annotation) is Union and type(None) in typing.get_args(annotation)


def unwrap_optional(annotation):
    """Optional[X] -> X (other annotations unchanged)."""
    if _is_optional(annotation):
        rest = [a for a in typing.get_args(annotation) if a is not type(None)]
        if len(rest) == 1:
            return rest[0]
        return Union[tuple(rest)]
    return annotation


def _exact(annotation, value):
    """(True, value) where pydantic's strict pass takes value as it is."""
    origin = typing.get_origin(annotation)
    if origin is Literal:
        return (value in typing.get_args(annotation) and isinstance(value, str)), value
    if annotation is bool:
        return isinstance(value, bool), value
    if annotation is int:
        return isinstance(value, int) and not isinstance(value, bool), value
    if annotation is float:
        return isinstance(value, float), value
    if annotation is str:
        return isinstance(value, str), value
    return False, value


def _lax(annotation, value):
    """value coerced as pydantic's lax mode does; raises ValueError where it
    would refuse."""
    origin = typing.get_origin(annotation)
    if origin is Literal:
        if value in typing.get_args(annotation):
            return value
    elif annotation is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.strip().lower() in _TRUE | _FALSE:
            return value.strip().lower() in _TRUE
    elif annotation is int:
        if isinstance(value, int):
            return int(value)
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str):
            try:
                return int(value.strip())
            except ValueError:
                pass
    elif annotation is float:
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value.strip())
            except ValueError:
                pass
    elif annotation is str:
        if isinstance(value, str):
            return value
    elif origin in (list, List):
        if isinstance(value, (list, tuple)):
            (item,) = typing.get_args(annotation) or (typing.Any,)
            return [v if item is typing.Any else coerce(item, v) for v in value]
    elif origin is Union:
        members = typing.get_args(annotation)
        for m in members:
            ok, v = _exact(m, value)
            if ok:
                return v
        for m in members:
            try:
                return _lax(m, value)
            except ValueError:
                continue
    raise ValueError(f"{value!r} is not a valid {annotation}")


def coerce(annotation, value):
    """value as pydantic validates it against annotation."""
    if value is None:
        if _is_optional(annotation):
            return None
        raise ValueError(f"None is not a valid {annotation}")
    return _lax(unwrap_optional(annotation), value)


def defaults_of(model) -> dict:
    """{field name: default} of a flags dataclass."""
    out = {}
    for f in dataclasses.fields(model):
        out[f.name] = f.default_factory() if f.default is dataclasses.MISSING else f.default
    return out


def validate(model, config: dict):
    """model(**config) with pydantic's coercion; keys that are not fields
    are ignored, as a pydantic model ignores them."""
    kwargs, errors = {}, []
    for f in dataclasses.fields(model):
        if f.name not in config:
            continue
        try:
            kwargs[f.name] = coerce(f.type, config[f.name])
        except ValueError as e:
            errors.append(f"{f.name}: {e}")
    if errors:
        raise ValueError(f"{model.__name__}: " + "; ".join(errors))
    return model(**kwargs)

