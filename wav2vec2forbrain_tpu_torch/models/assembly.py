"""B2P2T brain encoder + Wav2Vec2(-Conformer) model assembly (counterpart of
wav2vec2forbrain_tpu/models/assembly.py).

Parameters are nested dicts of tensors with the JAX package's structure and
key names, so they cross the bridge (bridge.py) unchanged:

    params = {
      "brain": {"preproc": ..., "gru": ..., "fc": ...},
      "w2v":   {"encoder": ..., "lm_head": ...},
    }
    state  = {"encoder": {"layers": [{"batch_norm": {"mean", "var"}}, ...]}}
             ({"encoder": {}} for the wav2vec2 family, which has no BatchNorm)

Two encoder families, as in the JAX package (spec.encoder_family):
"conformer" (the port's default: b2p2t_gru+w2v_conformer) and "wav2vec2"
(b2p2t_gru+w2v: the post-LN or stable pre-LN Wav2Vec2 encoder). Eval and
train mode, the aux head and the extras. Train mode takes its dropout seeds
and LayerDrop decisions from a ForwardRng (models/seeds.py): the GRU,
encoder and head streams.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from wav2vec2forbrain_tpu_torch.models.conformer import (
    ConformerEncoderConfig,
    apply_conformer_encoder,
    init_conformer_encoder_params,
    init_conformer_state,
)
from wav2vec2forbrain_tpu_torch.models.fc import apply_fc, apply_linear, init_fc, init_linear
from wav2vec2forbrain_tpu_torch.models.gru import apply_gru, init_gru_params
from wav2vec2forbrain_tpu_torch.models.preprocessing import (
    GAUSS_KERNEL_SIZE,
    apply_preproc,
    gaussian_kernel,
    in_size_after_preprocessing,
    init_preproc_params,
)
from wav2vec2forbrain_tpu_torch.models.seeds import ForwardRng
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import (
    Wav2Vec2EncoderConfig,
    apply_lm_head,
    apply_w2v_encoder,
    dropout_site,
    init_lm_head_params,
    init_w2v_encoder_params,
)
from wav2vec2forbrain_tpu_torch.ops.ctc import ctc_loss
from wav2vec2forbrain_tpu_torch.ops.preproc import apply_preproc_fused
from wav2vec2forbrain_tpu_torch.ops.select import kernel_enabled
from wav2vec2forbrain_tpu_torch.parallel import distributed
from wav2vec2forbrain_tpu_torch.tree import tree_map


@dataclass
class ModelSpec:
    """Static model description (the JAX ModelSpec's fields the port uses).

    The defaults are b2p2t_gru+w2v_conformer at full width: biGRU 2 x 256,
    FC to 1024, Wav2Vec2-Conformer-RoPE-large (24 layers, d=1024, 16 heads,
    FFN 4096, depthwise kernel 31, swish), 32-symbol CTC head. With
    encoder_family "wav2vec2" the encoder is w2v_cfg (default base-960h:
    12 post-LN layers, d=768, 12 heads, FFN 3072); set latent_size to its
    hidden size."""

    # preprocessing
    unfolder_kernel_len: int = 32
    unfolder_stride_len: int = 4
    gaussian_smooth_width: float = 0.3
    # brain feature extractor
    gru_hidden_size: int = 256
    gru_bidirectional: bool = True
    gru_num_layers: int = 2
    gru_bias: bool = True
    gru_dropout: float = 0.0
    gru_learnable_initial_state: bool = False
    fc_hidden_sizes: Tuple[int, ...] = ()
    fc_activation: str = "gelu"
    latent_size: int = 1024
    # encoder family: "conformer" or "wav2vec2", and its config
    encoder_family: str = "conformer"
    w2v_cfg: Optional[Wav2Vec2EncoderConfig] = None
    conformer_cfg: Optional[ConformerEncoderConfig] = None
    ctc_loss_reduction: str = "mean"
    compute_dtype: torch.dtype = torch.float32
    # dtype of the encoder's activation stream (block inputs/outputs)
    activation_dtype: torch.dtype = torch.float32
    # optional intermediate CTC head on the pre-encoder brain latents: the
    # loss becomes ctc + additional_loss_weight * (aux | aux^2)
    aux_head_vocab_size: Optional[int] = None
    additional_loss_weight: float = 1.0
    additional_loss_squared: bool = False
    # what a train-mode encoder layer keeps for its backward (models/remat.py::POLICIES;
    # --remat_policy=auto resolves to one of them before the model runs, experiments/impl.py)
    remat_policy: str = "none"

    def __post_init__(self):
        if self.encoder_family == "conformer":
            if self.conformer_cfg is None:
                self.conformer_cfg = ConformerEncoderConfig.rope_large_960h()
        elif self.encoder_family == "wav2vec2":
            if self.w2v_cfg is None:
                self.w2v_cfg = Wav2Vec2EncoderConfig.base_960h()
        else:
            raise ValueError(f"encoder_family {self.encoder_family!r}: expected 'conformer' or 'wav2vec2'")

    @classmethod
    def from_args(
        cls,
        bfe_args,
        latent_size: int,
        encoder_family: str,
        encoder_cfg,
        ctc_loss_reduction: str = "mean",
        compute_dtype: torch.dtype = torch.float32,
        activation_dtype: torch.dtype = torch.float32,
        remat_policy: str = "none",
    ) -> "ModelSpec":
        """The spec of an experiment's flags (args/flags.py), as the JAX
        ModelSpec.from_args builds it (without its scan field; remat_policy
        resolved, not "auto")."""
        return cls(
            unfolder_kernel_len=bfe_args.unfolder_kernel_len,
            unfolder_stride_len=bfe_args.unfolder_stride_len,
            gaussian_smooth_width=bfe_args.gaussian_smooth_width,
            gru_hidden_size=bfe_args.encoder_gru_hidden_size,
            gru_bidirectional=bfe_args.encoder_bidirectional,
            gru_num_layers=bfe_args.encoder_num_gru_layers,
            gru_bias=bfe_args.encoder_bias,
            gru_dropout=bfe_args.encoder_dropout,
            gru_learnable_initial_state=bfe_args.encoder_learnable_inital_state,
            fc_hidden_sizes=tuple(bfe_args.encoder_fc_hidden_sizes),
            fc_activation=bfe_args.encoder_fc_activation_function,
            latent_size=latent_size,
            encoder_family=encoder_family,
            w2v_cfg=encoder_cfg if encoder_family == "wav2vec2" else None,
            conformer_cfg=encoder_cfg if encoder_family == "conformer" else None,
            ctc_loss_reduction=ctc_loss_reduction,
            compute_dtype=compute_dtype,
            activation_dtype=activation_dtype,
            aux_head_vocab_size=getattr(bfe_args, "aux_head_vocab_size", None),
            additional_loss_weight=getattr(bfe_args, "additional_loss_weight", None) or 1.0,
            additional_loss_squared=bool(getattr(bfe_args, "additional_loss_squared", False)),
            remat_policy=remat_policy,
        )


def init_model_params(generator: torch.Generator, spec: ModelSpec, device) -> Tuple[dict, dict]:
    """Random params + BN state with the JAX init's distributions, created
    directly on `device` from `generator` (which must live on that device)."""
    gru_in = in_size_after_preprocessing(spec.unfolder_kernel_len)
    gru_out = spec.gru_hidden_size * (2 if spec.gru_bidirectional else 1)
    brain = {
        "preproc": init_preproc_params(generator, device),
        "gru": init_gru_params(
            generator,
            gru_in,
            spec.gru_hidden_size,
            spec.gru_num_layers,
            spec.gru_bidirectional,
            spec.gru_bias,
            spec.gru_learnable_initial_state,
            device,
        ),
        "fc": init_fc(generator, gru_out, spec.latent_size, spec.fc_hidden_sizes, device),
    }
    if spec.encoder_family == "wav2vec2":
        encoder = init_w2v_encoder_params(generator, spec.w2v_cfg, device)
        head = init_lm_head_params(generator, spec.w2v_cfg, device)
        state = {"encoder": {}}
    else:
        cfg = spec.conformer_cfg
        encoder = init_conformer_encoder_params(generator, cfg, device)
        head = init_linear(generator, cfg.hidden_size, cfg.vocab_size, device)
        state = {"encoder": init_conformer_state(cfg, device)}
    params = {"brain": brain, "w2v": {"encoder": encoder, "lm_head": head}}
    if spec.aux_head_vocab_size is not None:
        params["aux_head"] = init_linear(generator, spec.latent_size, spec.aux_head_vocab_size, device)
    return params, state


def forward(
    params: dict,
    state: dict,
    spec: ModelSpec,
    x: torch.Tensor,
    day_idxs: torch.Tensor,
    input_lens: torch.Tensor,
    rng: Optional[ForwardRng] = None,
    train: bool = False,
    return_extras: bool = False,
    tp=None,
):
    """Batch (B, T, 256) -> (logits (B, T', vocab) f32, logit_lens (B,),
    new_state), plus an extras dict when return_extras: "hidden_states"
    (the encoder's output: for the conformer after the final dropout, what
    the lm_head projects; for wav2vec2 before it, as in the JAX package),
    "latents" (the pre-encoder brain latents) and, with an aux head,
    "aux_logits".

    Train mode needs rng, a ForwardRng whose gru / enc / head streams seed
    the GRU's inter-layer dropout, the encoder and the head's final dropout.
    tp: this rank's parallel/tensor.py::TensorShard under tensor
    parallelism (the encoder's params are then its pieces), else None."""
    if train and rng is None:
        raise ValueError("forward: train mode needs a ForwardRng of seed streams (models/seeds.py)")
    cd = spec.compute_dtype
    x = x.float()
    taps = gaussian_kernel(GAUSS_KERNEL_SIZE, spec.gaussian_smooth_width, x.device)
    pre = apply_preproc_fused if kernel_enabled("preproc") else apply_preproc
    feats, out_lens = pre(
        params["brain"]["preproc"], x, day_idxs, input_lens, taps,
        spec.unfolder_kernel_len, spec.unfolder_stride_len,
    )
    h = apply_gru(
        params["brain"]["gru"],
        feats,
        spec.gru_hidden_size,
        spec.gru_num_layers,
        spec.gru_bidirectional,
        spec.gru_learnable_initial_state,
        compute_dtype=cd,
        dropout=spec.gru_dropout,
        train=train,
        stream=rng.gru if rng is not None else None,
    )
    latents = apply_fc(params["brain"]["fc"], h, spec.fc_activation, cd)
    enc_in = latents.to(spec.activation_dtype)
    enc_stream = rng.enc if rng is not None else None
    head_stream = rng.head if rng is not None else None
    if spec.encoder_family == "wav2vec2":
        hidden = apply_w2v_encoder(params["w2v"]["encoder"], enc_in, spec.w2v_cfg, train, cd, enc_stream, tp,
                                   spec.remat_policy)
        new_state = state
        logits = apply_lm_head(params["w2v"]["lm_head"], hidden, spec.w2v_cfg, cd, head_stream, train)
        # the extras' hidden states are the encoder's, before the final dropout
    else:
        cfg = spec.conformer_cfg
        hidden, new_enc_state = apply_conformer_encoder(
            params["w2v"]["encoder"], state["encoder"], enc_in, cfg,
            train=train, compute_dtype=cd, stream=enc_stream, tp=tp, remat_policy=spec.remat_policy,
        )
        # ForCTC head: final dropout + vocab projection; the extras' hidden
        # states are the dropped-out ones the head projects
        hidden = dropout_site(head_stream, hidden, cfg.final_dropout, train)
        logits = apply_linear(params["w2v"]["lm_head"], hidden, cd)
        new_state = {"encoder": new_enc_state}
    if not return_extras:
        return logits.float(), out_lens, new_state
    extras = {"hidden_states": hidden.float(), "latents": latents.float()}
    if spec.aux_head_vocab_size is not None:
        extras["aux_logits"] = apply_linear(params["aux_head"], latents, cd).float()
    return logits.float(), out_lens, new_state, extras


def forward_with_loss(
    params: dict,
    state: dict,
    spec: ModelSpec,
    x: torch.Tensor,
    day_idxs: torch.Tensor,
    input_lens: torch.Tensor,
    targets: Optional[torch.Tensor],
    target_lens: Optional[torch.Tensor],
    rng: Optional[ForwardRng] = None,
    train: bool = False,
    sample_mask: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
    mask_total: Optional[float] = None,
    group=None,
    tp=None,
) -> dict:
    """{logits, logit_lens, loss (None without targets), state, metrics}
    (+ hidden_states with return_hidden). With an aux head the loss is the
    combined ctc + w * (aux | aux^2) and metrics carries ctc_loss,
    intermediate_loss (intermediate_loss_squared) and combined_loss, the JAX
    package's names; without one, metrics is {}.

    Data parallelism: the rows are part of a global batch split over
    `group`, whose "mean" denominator is mask_total. Each CTC loss is this
    part's share, summed over the ranks (parallel/distributed.py::
    loss_across) before they are combined, so the loss and the metrics are
    the global batch's on every rank. Under tensor parallelism `group` is
    the data group and tp this rank's TensorShard (forward's)."""
    aux_on = spec.aux_head_vocab_size is not None
    fwd = forward(
        params, state, spec, x, day_idxs, input_lens, rng, train,
        return_extras=aux_on or return_hidden, tp=tp,
    )
    logits, logit_lens, new_state = fwd[:3]
    extras = fwd[3] if len(fwd) > 3 else {}
    loss = None
    metrics = {}
    if targets is not None:
        def across(part):
            return part if group is None else distributed.loss_across(part, group)

        loss = across(ctc_loss(
            logits, logit_lens, targets, target_lens, spec.ctc_loss_reduction,
            sample_mask=sample_mask, mask_total=mask_total,
        ))
        if aux_on:
            aux_loss = across(ctc_loss(
                extras["aux_logits"], logit_lens, targets, target_lens,
                spec.ctc_loss_reduction, sample_mask=sample_mask, mask_total=mask_total,
            ))
            metrics["ctc_loss"] = loss
            metrics["intermediate_loss"] = aux_loss
            aux_term = aux_loss**2 if spec.additional_loss_squared else aux_loss
            if spec.additional_loss_squared:
                metrics["intermediate_loss_squared"] = aux_term
            loss = loss + aux_term * spec.additional_loss_weight
            metrics["combined_loss"] = loss
    out = dict(logits=logits, logit_lens=logit_lens, loss=loss, state=new_state, metrics=metrics)
    if return_hidden:
        out["hidden_states"] = extras["hidden_states"]
    return out


# --- optimizer param labeling -------------------------------------------------


def _label_tree(tree, label):
    return tree_map(lambda _: label, tree)


def param_labels(params: dict, unfreeze_strategy: str) -> dict:
    """Tree of "brain" / "w2v" / "frozen" labels with params' structure:
    the dead inp_layers parity weights are always frozen; under
    unfreeze_strategy "brain_encoder" the whole w2v subtree (lm_head
    included) is frozen; an aux head trains with the brain group."""
    brain = params["brain"]
    labels_brain = {k: _label_tree(v, "brain") for k, v in brain.items() if k != "preproc"}
    labels_brain["preproc"] = {
        k: _label_tree(v, "frozen" if k == "inp_layers" else "brain")
        for k, v in brain["preproc"].items()
    }
    w2v_label = "w2v" if unfreeze_strategy == "brain_encoder+w2v" else "frozen"
    labels = {"brain": labels_brain, "w2v": _label_tree(params["w2v"], w2v_label)}
    if "aux_head" in params:
        labels["aux_head"] = _label_tree(params["aux_head"], "brain")
    return labels
