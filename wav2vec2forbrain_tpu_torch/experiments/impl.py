"""Experiment lifecycle: construction, run(), prediction dumps (counterpart
of wav2vec2forbrain_tpu/experiments/impl.py).

Construction: the flags (args/flags.py) -> seeds -> tokenizer -> the three
loaders -> the results dir cache_dir/experiment_results/<name>/[subdir]/
<timestamp> with config.json (and its repro_cmd) -> the model on `device`
(the card unless the caller asks for another), its encoder pretrained
unless --w2v_skip_loading_weights -> optimizer, steps and LR schedules ->
--from_checkpoint. run(): logger -> Trainer.train() ->
model.pt / brain_encoder.pt / history.json / history.png -> or, with
--only_test, test_predictions.json and its plots. With
--lm_decode_test_predictions the test evaluations also decode with the
n-gram LM of config.yaml's n3gram_lm_model_path (decode/lm_decode.py).

TF32 is off for cuBLAS and cuDNN once an experiment is built: at the
default f32 compute every product is an f32 product, as in the tests.

Pretrained weights (--w2v_skip_loading_weights=false, the default) come
from --wav2vec_checkpoint's snapshot in config.yaml's cache_dir hub cache,
through the converted cache the JAX package also reads and writes
(models/pretrained.py); a missing snapshot raises.

What the port does differently, or not at all:
- Checkpoints are torch files of the JAX package's trees; --from_checkpoint
  and --brain_encoder_path also take the JAX package's .msgpack files
  (train/checkpoint.py). `adopt_params` takes given weights (for example
  the JAX package's, through bridge.params_from_jax) before run().
- --use_pallas does not gate the hand-written kernels: they are the port's
  implementation on the card. --pallas_kernels selects them
  (ops/select.py); --pallas_kernels=none runs the plain versions.
- The input path (train/device_cache.py, train/train_loop.py): under
  --device_data_cache a split is uploaded once and each batch gathered on
  the device (`get_device_caches`): "on" on the experiment's device (the
  CPU too), "auto" on the card when the splits fit
  --device_data_cache_max_bytes (the JAX rule on an accelerator; on the
  CPU it streams), "off" streams. A resident split's batches run at its
  dataset-wide (T, U) rounded to --pad_to_multiple /
  --target_pad_to_multiple (`batch_widths`), with --length_buckets at
  each batch's bucket (`t_buckets`, train/buckets.py); a streamed split
  runs at the collate's width. Unlike the JAX package, an upload that
  fails raises instead of streaming. --host_prefetch collates, pads and
  copies a streamed split's next batch on a worker thread while the
  current step runs.
- --multi_step_chunk keeps no K-step chunks (an XLA dispatch saving), but
  it decides, with the JAX rule (`resolve_multi_step_chunk`: "auto" is 32
  on the card, 0 on the CPU), which epochs the JAX package would chunk: K
  >= 2 and a resident split (--device_data_cache). Such an
  epoch visits its batches in the chunks' order (train/buckets.py::
  chunk_order): val and test epochs stably sorted by width (unless the LM
  decode needs their logits), train epochs so under
  --length_bucket_order=grouped only.
- --only_test runs each test batch at the width the Trainer gives the
  split (the JAX package runs it at the collate's): its loss is the
  training run's test loss. The two agree under --device_data_cache=off.
- Parsed and ignored (XLA- or TPU-only): --scan_layers,
  --precompile_buckets; --multi_step_chunk as a speed knob (above).
- --remat_policy checkpoints each train-mode encoder layer
  (models/remat.py; the JAX package remats its scanned layer body). "auto"
  (`_remat_auto`) resolves on the card in the train steps themselves
  (train/steps.py::RematAuto): none runs until a step's forward and
  backward peak over 0.90 of the card's memory or run out of it, and then
  the next of blocks, dots_nowide, min ("none" first, as the port has no
  scanned loop that forces a checkpoint); no step is added, so a run that
  fits under none launches what a run at --remat_policy=none launches. On
  the CPU "none" (the JAX package's unrolled loop is not rematerialised
  either).
- Data parallelism runs one process a rank under torchrun (`python -m
  torch.distributed.run --nproc_per_node=N -m wav2vec2forbrain_tpu_torch.run
  ...`; parallel/): the process group is joined before anything else (NCCL
  on the card, each rank on cuda:$LOCAL_RANK; gloo on the CPU),
  --mesh_data_parallel 0 takes the world size over --mesh_model_parallel
  and any other value must make the two the world size, rank 0's
  results-dir timestamp, params and BN state are
  broadcast, and rank 0 alone writes files (config.json, metrics.jsonl,
  history.json, the model, the predictions) and runs the LM decode.
  --optimizer_state_sharding=zero1 splits the Adam moments over the ranks
  (parallel/zero.py); in one process it changes nothing.
- Tensor parallelism (--mesh_model_parallel=M above 1) lays the ranks out
  as a (data, model) grid (parallel/mesh.py: world = dp x M, rank r at data
  index r // M and model index r % M) and splits the encoder's attention and
  FFN matmuls over each model group, Megatron's column / row split
  (parallel/tensor.py). Every rank builds or loads the whole tree, takes
  rank 0's, and keeps its pieces; every file is written whole. M must
  divide the world size and the encoder's heads and intermediate size
  (ValueError, before anything is built).
"""

import json
import os
import random
import sys
from datetime import datetime
from typing import Literal, Optional

import numpy as np
import torch

from wav2vec2forbrain_tpu_torch.args.flags import (
    PRETRAINED_LATENT_SIZES,
    B2TGruAndW2VArgsModel,
    B2TGruAndW2VConformerArgsModel,
    validate,
)
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel
from wav2vec2forbrain_tpu_torch.data.dataset import Brain2TextDataset, time_axis_of
from wav2vec2forbrain_tpu_torch.data.loader import Brain2TextBatchSampler, DataLoader
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer
from wav2vec2forbrain_tpu_torch.models import pretrained
from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec, init_model_params, param_labels
from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
from wav2vec2forbrain_tpu_torch.ops.select import f32_products, set_kernel_policy
from wav2vec2forbrain_tpu_torch.parallel import distributed
from wav2vec2forbrain_tpu_torch.parallel.mesh import make_mesh
from wav2vec2forbrain_tpu_torch.parallel.tensor import check_divides, gather_tree, split_tree
from wav2vec2forbrain_tpu_torch.parallel.zero import Zero1
from wav2vec2forbrain_tpu_torch.train.checkpoint import copy_into, load_checkpoint, load_into, save_checkpoint, save_subtree
from wav2vec2forbrain_tpu_torch.train.device_cache import build_split_caches
from wav2vec2forbrain_tpu_torch.train.evaluator import EvaluatorWithLMDecoder
from wav2vec2forbrain_tpu_torch.train.history import TrainHistory
from wav2vec2forbrain_tpu_torch.train.logger import make_logger
from wav2vec2forbrain_tpu_torch.train.optim import LRSchedules, make_optimizer, step_lr, two_module_warmup_schedules
from wav2vec2forbrain_tpu_torch.train.steps import RematAuto, StepConfig, build_eval_step, build_train_step
from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer
from wav2vec2forbrain_tpu_torch.tree import tree_leaves
from wav2vec2forbrain_tpu_torch.util import profiling

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
IGNORED_FLAGS = ("scan_layers", "precompile_buckets", "multi_step_chunk")
# --remat_policy=auto keeps a policy whose step fits this share of the card's memory (the JAX package's
# _REMAT_HBM_MARGIN: the rest is left to the eval step and the allocator's slack)
REMAT_MEMORY_SHARE = 0.90
USE_PALLAS_NOTE = (
    "--use_pallas=false: the port's CUDA kernels are its implementation; "
    "use --pallas_kernels=none to run the plain versions"
)


def _have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def resolve_device(device) -> torch.device:
    """The experiment's device; a CUDA device must exist (no fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: the port runs on the card; build the experiment with device='cpu' to run on the CPU"
        )
    return device


class B2TGruW2VExperimentBase:
    """Shared lifecycle of the two registered experiment types."""

    ARGS_MODEL = B2TGruAndW2VArgsModel
    NAME = "b2p2t_gru+w2v"
    ENCODER_FAMILY = "wav2vec2"

    def __init__(self, config: dict, yamlConfig: YamlConfigModel, device="cuda"):
        self.device = distributed.maybe_initialize_distributed(resolve_device(device))
        self.base_config = validate(self.ARGS_MODEL, config)
        self.yaml_config = yamlConfig
        self.raw_config = config
        enc_cfg = self._encoder_config()
        check_divides(self.base_config.mesh_model_parallel, enc_cfg.num_attention_heads, enc_cfg.intermediate_size)
        # the (data, model) grid over the ranks (None in one process)
        self.shard = make_mesh(self.base_config.mesh_data_parallel, self.base_config.mesh_model_parallel)
        self.tp = None if self.shard is None else self.shard.model  # parallel/tensor.py::TensorShard
        f32_products()

        cfg = self.base_config
        np.random.seed(cfg.seed)
        random.seed(cfg.seed)
        self.time_axis = time_axis_of(cfg.preprocessing)
        self.tokenizer = self._create_tokenizer()
        self.dataloader_train = self._create_dataloader("train")
        self.dataloader_val = self._create_dataloader("val")
        self.dataloader_test = self._create_dataloader("test")
        self._device_caches = None
        self.batch_widths, self.t_buckets, self.sample_lengths = self._resolve_batch_widths()

        subdir = [cfg.results_subdir_name] if cfg.results_subdir_name is not None else []
        self.results_dir = os.path.join(
            yamlConfig.cache_dir, "experiment_results", self.get_name(), *subdir,
            distributed.broadcast_object(f"{datetime.now():%Y-%m-%d_%H#%M#%S}"),
        )
        self.coordinator = distributed.is_coordinator()  # the rank that writes files
        if self.coordinator:
            os.makedirs(self.results_dir, exist_ok=True)
            with open(os.path.join(self.results_dir, "config.json"), "w") as f:
                config_copy = dict(config)
                config_copy["repro_cmd"] = "python " + " ".join(sys.argv)
                json.dump(config_copy, f, indent=5)

        self._log_ignored_flags()
        self._build_model()
        if distributed.world_size() > 1:  # every rank starts from rank 0's weights
            distributed.broadcast_tensors(tree_leaves(self.params) + tree_leaves(self.model_state))

        self.checkpoint_history = None
        if cfg.from_checkpoint is not None:
            print(f"loading model from checkpoint {cfg.from_checkpoint}")
            load_into(cfg.from_checkpoint, self.params, self.model_state)
            history_path = os.path.join(os.path.dirname(cfg.from_checkpoint), "history.json")
            if os.path.exists(history_path):
                print("Attempting to load history from checkpoint")
                try:
                    self.checkpoint_history = TrainHistory.from_json(history_path)
                except Exception:
                    print("Failed to load history from checkpoint")
        self.params = split_tree(self.params, self.tp)  # this rank's pieces under tensor parallelism
        self._build_optimizer_and_steps()

        self.step_rng = StepRng(cfg.seed + 1, device=self.device)
        self.lm_decoder = None  # built at the first test evaluator
        self.logger = None  # created in run()
        self.can_plot = _have_matplotlib()

    # --- subclass hooks -----------------------------------------------------

    @classmethod
    def get_args_model(cls):
        return cls.ARGS_MODEL

    def get_name(self) -> str:
        return self.NAME

    def get_vocab(self):
        return self.tokenizer.get_vocab_list()

    # --- construction pieces ------------------------------------------------

    def _log_ignored_flags(self):
        cfg = self.base_config
        ignored = ", ".join(f"--{name}={getattr(cfg, name)}" for name in IGNORED_FLAGS)
        print(f"XLA/TPU-only flags, parsed and ignored by the port: {ignored}")
        if not cfg.use_pallas:
            print(USE_PALLAS_NOTE)

    def _create_tokenizer(self) -> Wav2Vec2CTCTokenizer:
        cfg = self.base_config
        if cfg.tokenizer != "wav2vec_pretrained":
            raise NotImplementedError(f"Tokenizer {cfg.tokenizer} not implemented (only wav2vec_pretrained is live)")
        if cfg.tokenizer_checkpoint != cfg.wav2vec_checkpoint:
            print("Warning: tokenizer checkpoint differs from wav2vec checkpoint")
        return Wav2Vec2CTCTokenizer.from_pretrained(cfg.tokenizer_checkpoint)

    def _create_dataset(self, split: Literal["train", "val", "test"]):
        return Brain2TextDataset(config=self.base_config, dataset_splits_dir=self.yaml_config.dataset_splits_dir,
                                 split=split)

    def _create_dataloader(self, split: Literal["train", "val", "test"]):
        cfg = self.base_config
        ds = self._create_dataset(split)
        collate = ds.get_collate_fn(self.tokenizer, pad_to_multiple=cfg.pad_to_multiple,
                                    target_pad_to_multiple=cfg.target_pad_to_multiple)
        length_key = None
        if cfg.length_sorted_batches:
            t_axis = self.time_axis
            length_key = lambda i: ds.samples[i].input.shape[t_axis]  # noqa: E731
        sampler = None
        if cfg.day_batches:
            sampler = Brain2TextBatchSampler(ds, cfg.batch_size, shuffle=(split == "train"),
                                             rng=random.Random(cfg.seed), length_key=length_key)
        return DataLoader(ds, batch_size=cfg.batch_size, collate_fn=collate, shuffle=(split == "train"),
                          batch_sampler=sampler, seed=cfg.seed, length_key=length_key)

    def get_device_caches(self) -> dict:
        """{split: train/device_cache.py::DeviceDatasetCache} per
        --device_data_cache, built once (at construction): "on" uploads
        every split to the experiment's device (the CPU included), "auto"
        to the card when the splits fit --device_data_cache_max_bytes (the
        JAX rule on an accelerator; nothing on the CPU), "off" none. A
        split without a cache streams (Trainer._place)."""
        if self._device_caches is None:
            cfg = self.base_config
            mode = cfg.device_data_cache
            if mode == "off" or (mode == "auto" and self.device.type != "cuda"):
                self._device_caches = {}
            else:
                loaders = {"train": self.dataloader_train, "val": self.dataloader_val, "test": self.dataloader_test}
                self._device_caches = build_split_caches(
                    loaders, self.tokenizer, cfg, self.device,
                    max_bytes=cfg.device_data_cache_max_bytes if mode == "auto" else None)
        return self._device_caches

    def _resolve_batch_widths(self):
        """({split: (T, U)}, {split: T widths}, {split: sample lengths}) of
        the resident splits (get_device_caches): their dataset-wide widths,
        their --length_buckets widths and each sample's frames. A streamed
        split has none and runs at the collate's width. The resident gather
        and the streamed Trainer._place read the same widths, so a batch is
        the same either way."""
        caches = self.get_device_caches()
        widths = {split: (c.t_full, c.u_full) for split, c in caches.items()}
        t_buckets = {split: c.buckets for split, c in caches.items() if c.buckets}
        lengths = {split: c.input_lens.tolist() for split, c in caches.items()}
        return widths, t_buckets, lengths

    def resolve_multi_step_chunk(self) -> int:
        """The JAX package's chunk size K (its experiments/impl.py::
        resolve_multi_step_chunk, 0 = off): "auto" is 32 on the card and 0
        on the CPU. The port runs no chunks; K >= 2 only orders the batches
        of the epochs the JAX package would chunk (Trainer._epoch_batches)."""
        v = self.base_config.multi_step_chunk
        if v == "off":
            return 0
        if v == "auto":
            return 32 if self.device.type == "cuda" else 0
        return max(0, int(v))

    def _encoder_config(self):
        cfg = self.base_config
        family, enc_cfg = pretrained.encoder_config_for_checkpoint(cfg.wav2vec_checkpoint)
        if family != self.ENCODER_FAMILY:
            raise AssertionError(
                f"checkpoint {cfg.wav2vec_checkpoint} is a {family} model but experiment "
                f"{self.get_name()} expects {self.ENCODER_FAMILY}"
            )
        if family == "wav2vec2" and getattr(cfg, "w2v_do_stable_layer_norm", False):
            enc_cfg.do_stable_layer_norm = True
        return enc_cfg

    def _build_model(self):
        cfg = self.base_config
        set_kernel_policy(cfg.pallas_kernels)
        self.spec = ModelSpec.from_args(
            cfg,
            latent_size=PRETRAINED_LATENT_SIZES[cfg.wav2vec_checkpoint],
            encoder_family=self.ENCODER_FAMILY,
            encoder_cfg=self._encoder_config(),
            ctc_loss_reduction=cfg.ctc_loss_reduction,
            compute_dtype=DTYPES[cfg.compute_dtype],
            activation_dtype=DTYPES[cfg.activation_dtype],
            remat_policy="none" if cfg.remat_policy == "auto" else cfg.remat_policy,  # auto: see _remat_auto
        )
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.params, self.model_state = init_model_params(generator, self.spec, self.device)
        if not cfg.w2v_skip_loading_weights:
            # the pretrained encoder, lm_head and BN state (models/pretrained.py), strictly in place
            enc, head, enc_state = pretrained.load_pretrained_encoder(cfg.wav2vec_checkpoint,
                                                                      cache_dir=self.yaml_config.cache_dir)
            copy_into(self.params["w2v"], {"encoder": enc, "lm_head": head}, "/w2v")
            copy_into(self.model_state, enc_state)
        if cfg.brain_encoder_path is not None:
            # a brain-encoder subtree written by store_trained_model (.pt) or by the JAX package (.msgpack)
            copy_into(self.params["brain"], load_checkpoint(cfg.brain_encoder_path)[0])
        self.labels = param_labels(self.params, cfg.unfreeze_strategy)

    def adopt_params(self, params: dict, state: dict) -> None:
        """Take given weights and BN state (whole trees like the port's, for
        example bridge.params_from_jax of the JAX package's) before run()."""
        copy_into(self.params, split_tree(params, self.tp))
        copy_into(self.model_state, state)

    def _step_cfg(self) -> StepConfig:
        cfg = self.base_config
        return StepConfig(gradient_clipping=cfg.gradient_clipping, white_noise_sd=cfg.whiteNoiseSD,
                          constant_offset_sd=cfg.constantOffsetSD)

    def _build_optimizer_and_steps(self):
        cfg = self.base_config
        self.optimizer = make_optimizer(
            self.labels,
            optimizer=cfg.optimizer,
            weight_decay=cfg.weight_decay,
            eps=cfg.optimizer_epsilon,
            mu_dtype=torch.bfloat16 if cfg.adam_mu_dtype == "bfloat16" else None,
            nu_dtype=torch.bfloat16 if cfg.adam_nu_dtype == "bfloat16" else None,
            zero=Zero1(self.shard) if cfg.optimizer_state_sharding == "zero1" and self.shard is not None else None,
        )
        self.opt_state = self.optimizer.init(self.params)
        self.remat_auto = self._remat_auto() if cfg.remat_policy == "auto" else None
        self.train_step = build_train_step(self.spec, self.labels, self.optimizer, self._step_cfg(), self.shard,
                                           self.remat_auto)
        self.eval_step = build_eval_step(self.spec, self.shard)
        self.lr_schedules = self._make_lr_schedules()

    def _remat_auto(self) -> Optional[RematAuto]:
        """--remat_policy=auto: on the card the train steps' RematAuto at a
        budget of REMAT_MEMORY_SHARE of its memory; on the CPU None, and
        the steps run the spec's "none"."""
        if self.device.type != "cuda":
            print("remat_policy=auto: none (on the CPU: no card memory to budget)")
            return None
        return RematAuto(REMAT_MEMORY_SHARE * torch.cuda.get_device_properties(self.device).total_memory,
                         self.device)

    def _make_lr_schedules(self) -> LRSchedules:
        cfg = self.base_config
        if cfg.unfreeze_strategy == "brain_encoder":
            for name in ("w2v_learning_rate", "w2v_warmup_steps", "adjust_global_lr_to_w2v_postwarmup_lr"):
                if getattr(cfg, name) is not None:
                    raise AssertionError(f"{name} can only be set if unfreeze strategy is brain_encoder+w2v")
            brain = step_lr(cfg.learning_rate, cfg.scheduler_step_size, cfg.scheduler_gamma)
            return LRSchedules(brain=brain, w2v=lambda e: 0.0)
        return two_module_warmup_schedules(
            cfg.learning_rate,
            cfg.w2v_warmup_start_step or 0,
            cfg.w2v_warmup_steps or 0,
            cfg.w2v_learning_rate if cfg.w2v_learning_rate is not None else cfg.learning_rate,
            cfg.adjust_global_lr_to_w2v_postwarmup_lr == True,  # noqa: E712
        )

    # --- evaluator ----------------------------------------------------------

    def _make_lm_decoder(self):
        """The LM decode hook, built once an experiment (an n-gram model is
        parsed once); None without --lm_decode_test_predictions."""
        cfg = self.base_config
        if not cfg.lm_decode_test_predictions:
            return None
        if self.lm_decoder is None:
            from wav2vec2forbrain_tpu_torch.decode.lm_decode import make_lm_decoder

            self.lm_decoder = make_lm_decoder(
                vocab=self.tokenizer.get_vocab_list(),
                lm_path=self.yaml_config.n3gram_lm_model_path,
                beam_width=cfg.lm_decode_beam_width,
                beam_prune_logp=cfg.lm_decode_beam_prune_logp,
                token_min_logp=cfg.lm_decode_token_min_logp,
                alpha=cfg.lm_decode_alpha,
                beta=cfg.lm_decode_beta,
                score_boundary=cfg.lm_score_boundary,
            )
        return self.lm_decoder

    def create_evaluator(self, mode: Literal["train", "val", "test"], track_non_test_predictions: bool = False):
        return EvaluatorWithLMDecoder(
            self.tokenizer,
            mode,
            lm_decoder=self._make_lm_decoder() if mode == "test" and self.coordinator else None,
            track_non_test_predictions=track_non_test_predictions,
            lm_decode_test_predictions=self.base_config.lm_decode_test_predictions,
            crop_lens=self.base_config.greedy_decode_crop_lens,
        )

    def decode_predictions(self, pred_ids, targets=None):
        predicted = self.tokenizer.batch_decode(pred_ids, group_tokens=True)
        labels = self.tokenizer.batch_decode(targets, group_tokens=False) if targets is not None else None
        return predicted, labels

    # --- checkpointing ------------------------------------------------------

    def store_trained_model(self):
        params = gather_tree(self.params, self.tp)  # the whole tree (a collective under tensor parallelism)
        if not self.coordinator:
            return
        save_checkpoint(os.path.join(self.results_dir, "model.pt"), params, self.model_state)
        if getattr(self.base_config, "store_brain_encoder", False):
            save_subtree(os.path.join(self.results_dir, "brain_encoder.pt"), params["brain"])

    # --- run ----------------------------------------------------------------

    def run(self):
        cfg = self.base_config
        self.logger = make_logger(
            self.results_dir,
            self.raw_config,
            cfg.use_wandb,
            wandb_api_key=self.yaml_config.wandb_api_key,
            wandb_project=self.yaml_config.wandb_project_name,
            wandb_entity=self.yaml_config.wandb_entity,
            experiment_name=cfg.experiment_name,
            enabled=self.coordinator,
        )
        trainer = Trainer(self)
        if not self.can_plot:
            print("matplotlib is not installed: history.png and the prediction plots are skipped")
        try:
            if not cfg.only_test:
                history = trainer.train()
                # adopt the trainer's (possibly best-reloaded) state
                self.opt_state = trainer.opt_state
                self.model_state = trainer.model_state
                if cfg.store_final_model:
                    self.store_trained_model()
                if self.coordinator:
                    with open(os.path.join(self.results_dir, "history.json"), "w") as f:
                        json.dump(history.to_dict(), f, indent=5)
                    self.plot_results(history)
            else:
                test_results = self.run_real_world_test(trainer)
                self.logger.log(trainer._get_wandb_metrics(test_results, "test"))
            if cfg.log_results_as_artifact and self.coordinator:
                self._log_results_artifact()
            print(f"Done. Saved results to {self.results_dir}")
        finally:
            self.logger.finish()

    def _log_results_artifact(self):
        """W&B results artifact; a no-op without an active wandb run."""
        try:
            import wandb

            if wandb.run is not None:
                artifact = wandb.Artifact(name="results", type="experiment_results")
                artifact.add_dir(f"{self.results_dir}/")
                wandb.run.log_artifact(artifact)
        except ImportError:
            print("log_results_as_artifact: wandb not installed, skipping")

    def plot_results(self, history: TrainHistory):
        if self.can_plot:
            history.plot(os.path.join(self.results_dir, "history.png"), loss_name=self.base_config.loss_function)

    def run_real_world_test(self, trainer):
        test_results = self._predict_and_store(trainer, "test")
        if self.base_config.predict_on_train:
            self._predict_and_store(trainer, "train")
        return test_results

    def _predict_and_store(self, trainer, mode: Literal["train", "test"]):
        prediction = self._predict(trainer, mode)
        if self.coordinator:
            with open(os.path.join(self.results_dir, f"{mode}_predictions.json"), "w") as f:
                json.dump(prediction.to_dict(), f, indent=5)
        return prediction

    def _predict(self, trainer, mode: Literal["train", "test"]):
        """Lag-1 pipelined prediction pass: batch i+1 is queued on the device
        before batch i's logits are fetched and decoded (the LM decode, where
        it is on, runs on the evaluator's threads). Batches come from the
        Trainer's input path in the loader's order, at the width the Trainer
        gives that split, so --only_test reproduces the test loss of the run
        that stored the model."""
        dataloader = self.dataloader_train if mode == "train" else self.dataloader_test
        evaluator = self.create_evaluator("test" if mode == "test" else "train", True)
        n = len(dataloader)
        pending = None
        plots = self.can_plot and self.coordinator
        rows = trainer._rows  # every rank's rows, gathered under data parallelism

        def process(outs, host_batch, true_b, i):
            loss, logits, logit_lens, pred_ids, _metrics = outs
            with profiling.span("fetch", i):
                preds = {
                    "loss": float(loss),
                    "pred_ids": rows(pred_ids)[:true_b].cpu().numpy(),
                    "logits": rows(logits)[:true_b].cpu().numpy(),
                    "logit_lens": rows(logit_lens)[:true_b].cpu().numpy(),
                }
            with profiling.span("evaluator", i):
                evaluator.track_batch(preds, host_batch)
            if plots and i < self.base_config.visualize_predictions_n_batches:
                out_dir = os.path.join(self.results_dir, f"{mode}_predictions")
                os.makedirs(out_dir, exist_ok=True)
                self.visualize_predictions(host_batch, preds, os.path.join(out_dir, f"batch_{i}.png"), i)
            print(f"Running predictions on {mode}. Batch {i + 1}/{n} done\r", end="")

        stream = trainer._stream_for(dataloader, mode, grouped=False)
        try:
            for i, (batch, true_b, mask_total, host_batch) in enumerate(stream):
                profiling.serve(i)
                outs = trainer.eval_step(trainer.params, trainer.model_state, batch, mask_total)
                if pending is not None:
                    process(*pending)
                pending = (outs, host_batch, true_b, i)
        finally:
            stream.close()
            profiling.serve(None)
        if pending is not None:
            process(*pending)
        with profiling.span("evaluator"):
            result = evaluator.evaluate()
            evaluator.clean_up()
        return result

    def visualize_predictions(self, batch, preds, out_path: str, batch_id: int):
        """Per-sample probability tables."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.colors import Normalize

        vocab = self.get_vocab()
        logits = preds["logits"]
        probs = np.exp(logits - logits.max(axis=-1, keepdims=True))
        probs = probs / probs.sum(axis=-1, keepdims=True)
        batch_size, seq_len, vocab_size = probs.shape
        nrows = min(batch_size, 4)
        px = 1 / plt.rcParams["figure.dpi"]
        fig, _axs = plt.subplots(
            nrows=nrows,
            figsize=(max(seq_len * 18 * px, 4), max(((vocab_size + 1) * 1.5) * nrows * 18 * px, 4)),
        )
        axs = np.atleast_1d(_axs)
        norm = Normalize(vmin=0, vmax=1)
        pred_strs, label_strs = self.decode_predictions(
            np.argmax(probs, axis=-1), np.asarray(batch.target) if batch.target is not None else None
        )
        for sample_index in range(nrows):
            ax = axs[sample_index]
            ax.imshow(probs[sample_index].T, aspect="auto", cmap="Blues", norm=norm, interpolation="nearest")
            ax.set_yticks(range(vocab_size))
            ax.set_yticklabels(vocab, fontsize=5)
            ax.set_xlabel("frame")
            title = f"pred: {pred_strs[sample_index]!r}"
            if label_strs is not None:
                title += f"  target: {label_strs[sample_index]!r}"
            ax.set_title(title, fontsize=7)
        plt.tight_layout()
        plt.savefig(out_path)
        plt.close(fig)


class B2TGruAndW2VExperiment(B2TGruW2VExperimentBase):
    """b2p2t_gru+w2v: the wav2vec2 family."""

    ARGS_MODEL = B2TGruAndW2VArgsModel
    NAME = "b2p2t_gru+w2v"
    ENCODER_FAMILY = "wav2vec2"


class B2TGruAndW2VConformerExperiment(B2TGruW2VExperimentBase):
    """b2p2t_gru+w2v_conformer: the conformer family."""

    ARGS_MODEL = B2TGruAndW2VConformerArgsModel
    NAME = "b2p2t_gru+w2v_conformer"
    ENCODER_FAMILY = "conformer"
