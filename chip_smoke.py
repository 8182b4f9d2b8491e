#!/usr/bin/env python3
"""Smoke test of the PyTorch port (wav2vec2forbrain_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root; needs one card
    python3 chip_smoke.py --phases 1,2,16   # only the listed phases (and those they read from)

Phases, each of which exits nonzero on failure:
  0. device: CUDA with compute capability 9.0, else exit nonzero; prints the
     card's name and power limit; TF32 off for the comparisons.
  1. build: nvcc compiles csrc/*.cu for sm_90a into build/kernels/ (or reuses
     the build of identical sources); prints the seconds and ptxas' usage.
  2. kernels: each hand-written kernel, forward and backward, against its
     plain PyTorch version on the card at both main paths' shapes, at f32
     and bf16 compute: preproc at B=32 (conformer, smoothing sigma 0.3) and
     B=64 (wav2vec2-base sweep, sigma 1.5), each forward and backward
     followed by its per-launch split, and at B=32 the forward also at a
     ragged T=99 and at a window of 20 frames, stride 3 (the unfold's
     scalar path); the GRU at H=256 through the
     fused entry (its forward one cluster-resident launch) with B=32 for the
     conformer and B=64 for the sweep grid's H=256 points, and, through its
     per-direction entry (one launch per step), at H=512 and 1024 with B=64
     for the sweep and at a ragged H=600 (the per-direction backward also
     timed without its f32 dW product); every GRU forward row's time per
     step printed; attention at T'=89, B=32, 16 heads (and a rank's rows of
     it at row0 16, and its heads 8-15 at head0 8, B=16, each also bitwise
     the whole call's heads), scale
     1/8 (conformer) and B=64, 12 heads, q pre-scaled by 1/8 and scale 1
     (wav2vec2-base), with dropout 0 and 0.1 against the dense version with
     the same seed (forward and backward on the tensor cores: bf16 products
     at bf16 compute, split-TF32 products at f32 compute), and at T'=169
     (about 700 frames) and T'=400, B=8 (about 1,600 frames: the forwards
     stream their key tiles there), at bf16 compute with dropout 0.1 and at
     f32 compute with dropout 0 and 0.1, and the forward at the audio
     stream's shape (phase 12): B=8, T'=299 (6 s of 16 kHz speech after
     the conv front end), the w2v heads (12 x 64, q pre-scaled, scale 1),
     rate 0, an f32 stream, at f32 and bf16 compute; GLU -> depthwise conv at B=32
     T=89 and at B=8 with T=169 and 400 (several of the backward's time
     chunks); the LayerNorm at both encoders'
     shapes with an f32 and a bf16 stream (the vector kernel at C 768 and
     1024); the CTC loss and its gradient (csrc/ctc.cu, no TPU kernel) at
     B=64, T' 89, 169 and 230, 32 classes (ragged lengths, a sample
     without an alignment, an empty target), also bitwise against itself
     over CTC_CALLS calls and against F.ctc_loss at f64 (within
     F32_CLASS_FACTOR x the plain version's distance); Adam (csrc/adam.cu,
     no TPU kernel) at both train cells' full leaf sets (conformer-rope-
     large and w2v-base-fft, f32 moments, the cells' weight decay, a dropped
     encoder layer's leaves without gradients): one step through the kernel
     bitwise the loop's (the plain version, `none`), "kernel" the device
     time of a step's kernel and table copy, "call" one whole step alone
     (the host's table included). Each row: max-abs
     error beside its tolerance; the kernel's
     device time with the queue kept full (`device_ms`: calls queued behind
     a spin kernel run back to back, so the host's launch overhead drops
     out; where queueing outlasts the longest spin, the row is marked
     "starved" and the kernel and its library call are also timed as the
     sum of their kernels' device times per call from torch.profiler,
     `profiler_ms`) and its time per lone call (CUDA events around one call after the queue
     drained, the host's launch overhead included); the plain
     version's time per call; the bound (the larger of the bytes over 3.35
     TB/s and the operations over the peak rate of their type) and, where
     one PyTorch call computes the same function, that call's time both ways
     (SDPA at rate 0, F.layer_norm, and for the GRU a bidirectional cuDNN
     nn.GRU fed gi through an identity W_ih: an upper bound, as it adds
     that projection). L2 warm throughout. The fused GRU backward's rows
     are followed by a split: each kernel's own device time per call
     (torch.profiler; without the gaps between launches).
  3. conformer serving: the full-width conformer-rope-large serving forward
     (24 layers, d=1024; random weights from a fixed seed) answers 4
     requests of 32 samples x 384 frames through predict.py with the `auto`
     policy at bf16 compute / f32 activations; launch counts of every
     forward kernel of the path, loss / WER / CER, samples/s, then the same
     under `none`; then one batch at f32 through `auto` and `none`.
  4. conformer training: train_batches takes 4 full-width train steps (bf16
     compute, f32 activations, dropout 0.1 everywhere, both LR groups, Adam)
     with the `auto` policy, its LayerDrop replayed so that encoder layer
     DROPPED_LAYER is dropped in every step (warm-up included) and every
     other layer runs: launch counts of every kernel of the path, steps/s
     and samples/s, finite losses and params, every trainable leaf of a
     layer that ran moved and those of the dropped layer moved only by
     weight decay, the BN running stats updated exactly in the layers that
     ran; then one step at f32 compute under `auto` (its launch counts
     printed) and under `none` from the same params, optimizer state and
     seed streams (dropout on, the same layer dropped): loss, global
     gradient norm and the updated params against their bounds.
  5. wav2vec2-base serving: phase 3 for `b2p2t_gru+w2v` at the fft sweep
     point (wav2vec2-base-960h: 12 post-LN layers, d=768, 12 heads, FFN
     3072; biGRU 3 x 1024, latent 768), 4 requests of 64 x 384.
  6. wav2vec2-base training: phase 4 for the same model (GRU dropout 0.45,
     Adam at weight decay 1e-4), 4 steps of 64 x 384.
  7. conformer CLI: `python -m wav2vec2forbrain_tpu_torch.run` in process
     (run.main) on a synthetic T12 splits dir written by the port's .mat
     writer (2 sessions, 200-700 frames a trial; train 70 samples, val 24,
     test 10) with a filled config.yaml: --experiment_type=
     b2p2t_gru+w2v_conformer at full width (conformer-rope-large, biGRU 2 x
     256, random weights, --w2v_skip_loading_weights=true), the CLI's
     default f32 compute, --batch_size=32 (a ragged last train batch),
     --epochs=2, --return_best_model=true, --checkpoint_every_n_epochs=1;
     then --only_test=true --from_checkpoint=<results>/model.pt. Fails
     unless the results files exist (config.json, history.json,
     metrics.jsonl, model.pt, train_state/state.pt; test_predictions.json
     of the --only_test run), every loss is finite, the params stayed on
     the card, exactly the family's kernels launched in each run, and the
     --only_test test loss is within CLI_TEST_LOSS_REL of the training
     run's; prints each run's wall time, train samples/s and launch counts.
     A third run is the paper's decode: --only_test=true
     --lm_decode_test_predictions=true --length_buckets=exact from the same
     model.pt, with config.yaml's n3gram_lm_model_path at a 3-gram ARPA
     written from the synthetic transcripts (maximum-likelihood n-grams).
     Fails unless the decoder's LM order is 3, every stored test batch has
     predictions_lm_decoded, word_error_rate_lm_decode and
     char_error_rate_lm_decode are finite, each batch ran at its collate's
     width, the params stayed on the card and exactly the family's serving
     kernels launched; prints the wall, the batch widths, the LM decode's
     host seconds per batch (beam 100) and the launch counts.
  8. wav2vec2-base CLI: phase 7 for --experiment_type=b2p2t_gru+w2v at the
     fft sweep point (sweeps/b2p2t_gru+w2v_full_fine_tuning.yaml: biGRU 3 x
     1024, batch 64, its LRs, dropout, smoothing and noise), without the
     third run; the training run is made twice from the one seed, and fails
     unless the two history.json files, the final params, BN state, Adam
     count and moments and the launch counts are equal, bitwise; prints
     both walls.
  9. the sweep runner: `wav2vec2forbrain_tpu_torch.sweep` runs
     sweeps/b2p2t_gru+w2v_training_from_scratch.yaml with --max_runs 2
     --extra --epochs=1 --length_buckets=4 on phase 7's splits, each point
     in process (run.main): wav2vec2-base at batch 64, f32, biGRU 1 and 3 x
     256, which take the fused GRU kernels. Fails unless both points
     returned 0, summary.jsonl has two rows with a finite test_ctc_loss, the
     best point is the one with the smaller loss and exactly the path's
     kernels launched (`gru`, `gru_bwd`, not `gru_dir`); prints each
     point's wall and the bucket widths.
 10. weights in: in phase 7's scratch dir, with its config.yaml, two HF
     hub-cache snapshots under cache_dir at full width (random values
     from SEED: the port's init plus seeded noise), in the checkpoints'
     own key layout (written out here as the converter's inverse):
     facebook/wav2vec2-base-960h as pytorch_model.bin (pos-conv weight_g /
     weight_v, and the whole audio front end, which the converter drops:
     7 convs of 512 without bias, the group norm, the projection to 768;
     seeded values, `snapshot_frontend`) and
     facebook/wav2vec2-conformer-rope-large-960h-ft as model.safetensors
     (`write_safetensors`). a. The first point of
     sweeps/b2p2t_gru+w2v_frozen_w2v.yaml through the sweep runner in
     process (--max_runs 1 --extra --epochs=1 --length_buckets=4:
     w2v-base pretrained, --unfreeze_strategy=brain_encoder, biGRU 1 x
     256, FC [], batch 64, f32). Fails unless it returned 0 with a finite
     test_ctc_loss, the converted cache exists, every w2v leaf on the
     card is bitwise the snapshot's after training, the brain moved, and
     exactly the w2v_sweep path's kernels launched, forward and backward
     (the backward runs through the frozen encoder). b. The conformer's
     default flags with --only_test=true, twice: the first run converts
     the snapshot and writes the cache, the second reads only the cache.
     Fails unless the two test losses are bitwise equal, the w2v subtree
     and the BN state are the snapshot's, the params stayed on the card
     and exactly the conformer's serving kernels launched. c. `convert
     to-msgpack` of run a's model.pt, then --only_test=true at run a's
     flags from the .msgpack and from the .pt. Fails unless the test
     losses are bitwise equal. Prints each run's wall and the loader's
     seconds (snapshot read, conversion, cache write, cache read).
 11. data parallel. a. Two ranks on the one card (this script started twice
     with --dp-rank, joined by gloo over localhost with CUDA tensors: NCCL
     takes one rank a device), each one conformer-rope-large train step at
     full width and f32 compute (the CLI's) on its 16 rows of phase 4's
     first batch (B32 x 384 frames, dropout and LayerDrop on, the sweeps'
     noise), once with the Adam moments replicated and once under ZeRO-1.
     Rank 0 then takes the same step in one process on the whole batch.
     Fails unless the ranks' losses are the one-process loss (DP_LOSS_REL),
     the all-reduced gradients are its gradients (each leaf within DP_GRAD_REL
     of its largest magnitude), the BN running stats are its stats
     (DP_BN_REL), the two ranks hold bitwise the same params and the
     ZeRO-1 params are bitwise the replicated ones, each rank keeps half of
     every split moment leaf, and each rank launched exactly the
     conformer's training kernels, its attention calls at row0 0 (rank 0)
     and 16 (rank 1). Prints the gradient all-reduce's seconds a step (gloo
     through the host: no NCCL figure). b. The CLI under `python -m
     torch.distributed.run --standalone --nproc_per_node=1` (NCCL) with
     phase 7's splits and flags and --mesh_data_parallel=0
     --optimizer_state_sharding=zero1. Fails unless it returned 0, wrote
     its results once (one results dir, one run_config in metrics.jsonl)
     and its test loss is bitwise phase 7's training run's.
 12. the analysis (analysis/latent_analysis.py), at full width and f32
     compute (the CLI's), in phase 7's scratch dir. a. The w2v-base
     experiment at phase 8's flags from phase 8's best model:
     embed_brain_representations and embed_brain over the test split
     (rows 1, 5, 7 f32 and 11 launched). b. The same for phase 7's
     conformer model, brain stream only (rows 1, 3, 7 f32, 9 and 11).
     c. The audio stream: 8 seeded PCM16 clips of 2-6 s at 16 kHz read
     back by load_wav_batches, the front end read from phase 10's w2v-base
     snapshot (hf_snapshot.read_state_dict -> feature_encoder_from_torch,
     bitwise `snapshot_frontend`), then embed_audio_representations
     through the w2v experiment's encoder (T' 299 for 6 s; rows 7 f32 and
     11). d. a, b and c again under the `none` policy (no launch). Fails
     unless each path launched exactly its kernels, pre is embed_brain's
     within ANALYSIS_PRE_TOL and post is not pre, every output is finite
     and of its shape, the post hidden states of each stream under `auto`
     are `none`'s within AUTO_VS_NONE_REL of their largest |x|, and
     representation_statistics of a + c is finite with each
     pca_explained summing to at most 1. Prints each step's seconds, and
     from a second `auto` call of each stream brain samples embedded a
     second and audio seconds embedded a wall second; the phase's seconds.
 13. the train-state crossing, in phase 7's scratch dir. a. `python -m
     wav2vec2forbrain_tpu_torch.convert train-state` (a subprocess) turns
     phase 8's train_state/ into the JAX package's state.msgpack; the w2v
     experiment at phase 8's flags with --epochs=3 and
     --resume_train_state=<its dir> restores it (Trainer.restore_train_state)
     and runs. Fails unless the restored params, BN state, Adam moments and
     count, epoch and history are the state.pt's bitwise, the resumed run
     has 3 epochs (the first two the state's), finite epoch 3 losses and
     exactly the w2v training kernels launched; prints the msgpack's bytes,
     the seconds to convert (a fresh interpreter included), to read and to
     restore, and the resumed run's wall. b. One w2v CLI epoch at
     --batch_size=4 --device_data_cache=on --length_buckets=4
     --length_bucket_order=grouped (an epoch the JAX package runs in K-step
     chunks on a card): fails unless its train batches ran in the loader's
     order stably sorted by bucket width (read from the batches the input
     path hands out) and exactly the w2v training kernels launched; prints
     the order.
 14. tensor parallelism (--mesh_model_parallel=2: parallel/tensor.py's
     Megatron split of the encoder's attention and FFN matmuls), the ranks on
     the one card (this script re-run with --tp-rank / --tp-cli-rank, joined
     by gloo over localhost with CUDA tensors, as phase 11a's). a. (dp, mp)
     (1, 2): two ranks, each an eval forward and one conformer-rope-large
     train step at full width and f32 compute (phase 11a's batch of 32 x 384
     frames, dropout and LayerDrop on, the sweeps' noise) on its 8 of the 16
     heads and 2048 of the 4096 FFN columns; rank 0 then takes the same in
     one process. b. (2, 2): four ranks, one w2v-base step at the fft point
     (biGRU 3 x 1024, batch 64: 32 rows a data index, 6 of 12 heads) under
     ZeRO-1. Fails unless each rank's loss is the one-process loss
     (TP_LOSS_REL), every gradient leaf gathered over the model group and
     the BN running stats are its own elementwise within TP_GRAD_ATOL +
     TP_GRAD_RTOL x |ref|, the params after Adam within
     TRAIN_F32_PARAM_STEPS x their group's LR, the gathered eval logits
     within AUTO_VS_NONE_F32_BOUND, every rank holds the same gathered
     params, each launched exactly its family's training kernels with its
     attention calls at its own (row0, head0), and under ZeRO-1 every moment
     leaf split over both axes holds a quarter of the whole. c. The
     conformer CLI at --mesh_model_parallel=2 on two ranks (run.main in each,
     the gloo group joined first), one epoch on phase 7's splits, against one
     process of the same flags: the test loss within TP_CLI_TEST_LOSS_REL
     (JAX's own bound for its (2, 2) run), model.pt the whole tree, each rank
     at its own head0. Prints each rank's step seconds, its model-group
     all-reduce seconds (gloo through the host: no NCCL figure) and peak
     memory.
 15. the input path (train/device_cache.py, Trainer._stream_for), on
     synthetic splits at phase 7's frame range (train 256, val 48, test 32)
     at f32 compute (the CLI's), for the conformer (phase 7's flags, B32)
     and w2v-base at the fft point (phase 8's, B64, biGRU 3 x 1024), each
     built by the CLI's entry with --device_data_cache=auto (every split
     resident): a. every batch of one train and one val epoch gathered
     from its split's cache is bitwise Trainer._place's batch of the
     collated batch, in every field, at the splits' widths and on a
     --length_buckets=4 grid; b. after a warm-up epoch of each way on the
     val split, one train epoch (Trainer._train_epoch) from the same
     params, Adam and BN state, step RNG and shuffle stream, three ways in
     turns, each twice (the second time under torch.profiler, CUDA
     activity): resident, streamed with --host_prefetch and streamed
     inline; each prints train samples/s, the host ms a step waits for its
     batch, the epoch's seconds and the device's busy share (kernels and
     copies of the profiled run of that way over the run's epoch seconds);
     fails unless the six histories and final params are bitwise equal;
     c. and the six runs' kernel launch counts equal (exactly the family's
     training kernels); d. prints each split's resident bytes and upload
     seconds, and the family's peak memory.
 16. --remat_policy (models/remat.py), in phase 7's scratch dir. a. The
     conformer at phase 15's shape (B32 x 700 frames: T' 168) at f32 compute,
     built as phases 4 and 6 build it (profile_train.build_trainer), two
     train steps under each policy from one set of params, Adam and BN
     state, seed streams (LayerDrop replayed: layer DROPPED_LAYER dropped)
     and batches, `none` first. b. The same for w2v-base at phase 6's point
     (B64 x 384, bf16 compute) under none, min and blocks. Each prints the
     second step's ms, the trainer's peak (params, Adam and BN state and
     the batch, plus the step's own peak over what was allocated before it),
     the bytes the first step's forward keeps (remat.counting: outside the
     checkpointed regions, their inputs, the kept products) and the second
     step's forward launches; fails unless every policy's losses, BN state,
     gradients and updated params are `none`'s (bitwise, else within
     REMAT_REL of each leaf's largest magnitude), the launches a step are
     `none`'s plus, for each forward kernel a checkpointed layer runs, one
     more a layer that ran (under all_but_wide conv_glu's alone), the kept
     bytes and the peak are below `none`'s (for w2v-base the peak before
     its pos-conv's backward, _peak_before_pos_conv_bwd; the step's is
     printed). c. --remat_policy=auto's train steps
     (train/steps.py::RematAuto) from 16a's state, streams and batches:
     under a budget between none's footprint and blocks' the first step
     runs none and the second blocks; with the card filled so that none's
     step runs out of memory, the first step runs again under blocks;
     either way none's steps (remat_auto_steps). Phases 7 and 8 check that
     the CLI's auto, the default, stayed at none. d. Phase 7's
     conformer CLI training run at --remat_policy=min: fails unless its
     test loss is phase 7's (bitwise, or within TP_CLI_TEST_LOSS_REL with
     the reason printed) and exactly the conformer's training kernels
     launched.
Phases 7-9, 11b, 13 and 14c run the CLI with --device_data_cache=auto, so
every split is resident (each rank of 14c holds a replica): they print the
resident splits; the width checks of 7 (the LM decode run), 9 and 13b read
the batches the Trainer's input path hands out (`recorded_batches`).
--phases 1,2,14 runs only those phases (1 always; PHASE_NEEDS adds the
phases a listed one reads); its kernels line has no times without phase 2.
The counts are set to 0 just before each phase's timed run and read just
after it. The second-to-last stdout line is the kernels JSON (one row per
kernel; launches summed over the two training runs, the three CLI training
runs, the LM decode run, the sweep, phase 10's runs a and b, both ranks
of phase 11a, phase 12's three `auto` paths, phase 13's two runs, phase
14's ranks, phase 15's first resident epoch of each family and phase 16's
second steps under min and its CLI run, by path in `launches_by_path`;
`profiler_ms` and `library_profiler_ms` null unless the row's device_ms
was starved), the last line {"ok": true, "device": {...}}.
"""

import contextlib
import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
# f32: the same math as the plain version with sums in another order. The
# forward outputs are O(1): absolute bounds. The backward outputs sum up to
# T*B = 5696 (GRU dW), 384 (preproc dW) or 89 (attention, conv dK, LN
# partials) products and grow with them: bounds relative to the largest
# output, max(1, |ref|).
TOL_F32 = {"preproc": 1e-5, "gru": 2e-5, "attention": 2e-5, "conv_glu": 1e-5, "layernorm": 1e-5,
           "preproc_bwd": 1e-5, "gru_bwd": 2e-5, "attention_bwd": 2e-5, "conv_glu_bwd": 1e-5,
           "layernorm_bwd": 2e-5}
TOL_F32.update(gru_dir=TOL_F32["gru"], gru_dir_bwd=TOL_F32["gru_bwd"])
# at logits 8x larger (phase 2's precision rows) two f32 versions of attention each carry f32
# rounding of s amplified by exp: each is held against the f64 result instead, the kernel to within
# this factor of the plain f32 version's own error (split TF32 keeps ~22 bits of a product, f32 24)
F32_CLASS_FACTOR = 2.0
DROPPED_LAYER = 1  # phases 4 and 6: the encoder layer LayerDrop drops in every train step
# bf16 compute or a bf16 stream: both sides round the same values to bf16,
# but f32 sums taken in another order can flip a bf16 rounding; allow two
# bf16 ulps of the largest output magnitude. The attention mask is
# bit-identical between the kernel and the dense version (the same hash),
# so dropout 0.1 keeps the rate-0 tolerances.
BF16_ULPS = 2.0**-6
AUTO_VS_NONE_F32_BOUND = 1e-3  # logits max-abs, full model at f32
# the f32 train step, `auto` vs `none`, from the same params, Adam state and
# seed streams: the loss and the global gradient norm are sums over the whole
# model of values that differ only in summation order (rel 1e-4); a param
# moves by lr * (m_hat / (sqrt(v_hat) + eps)), and an order-level gradient
# difference moves that by a small fraction of one step: each leaf's max-abs
# difference is held to 0.1 x the LR of its own group (brain 1e-4, w2v 1e-5).
TRAIN_F32_LOSS_REL = 1e-4
TRAIN_F32_GRAD_NORM_REL = 1e-4
TRAIN_F32_PARAM_STEPS = 0.1
N_REQUESTS = N_TRAIN_STEPS = 4
# phases 7-8: the --only_test run evaluates the stored model on the same
# batches at the same widths as the training run's final test evaluation
CLI_TEST_LOSS_REL = 1e-5
# phases 7-8: the CLI flags of each family (besides --epochs=2 and the checkpoint flags)
CLI_FLAGS = {
    "conformer": ["--experiment_type=b2p2t_gru+w2v_conformer", "--batch_size=32", "--return_best_model=true"],
    "w2v": ["--experiment_type=b2p2t_gru+w2v", "--batch_size=64", "--loss_function=ctc",
            "--early_stopping_patience=10", "--learning_rate=0.0001", "--return_best_model=true",
            "--encoder_learnable_inital_state=false", "--unfreeze_strategy=brain_encoder+w2v",
            "--weight_decay=0.0001", "--encoder_dropout=0.45", "--gaussian_smooth_width=1.5",
            "--w2v_learning_rate=0.00001", "--w2v_warmup_steps=3", "--w2v_warmup_start_step=7",
            "--whiteNoiseSD=0.02", "--constantOffsetSD=0.25", "--encoder_fc_hidden_sizes=[]",
            "--encoder_gru_hidden_size=1024", "--encoder_num_gru_layers=3"],
}
LN_EPS = 1e-5
# the bound's rates (NVIDIA's data sheet for the H100 SXM, at 700 W)
HBM_BYTES_PER_S = 3.35e12
# bf16 products on the tensor cores; every f32 product (matmul, recurrence, convolution, smoothing) at the
# fastest rate that keeps f32 accuracy: the TF32 tensor cores (495 TFLOP/s) at three TF32 products each, as
# the split-TF32 kernels do it; other f32 arithmetic (LayerNorm's statistics) at the f32 rate outside them
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
_PALLAS = "wav2vec2forbrain_tpu/ops/"
REPLACES = {
    "preproc": _PALLAS + "pallas_preproc.py:283",
    "preproc_bwd": _PALLAS + "pallas_preproc.py:341",
    "gru": _PALLAS + "pallas_gru.py:286",
    "gru_bwd": _PALLAS + "pallas_gru.py:323",
    "gru_dir": _PALLAS + "pallas_gru.py:643",
    "gru_dir_bwd": _PALLAS + "pallas_gru.py:694",
    "attention": _PALLAS + "pallas_attention.py:210",
    "attention_bwd": _PALLAS + "pallas_attention.py:280",
    "conv_glu": _PALLAS + "pallas_conv_glu.py:152",
    "conv_glu_bwd": _PALLAS + "pallas_conv_glu.py:169",
    "layernorm": _PALLAS + "pallas_layernorm.py:100",
    "layernorm_bwd": _PALLAS + "pallas_layernorm.py:115",
    "ctc": "none: no TPU kernel (the JAX package runs optax.ctc_loss, wav2vec2forbrain_tpu/ops/ctc.py:43)",
    "adam": "none: no TPU kernel (XLA fuses optax's update, wav2vec2forbrain_tpu/train/optim.py)",
}
SOURCES = {name: "wav2vec2forbrain_tpu_torch/csrc/{}.cu".format(name.split("_bwd")[0].replace("gru_dir", "gru"))
           for name in REPLACES}
# the kernels each main path must launch (backward kernels and "adam" only in training; "ctc" wherever a loss is
# taken, serving too: one launch computes the loss and, in training, its gradient)
PATH_KERNELS = {
    "conformer": ("preproc", "gru", "attention", "conv_glu", "layernorm", "ctc"),
    "w2v": ("preproc", "gru_dir", "attention", "layernorm", "ctc"),
    "w2v_sweep": ("preproc", "gru", "attention", "layernorm", "ctc"),  # biGRU H 256: the fused entry
    # phase 12's streams, no loss: the brain encoders' and the audio stream's (front end, no kernel; w2v encoder)
    "conformer_brain": ("preproc", "gru", "attention", "conv_glu", "layernorm"),
    "w2v_brain": ("preproc", "gru_dir", "attention", "layernorm"),
    "w2v_audio": ("attention", "layernorm"),
}
# phase 14c: one conformer CLI epoch on phase 7's splits at the CLI's f32 compute
TP_CLI_FLAGS = CLI_FLAGS["conformer"] + ["--w2v_skip_loading_weights=true", "--epochs=1", f"--seed={SEED}"]
# phase 7's third run (the paper's decode) and phase 9 (the sweep runner)
LM_FLAGS = ["--only_test=true", "--lm_decode_test_predictions=true", "--length_buckets=exact"]
SWEEP_YAML = os.path.join("sweeps", "b2p2t_gru+w2v_training_from_scratch.yaml")
SWEEP_EXTRA = ["--epochs=1", "--length_buckets=4"]
# phase 10: the frozen-encoder sweep (its first point: w2v-base, biGRU 1 x 256, FC [], batch 64) and the two
# pretrained checkpoints whose hub-cache snapshots it writes, with each one's weights file
FROZEN_YAML = os.path.join("sweeps", "b2p2t_gru+w2v_frozen_w2v.yaml")
SNAPSHOTS = {"facebook/wav2vec2-base-960h": "pytorch_model.bin",
             "facebook/wav2vec2-conformer-rope-large-960h-ft": "model.safetensors"}
SNAPSHOT_NOISE = 0.02  # added to the port's init (seeded), so every leaf is off its init value
# each CLI run's path: (the kernels it must launch, PATH_KERNELS' key; training or serving)
# (phase 11a's two ranks: "conformer_dp"; phase 12's paths: "*_analysis")
# (phase 8's second run: "w2v_cli_repeat"; phase 13's: "w2v_resumed", "w2v_grouped"; phase 14's ranks:
# "conformer_tp", "w2v_tp", "conformer_tp_cli"; phase 16's second steps under min: "*_remat", its CLI run:
# "conformer_remat_cli")
CLI_PATHS = {"conformer_cli": ("conformer", True), "conformer_lm": ("conformer", False),
             "w2v_cli": ("w2v", True), "w2v_cli_repeat": ("w2v", True), "w2v_sweep": ("w2v_sweep", True),
             "w2v_frozen": ("w2v_sweep", True), "conformer_pretrained": ("conformer", False),
             "conformer_dp": ("conformer", True), "w2v_analysis": ("w2v_brain", False),
             "conformer_analysis": ("conformer_brain", False), "audio_analysis": ("w2v_audio", False),
             "w2v_resumed": ("w2v", True), "w2v_grouped": ("w2v", True),
             "conformer_tp": ("conformer", True), "w2v_tp": ("w2v", True), "conformer_tp_cli": ("conformer", True),
             "conformer_input": ("conformer", True), "w2v_input": ("w2v", True),
             "conformer_remat": ("conformer", True), "w2v_remat": ("w2v", True),
             "conformer_remat_cli": ("conformer", True)}
# the configuration each row of the kernels JSON is timed at: a training run's
ROW_LABELS = {
    "preproc": "B32 T384 sigma0.3 f32",
    "gru": "H256 B32 layer0 bfloat16",
    "gru_dir": "H1024 B64 layer0 bfloat16",
    "attention": "B32 T89 16x64 scale0.125 io float32 cd bfloat16 p0.1",
    "conv_glu": "B32 T89 C1024 io float32 cd bfloat16",
    "layernorm": "B64 T89 C768 float32",
}
ROW_LABELS.update({f"{k}_bwd": v for k, v in list(ROW_LABELS.items())})
ROW_LABELS["ctc"] = "B64 T'169 K32"  # phase 8's batch at its longest trials (700 frames)
ROW_LABELS["adam"] = "conformer leaves f32 moments"  # the conformer.train cell's optimizer step
ADAM_DROPPED = "/w2v/encoder/layers/1/"  # phase 2's Adam rows: the dropped encoder layer (no gradients)
# phase 2's CTC rows: the NLL relative to its largest value (f32 sums of T' log-sum-exps taken in another
# order); the gradient, a difference of probabilities (|g| <= 1), absolute: both f32 versions put sums of
# magnitude |nll| (hundreds) in the exponent of each term, and each sits ~1e-4 off the f64 result at T' 169,
# so the kernel is also held to F32_CLASS_FACTOR x the plain version's own distance from F.ctc_loss at f64
CTC_NLL_REL = 1e-5
CTC_GRAD_ABS = 1e-3
CTC_CALLS = 20
# phase 11a: the two ranks' step against one process's, f32 sums taken in another order (the GRU, preproc and
# LN kernels at 16 rows, the BN statistics as sums over the ranks): the loss, each gradient leaf against its own
# largest magnitude (at least 1), the BN running stats against max(1, |ref|)
DP_LOSS_REL = 1e-5
DP_GRAD_REL = 1e-4
DP_BN_REL = 1e-5
DP_ROWS = 16  # rows a rank: phase 4's batch of 32 over 2 ranks
DP_TIMEOUT = 420  # seconds for phase 11a's ranks
# phase 14: tensor parallelism over a model axis of 2, the ranks on the one card (gloo). a: (dp, mp) (1, 2), the
# conformer; b: (2, 2), w2v-base under ZeRO-1. Against one process: the loss (f32 sums in another order), every
# gathered gradient leaf and the BN stats elementwise within atol + rtol x |ref| (tests/test_torch_parallel.py's),
# the params after Adam within TRAIN_F32_PARAM_STEPS x the LR of their group, the eval logits within
# AUTO_VS_NONE_F32_BOUND; c: the CLI's test loss within JAX's own bound for its (2, 2) run
TP_MODEL = 2
TP_CASES = {"a": dict(family="conformer", world=2, zero1=False), "b": dict(family="w2v", world=4, zero1=True)}
TP_ROWS = {"conformer": 32, "w2v": 64}  # profile_train.FAMILIES' batch sizes
FAMILY_HEADS = {"conformer": 16, "w2v": 12}
TP_LOSS_REL = 1e-5
# Adam's eps in phase 14a / b (tests/test_torch_train_step.py's): at the default 1e-8 an element whose gradient is
# near 0 takes an update of either sign from an order-level difference; at 1e-4 such a difference d moves a param
# by at most lr * d / eps
TP_ADAM_EPS = 1e-4
TP_GRAD_ATOL = TP_GRAD_RTOL = 1e-4
TP_CLI_TEST_LOSS_REL = 2e-4
TP_TIMEOUT = 480  # seconds for a phase 14 group of ranks
TP_MIN_SPLIT_TWICE = 72  # phase 14b: w2v-base's q, k, v, out, FFN up and down kernels, 12 layers (their mu)
# phase 15: phase 7's frame range; train 256 (2 sessions x 144 trials in 9 blocks; the first block is test, 32),
# val 48 (2 x 24 in test/)
INPUT_SPLITS = dict(n_trials=144, n_blocks=9, test_dir_n_trials=24)
INPUT_WAYS = ("resident", "prefetch", "inline")
INPUT_BUCKETS = 4
# phase 16: --remat_policy (models/remat.py). a: the conformer at phase 15's shape (B32, 700 frames: T' 168) at f32
# compute under every policy; b: w2v-base at phase 6's point under these; the forward kernels a checkpointed layer
# runs (each launches again in the recompute: a policy's count a step is `none`'s plus this many times the layers
# that ran; under all_but_wide only the kernels of the layer's wide sections); a policy's step against `none`'s:
# bitwise, else the largest leaf difference relative to the leaf's largest magnitude, at most REMAT_REL
REMAT_FRAMES = 700
REMAT_W2V_POLICIES = ("none", "min", "blocks")
LAYER_FWD_KERNELS = {"conformer": {"attention": 1, "conv_glu": 1, "layernorm": 5},
                     "w2v": {"attention": 1, "layernorm": 2}}
WIDE_FWD_KERNELS = ("conv_glu",)
REMAT_REL = 1e-6
LAST_PHASE = 16
# --phases: the earlier phases whose results a phase reads (11b phase 7's test loss; 12 phase 7 and 8's models
# and phase 10's snapshot; 13 phase 8's train state; 16 phase 7's test loss)
PHASE_NEEDS = {11: {7}, 12: {7, 8, 10}, 13: {8}, 16: {7}}
TP_HEADS_BATCH = 16  # phase 2's rows at head0: a batch of 16
# phase 12: the audio clips (the first 6 s long: T' 299), the front end's seed in the snapshot, pre against
# embed_brain (the same kernels on the same inputs, f32), post `auto` against `none` (PERF.md §2's f32 rule)
AUDIO_CLIPS = 8
AUDIO_RATE = 16000
FRONTEND_SEED = SEED + 20
ANALYSIS_PRE_TOL = 1e-5
AUTO_VS_NONE_REL = 1e-3
FAMILY_NAMES = {
    "conformer": "b2p2t_gru+w2v_conformer: conformer-rope-large (24 x d1024, 16 heads, FFN 4096, k31), biGRU 2 x 256",
    "w2v": "b2p2t_gru+w2v: wav2vec2-base-960h (12 x d768 post-LN, 12 heads, FFN 3072), biGRU 3 x 1024",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_SPIN_MS_PER_CYCLE = []  # device ms per cycle of torch.cuda._sleep, measured once


def device_ms(fn, reps: int = 10, trials: int = 5):
    """(ms, starved): the device time of fn() in ms with the queue kept full:
    the stream is held by a spin kernel while reps calls are queued behind
    it, so the calls run back to back and the host's launch overhead drops
    out (as it does in a device-bound step). Median over trials of (end -
    start) / reps. A trial in which queueing took longer on the host clock
    than the spin lasted on the device is run again with a longer spin;
    after the longest one it is kept and `starved` is True: either the
    launch queue was full (many launches a call, as the per-direction
    GRU's: the device was busy throughout) or the host was slower than the
    device (host time is in it). compare() then also takes profiler_ms."""
    import torch

    if not _SPIN_MS_PER_CYCLE:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        b.synchronize()
        _SPIN_MS_PER_CYCLE.append(a.elapsed_time(b) / 20_000_000)
        print(f"  (device_ms: a spin of 2e7 cycles holds the stream {a.elapsed_time(b):.3f} ms)")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, spin, starved_any = [], 5_000_000, False
    while len(times) < trials:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        starved = 1e3 * (time.perf_counter() - t0) > spin * _SPIN_MS_PER_CYCLE[0]
        end.synchronize()
        if starved and spin < 500_000_000:
            spin *= 4
            continue
        starved_any = starved_any or starved
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), starved_any


def _device_kernels(fn, reps: int):
    """[(device us, launches, name)] of every kernel and copy that reps calls
    of fn() ran on the card, largest first, as torch.profiler recorded them
    (each kernel's own time, without the gaps between launches). A session
    can lose launches (PERF.md §7)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wav2vec2forbrain_tpu_torch.profile_predict import _device_us, _on_device

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted(((_device_us(e), e.count, e.key) for e in prof.key_averages() if _on_device(e)), reverse=True)


def profiler_ms(fn, reps: int = 5) -> float:
    """The device time of fn() in ms as the sum of its kernels' own device
    times per call (torch.profiler): the second measure of a row whose
    device_ms trial ended starved. It leaves out the gaps between launches."""
    return sum(us for us, _, _ in _device_kernels(fn, reps)) / reps / 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(bytes_moved, flops):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their type's peak; flops is a list
    of (count, dtype name)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[dt] for n, dt in flops)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def compare(name, label, kernel_fn, plain_fn, tol_of, results, inputs, flops, library_fn=None):
    """Run kernel and plain on the same inputs, check every output, time;
    append a row. A kernel returning several outputs is held output by
    output; the row keeps the largest error and its tolerance. The bound
    counts `inputs` read once and the kernel's outputs written once."""
    import torch

    from wav2vec2forbrain_tpu_torch.ops import kernels

    before = kernels.LAUNCHES[name]
    outs = kernel_fn()
    torch.cuda.synchronize()
    if kernels.LAUNCHES[name] != before + 1:
        fail(f"{name} [{label}]: the wrapper did not launch its kernel")
    refs = plain_fn()
    torch.cuda.synchronize()
    if not isinstance(outs, tuple):
        outs, refs = (outs,), (refs,)
    ok, err, tol = True, 0.0, 0.0
    for out, ref in zip(outs, refs):
        out = out.reshape(ref.shape)
        if out.dtype != ref.dtype:
            fail(f"{name} [{label}]: kernel {out.dtype} vs plain {ref.dtype}")
        e = (out.float() - ref.float()).abs().max().item()
        t = tol_of(ref)
        ok = ok and bool(torch.isfinite(out).all().item()) and e <= t
        if e / t >= err / max(tol, 1e-30):
            err, tol = e, t
    bound, bound_by = bound_ms(nbytes(*inputs, *outs), flops)
    del outs, refs
    ms, starved = device_ms(kernel_fn)
    call_ms = timed_ms(kernel_fn)
    plain_ms = timed_ms(plain_fn, iters=5, warmup=1)
    library_ms, library_starved = (None, False) if library_fn is None else device_ms(library_fn)
    library_call_ms = None if library_fn is None else timed_ms(library_fn)
    # a starved trial has host time in it: time the kernel and the library a second way
    prof_ms = library_prof_ms = None
    if starved or library_starved:
        prof_ms = profiler_ms(kernel_fn)
        library_prof_ms = None if library_fn is None else profiler_ms(library_fn)
    torch.cuda.synchronize()

    def mark(is_starved, prof):
        return "" if prof is None else f" [{'starved; ' if is_starved else ''}profiler {prof:.4f}]"

    lib = ("" if library_ms is None else
           f"  library {library_ms:.4f} ms{mark(library_starved, library_prof_ms)} (call {library_call_ms:.4f})")
    print(f"  {name:13s} {label:42s} max_abs_err {err:.3e} (tol {tol:.1e}) kernel {ms:.4f} ms"
          f"{mark(starved, prof_ms)} (call {call_ms:.4f})  plain {plain_ms:.4f} ms{lib}  "
          f"bound {bound:.4f} ms ({bound_by})  {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} [{label}]: kernel disagrees with its plain version ({err} > {tol})")
    results.append(dict(name=name, label=label, err=err, ms=ms, profiler_ms=prof_ms, call_ms=call_ms,
                        plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=library_ms,
                        library_profiler_ms=library_prof_ms))


def kernel_split(label, fn, per_call: dict, reps: int = 5, top: int = 6) -> None:
    """Print the device time of each kernel that fn() launches (torch.profiler
    over reps calls; each kernel's own time, without the gaps between
    launches). A kernel whose name holds a key of per_call launches that many
    times a call: its line is its mean time per recorded launch times that
    count, and says how many launches were recorded where the session lost
    some. Any other kernel's line is its mean time per recorded launch and
    the launches recorded over the reps calls."""
    parts = []
    for us, n, name in _device_kernels(fn, reps)[:top]:
        k = next((v for key, v in per_call.items() if key in name), None)
        if k is None:
            parts.append(f"{name[:48]} {us / n / 1e3:.4f} ms a launch, {n} in {reps} calls")
        else:
            lost = "" if n == k * reps else f" ({n} of {k * reps} launches recorded)"
            parts.append(f"{name[:48]} {us / n * k / 1e3:.4f} ms x{k}{lost}")
    print(f"  {'':13s} {label:42s} split: {'; '.join(parts)}")


def cudnn_gru(gi, w_hh, b_hh, h0, gy, cd, ys):
    """The library yardstick of the GRU rows: (forward, backward) of one
    bidirectional nn.GRU call (cuDNN) that computes the recurrence on gi.
    Its input is [gi_fwd, gi_bwd flipped in time] (T, B, 6H); each
    direction's W_ih is the identity on its half, b_ih = 0. That input
    projection (and its weight gradient) is work the kernel does not do, so
    the times are upper bounds of the library's. The f32 forward is held to
    the plain ys, which checks the construction. A bf16 nn.GRU that the
    installed torch refuses gives (None, None)."""
    import torch

    t, _, b, h = ys.shape
    flip = lambda x: torch.flip(x, dims=(0,))  # noqa: E731
    mod = torch.nn.GRU(6 * h, h, bidirectional=True, device=gi.device, dtype=cd)
    mod.flatten_parameters()  # one weight buffer, as cuDNN wants it
    with torch.no_grad():
        eye = torch.eye(3 * h, device=gi.device)
        for d, sfx in enumerate(("", "_reverse")):
            w_ih = torch.zeros((3 * h, 6 * h), device=gi.device)
            w_ih[:, 3 * h * d: 3 * h * (d + 1)] = eye
            getattr(mod, "weight_ih_l0" + sfx).copy_(w_ih)
            getattr(mod, "weight_hh_l0" + sfx).copy_(w_hh[d].t())
            getattr(mod, "bias_ih_l0" + sfx).zero_()
            getattr(mod, "bias_hh_l0" + sfx).copy_(b_hh[d].reshape(-1))
        del eye, w_ih
    inp = torch.cat([gi[:, 0], flip(gi[:, 1])], dim=-1).to(cd).requires_grad_(True)
    hx = h0.to(cd)
    g_out = torch.cat([gy[:, 0], flip(gy[:, 1])], dim=-1).to(cd)
    try:
        out, _ = mod(inp, hx)
    except RuntimeError as e:
        if cd == torch.float32:
            raise
        print(f"  (no library time: nn.GRU at {cd} raised {str(e).splitlines()[0]})")
        return None, None
    if cd == torch.float32:
        got = torch.stack([out[..., :h], flip(out[..., h:])], dim=1)
        err = (got - ys).abs().max().item()
        if not err <= 1e-3:
            fail(f"the cuDNN GRU yardstick does not compute the recurrence (max-abs {err} vs plain)")
    leaves = [inp, *mod.parameters()]

    def fwd():
        with torch.no_grad():
            return mod(inp, hx)

    return fwd, lambda: torch.autograd.grad(out, leaves, g_out, retain_graph=True)


def kernel_phases(dev, results):
    import torch
    import torch.nn.functional as F

    from wav2vec2forbrain_tpu_torch.models.gru import bigru_inputs, init_gru_params
    from wav2vec2forbrain_tpu_torch.models.preprocessing import gaussian_kernel
    from wav2vec2forbrain_tpu_torch.ops import attention, conv_glu, ctc, gru, layernorm, preproc

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32

    def f32_tol(name):
        return lambda ref: TOL_F32[name]

    def f32_rel_tol(name):
        return lambda ref: TOL_F32[name] * max(1.0, ref.float().abs().max().item())

    def bf16_tol(ref):
        return BF16_ULPS * max(1.0, ref.float().abs().max().item())

    def cd_name(cd):
        return str(cd)[6:]

    def product_rate(cd):
        """The PEAK_FLOPS key of products in the compute dtype cd."""
        return "tf32x3" if cd == f32 else cd_name(cd)

    def preproc_rows(gen, batch, sigma, others=False):
        """preproc at T=384, days spread over 0..23 (the chain is f32 only);
        with `others` the forward also at T=99 and at kernel_len 20, stride 3."""
        x = torch.randn((batch, 384, 256), generator=gen, device=dev)
        w = torch.eye(256, device=dev)[None] + 0.05 * torch.randn((24, 256, 256), generator=gen, device=dev)
        b = 0.1 * torch.randn((24, 1, 256), generator=gen, device=dev)
        days = torch.arange(batch, device=dev) % 24
        taps = gaussian_kernel(20, sigma, dev)
        affine, smooth = 2 * x.numel() * 256, 2 * x.numel() * taps.numel()
        label = f"B{batch} T384 sigma{sigma} f32"
        shapes = [(x, 32, 4, label)]
        if others:
            shapes += [(x[:, :99].contiguous(), 32, 4, f"B{batch} T99 sigma{sigma} f32"), (x, 20, 3, f"{label} k20 s3")]
        for xs, k, stride, at in shapes:
            ops = [(2 * xs.numel() * 256, "tf32x3"), (2 * xs.numel() * taps.numel(), "tf32x3")]
            compare("preproc", at, lambda: preproc._fwd_kernel(xs, w, b, days, taps, k, stride),
                    lambda: preproc.fused_preproc_plain(xs, w, b, days, taps, k, stride), f32_tol("preproc"),
                    results, (xs, w, b, days, taps), ops)
            kernel_split(at, lambda: preproc._fwd_kernel(xs, w, b, days, taps, k, stride),
                         {"preproc_fwd_affine": 1, "preproc_fwd_unfold": 1})
        gp = 0.1 * torch.randn((batch, 89, 8192), generator=gen, device=dev)
        # dx through W^T and the per-sample dW: two affine-sized products; the smoothing and its adjoint
        compare("preproc_bwd", label, lambda: preproc._bwd_kernel(x, w, b, days, taps, gp, 32, 4),
                lambda: preproc.fused_preproc_bwd_plain(x, w, b, days, taps, gp), f32_rel_tol("preproc_bwd"),
                results, (x, w, b, days, taps, gp), [(2 * affine, "tf32x3"), (2 * smooth, "tf32x3")])
        kernel_split(label, lambda: preproc._bwd_kernel(x, w, b, days, taps, gp, 32, 4),
                     {"preproc_bwd_gather": 1, "preproc_bwd_dz_dy": 1, "preproc_bwd_dw_dx": 1})

    def attention_rows(gen, batch, heads, scale, q_scale, t=89, rows=None, row0=0, backward=True):
        """attention at T'=t, heads of 64, eval (rate 0) and train (rate 0.1,
        seed 77); q is multiplied by q_scale in the stream dtype first (the
        wav2vec2 encoder's pre-scaling); rows: the (stream, compute dtype,
        rate) triples to run; row0: the global batch index of row 0 (a
        data-parallel rank's, which keys the dropout mask); backward=False: the
        forward rows only (an eval path's). The library call: F.scaled_dot_product_attention
        at rate 0 (forward, and its backward), in the stream dtype (at f32 its
        memory-efficient kernel, split TF32 on the tensor cores)."""
        width = 64 * heads
        for sd in (f32, bf16):
            if rows is not None and all(sd != o[0] for o in rows):
                continue
            q, k, v, ga = (torch.randn((batch, t, width), generator=gen, device=dev).to(sd) for _ in range(4))
            q = q * q_scale
            hs = [x.view(batch, t, heads, 64).transpose(1, 2) for x in (q, k, v, ga)]
            leaves = [t.detach().requires_grad_(True) for t in hs[:3]]
            sdpa_out = F.scaled_dot_product_attention(*leaves, scale=scale)
            sdpa_fwd = lambda: F.scaled_dot_product_attention(*hs[:3], scale=scale)  # noqa: E731
            sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, leaves, hs[3], retain_graph=True)  # noqa: E731
            qkt = 2 * batch * heads * t * t * 64  # one (T, D) x (D, T) product per (batch, head)
            for cd in (f32, bf16):
                if sd == bf16 and cd == f32:
                    continue
                for rate in (0.0, 0.1):
                    if rows is not None and (sd, cd, rate) not in rows:
                        continue
                    label = f"B{batch} T{t} {heads}x64 scale{scale:g} io {cd_name(sd)} cd {cd_name(cd)} p{rate}"
                    label += f" row0 {row0}" if row0 else ""
                    compare("attention", label,
                            lambda: attention._fwd_kernel(q, k, v, heads, scale, rate, cd, 77, row0),
                            lambda: attention.mha_dense_bth(q, k, v, heads, scale, rate, cd, 77, row0),
                            f32_tol("attention") if cd == f32 else bf16_tol, results,
                            (q, k, v), [(2 * qkt, product_rate(cd))], sdpa_fwd)
                    if not backward:
                        continue
                    compare("attention_bwd", label,
                            lambda: attention._bwd_kernel(q, k, v, ga, heads, scale, rate, cd, 77, row0),
                            lambda: attention.mha_bwd_plain(q, k, v, ga, heads, scale, rate, cd, 77, row0),
                            f32_rel_tol("attention_bwd") if cd == f32 else bf16_tol, results,
                            (q, k, v, ga), [(5 * qkt, product_rate(cd))], sdpa_bwd)
            del sdpa_out

    def attention_head0_rows(gen, batch, total, mp, t=89):
        """attention at model index mp - 1 of a model axis of mp: its total /
        mp heads of 64 at head0 = the heads before them, scale 1/8, rate 0.1
        (seed 77), an f32 stream at f32 and bf16 compute, forward and
        backward, each against the plain version at the same head0; and
        bitwise the whole call's (all `total` heads, head0 0) columns of
        those heads: the masks of a rank's heads are the layer's."""
        heads = total // mp
        head0 = total - heads
        cols = slice(64 * head0, 64 * total)
        whole = [torch.randn((batch, t, 64 * total), generator=gen, device=dev) for _ in range(4)]
        q, k, v, ga = (x[:, :, cols].contiguous() for x in whole)
        qkt = 2 * batch * heads * t * t * 64
        for cd in (f32, bf16):
            label = f"B{batch} T{t} {heads}x64 scale0.125 io float32 cd {cd_name(cd)} p0.1 head0 {head0}"
            args = (0.125, 0.1, cd, 77, 0, head0)
            compare("attention", label, lambda: attention._fwd_kernel(q, k, v, heads, *args),
                    lambda: attention.mha_dense_bth(q, k, v, heads, *args),
                    f32_tol("attention") if cd == f32 else bf16_tol, results, (q, k, v), [(2 * qkt, product_rate(cd))])
            compare("attention_bwd", label, lambda: attention._bwd_kernel(q, k, v, ga, heads, *args),
                    lambda: attention.mha_bwd_plain(q, k, v, ga, heads, *args),
                    f32_rel_tol("attention_bwd") if cd == f32 else bf16_tol, results, (q, k, v, ga),
                    [(5 * qkt, product_rate(cd))])
            mine = [attention._fwd_kernel(q, k, v, heads, *args), *attention._bwd_kernel(q, k, v, ga, heads, *args)]
            full = [attention._fwd_kernel(*whole[:3], total, 0.125, 0.1, cd, 77),
                    *attention._bwd_kernel(*whole, total, 0.125, 0.1, cd, 77)]
            same = [torch.equal(m, f[:, :, cols]) for m, f in zip(mine, full)]
            print(f"  {'':13s} {label:42s} bitwise the {total}-head call's heads {head0}..{total - 1} "
                  f"(o, dq, dk, dv): {same}")
            if not all(same):
                fail(f"attention [{label}]: a rank's heads differ from the whole call's")
            del mine, full

    def attention_f64(q, k, v, ga, heads, scale, rate, seed):
        """(o, dq, dk, dv) of the attention function in f64 on f64 copies of
        its operands: the exact result that the f32 versions round."""
        b, t, width = q.shape
        qh, kh, vh, gh = (x.double().view(b, t, heads, width // heads).transpose(1, 2).reshape(b * heads, t, -1)
                          for x in (q, k, v, ga))
        p = torch.softmax(torch.bmm(qh, kh.transpose(1, 2)) * scale, dim=-1)
        masked = attention._scaled_mask(seed, b, heads, t, rate, q.device)
        mask = None if masked is None else masked[0].double() * masked[1]
        pd = p if mask is None else p * mask
        dp = torch.bmm(gh, vh.transpose(1, 2))
        dp = dp if mask is None else dp * mask
        ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
        outs = (torch.bmm(pd, vh), torch.bmm(ds, kh) * scale, torch.bmm(ds.transpose(1, 2), qh) * scale,
                torch.bmm(pd.transpose(1, 2), gh))
        return [attention._unheads(x, b, heads, torch.float64) for x in outs]

    def attention_precision_rows(gen, batch, heads, t=89):
        """f32 compute at logits 8x those of the other rows: the w2v shape at
        scale 1 with q not pre-scaled, so s = q.k over 64 unit normals (std 8),
        where the f32 rounding of s moves p by 8x more. The kernel, the plain
        version and SDPA at f32 (rate 0), each against the f64 result; the
        kernel and SDPA against the plain version, the kernel's distance beside
        TOL_F32 (abs for the output, relative to the largest one for the
        gradients), which it may exceed here. Fails unless each of the
        kernel's outputs is within F32_CLASS_FACTOR x the plain f32 version's
        own error of the f64 result."""
        width = 64 * heads
        q, k, v, ga = (torch.randn((batch, t, width), generator=gen, device=dev) for _ in range(4))
        hs = [x.view(batch, t, heads, 64).transpose(1, 2) for x in (q, k, v)]
        leaves = [x.detach().requires_grad_(True) for x in hs]
        for rate in (0.0, 0.1):
            args = (heads, 1.0, rate, f32, 77)
            exact = attention_f64(q, k, v, ga, heads, 1.0, rate, 77)
            kern = [attention._fwd_kernel(q, k, v, *args), *attention._bwd_kernel(q, k, v, ga, *args)]
            plain = [attention.mha_dense_bth(q, k, v, *args), *attention.mha_bwd_plain(q, k, v, ga, *args)]
            sdpa = None
            if rate == 0.0:  # SDPA's dropout is not the hash mask
                out = F.scaled_dot_product_attention(*leaves, scale=1.0)
                grads = torch.autograd.grad(out, leaves, ga.view(batch, t, heads, 64).transpose(1, 2))
                sdpa = [x.transpose(1, 2).reshape(batch, t, width) for x in (out, *grads)]
            for i, what in enumerate(("o", "dq", "dk", "dv")):
                def err(x):
                    return (x.double() - exact[i]).abs().max().item()
                vs_plain = (kern[i] - plain[i]).abs().max().item()
                tol = TOL_F32["attention"] if i == 0 else f32_rel_tol("attention_bwd")(plain[i])
                k64, p64 = err(kern[i]), err(plain[i])
                lib = ("" if sdpa is None else
                       f" sdpa {err(sdpa[i]):.3e} (sdpa vs plain {(sdpa[i] - plain[i]).abs().max().item():.3e})")
                ok = k64 <= F32_CLASS_FACTOR * p64
                print(f"  {'attention':13s} {f'B{batch} T{t} {heads}x64 scale1 logits x8 f32 p{rate} {what}':42s} "
                      f"vs f64: kernel {k64:.3e} plain {p64:.3e}{lib}; kernel vs plain {vs_plain:.3e} "
                      f"({'within' if vs_plain <= tol else 'over'} TOL_F32 {tol:.1e})  {'ok' if ok else 'LESS ACCURATE'}")
                if not ok:
                    fail(f"attention logits x8 p{rate} {what}: kernel {k64} off the f64 result, over "
                         f"{F32_CLASS_FACTOR} x the plain f32 version's {p64}")
            del exact, kern, plain, sdpa

    def ctc_tol(ref):
        return CTC_NLL_REL * max(1.0, ref.abs().max().item()) if ref.dim() == 1 else CTC_GRAD_ABS

    def ctc_rows(gen, batch=64, vocab=32):
        """The CTC loss and its gradient at T' 89, 169 and 230: ragged logit lengths, targets of up to T' / 3
        tokens, sample 1 without an alignment, sample 2 an empty target."""
        for t in (89, 169, 230):
            lp = F.log_softmax(torch.randn((batch, t, vocab), generator=gen, device=dev), dim=-1)
            in_lens = torch.randint(t // 2, t + 1, (batch,), generator=gen, device=dev)
            tgt_lens = torch.randint(1, t // 3 + 1, (batch,), generator=gen, device=dev)
            targets = torch.randint(1, vocab, (batch, t // 3), generator=gen, device=dev).int()
            in_lens[0], in_lens[1], tgt_lens[1], tgt_lens[2] = t, 1, 2, 0
            in_lens, tgt_lens = in_lens.int(), tgt_lens.int()

            def plain(x=lp):
                x = x.detach().requires_grad_()
                nll = ctc.ctc_nll_plain(x, targets, in_lens, tgt_lens)
                return nll.detach(), torch.autograd.grad(nll, x, torch.ones_like(nll))[0]

            def kern():
                return ctc._ctc_kernel(lp, targets, in_lens, tgt_lens, 0, True)

            # the work this data needs: the alpha and beta recursions over each sample's T_b x (2 L_b + 1)
            # states (3 exp, a log and ~8 flops each), the gradient's sums (an exp and ~4 flops a state) and
            # its (t, class) terms (two exp and ~3 flops), all f32
            states = int((in_lens.long() * (2 * tgt_lens.long() + 1)).sum())
            flops = states * (2 * 12 + 5) + int(in_lens.sum()) * vocab * 5
            label = f"B{batch} T'{t} K{vocab}"
            compare("ctc", label, kern, plain, ctc_tol, results, (lp, targets, in_lens, tgt_lens),
                    [(flops, "float32")], plain)
            first = kern()
            same = all(torch.equal(a, b) for _ in range(CTC_CALLS - 1) for a, b in zip(kern(), first))
            g64 = plain(lp.double())[1]
            k64 = (first[1].double() - g64).abs().max().item()
            p64 = (plain()[1].double() - g64).abs().max().item()
            print(f"  {'':13s} {label:42s} {CTC_CALLS} calls bitwise equal: {same}; gradient vs f64: kernel "
                  f"{k64:.3e} plain {p64:.3e} (bound {F32_CLASS_FACTOR} x plain)")
            if not same or not k64 <= F32_CLASS_FACTOR * p64:
                fail(f"ctc {label}: the kernel is not reproducible ({same}) or off the f64 gradient ({k64} vs "
                     f"plain {p64})")

    # 1. preproc: B=32 with the conformer's smoothing (sigma 0.3); the w2v shape's rows are in 6
    preproc_rows(g, 32, 0.3, others=True)

    # 2. GRU recurrence, T=89: H=256, B=32 (conformer; layer-0 and layer-1
    # gi) and B=64 (the sweep grid's H=256 points) through gru_recurrence;
    # H=512 and 1024, B=64 (wav2vec2-base sweep) through the per-direction
    # entry, whose dW_hh product is f32
    for h, batch, layers, per_dir in ((256, 32, (0, 1), False), (256, 64, (0,), False), (512, 64, (0,), True),
                                      (1024, 64, (0,), True), (600, 64, (0,), True)):
        name = "gru_dir" if per_dir else "gru"
        params = init_gru_params(g, 8192, h, 2, True, True, False, dev)
        x0 = torch.rand((batch, 89, 8192), generator=g, device=dev) * 2 - 1
        x1 = torch.rand((batch, 89, 2 * h), generator=g, device=dev) * 2 - 1
        h0 = torch.zeros((2, batch, h), device=dev)
        for layer in layers:
            for cd in (f32, bf16):
                gi, w_hh, b_hh = bigru_inputs(params["layers"][layer]["directions"], x0 if layer == 0 else x1, cd)
                gi, w_cd = gi.detach(), w_hh.to(cd)
                label = f"H{h} B{batch} layer{layer} {cd_name(cd)}"
                step = 2 * batch * h * 3 * h * 2 * 89  # one (B, H) x (H, 3H) product per direction and step
                ys = gru.gru_recurrence_plain(gi, w_hh, b_hh, h0, cd)
                gy = torch.randn(ys.shape, generator=g, device=dev)
                lib_fwd, lib_bwd = cudnn_gru(gi, w_hh, b_hh, h0, gy, cd, ys)
                compare(name, label,
                        lambda: gru._fwd_kernel(gi, w_hh, b_hh, h0, cd, per_dir),
                        lambda: gru.gru_recurrence_plain(gi, w_hh, b_hh, h0, cd),
                        f32_tol(name) if cd == f32 else bf16_tol, results,
                        (gi, w_cd, b_hh, h0), [(step, product_rate(cd))], lib_fwd)
                r = results[-1]  # the forward's time per step
                per_call, by = (r["ms"], "") if r["profiler_ms"] is None else (r["profiler_ms"], " (profiler)")
                print(f"  {'':13s} {label:42s} {1e3 * per_call / gi.shape[0]:.2f} us per step{by}")
                # gh recomputed and dh's product with W^T in the compute dtype; dW in it or in f32
                compare(f"{name}_bwd", label,
                        lambda: gru._bwd_kernel(gi, w_hh, b_hh, h0, ys, gy, cd, per_dir),
                        lambda: gru.gru_recurrence_bwd_plain(gi, w_hh, b_hh, h0, ys, gy, cd, per_dir),
                        f32_rel_tol(f"{name}_bwd") if cd == f32 else bf16_tol, results,
                        (gi, w_cd, b_hh, h0, ys, gy),
                        [(2 * step, product_rate(cd)), (step, "tf32x3" if per_dir else product_rate(cd))], lib_bwd)
                if not per_dir:  # the backward's kernels: hprev, gh, the step launches (T + 1), dW
                    kernel_split(label, lambda: gru._bwd_kernel(gi, w_hh, b_hh, h0, ys, gy, cd),
                                 {"gru_hprev": 1, "gru_gh": 1, "gru_bwd_step": gi.shape[0] + 1, "gru_dw": 1})
                else:  # the step launches alone, without the f32 dW / db product that follows them
                    rec_ms = timed_ms(lambda: gru._dir_bwd_recurrence(gi, w_hh, b_hh, h0, ys, gy, cd))
                    print(f"  {'':13s} {label:42s} recurrence alone {rec_ms:.4f} ms "
                          f"(the entry: {results[-1]['ms']:.4f} ms)")
                del gi, ys, gy, lib_fwd, lib_bwd
        del params, x0, x1

    # 3. attention: the conformer's B=32, 16 heads of 64 at scale 1/8; then rank 1's rows of it at data
    # parallel 2 (phase 11a): B=16 at row0 16, dropout on, at f32 and bf16 compute; then model index 1's
    # heads of it at tensor parallel 2 (phase 14): 8 of 16 at head0 8, B=16
    attention_rows(g, 32, 16, 0.125, 1.0)
    attention_rows(g, DP_ROWS, 16, 0.125, 1.0, rows=[(f32, f32, 0.1), (f32, bf16, 0.1)], row0=DP_ROWS)
    attention_head0_rows(g, TP_HEADS_BATCH, 16, 2)

    # 4. GLU -> depthwise conv: B=32, T=89, C=1024, k=31 (no one PyTorch call computes it); then
    # B=8 at T=169 and T=400, several of the backward's 96-frame chunks (T=400: past the whole-sequence
    # backward's reach)
    wdw = (torch.rand((31, 1024), generator=g, device=dev) * 2 - 1) * (3.0 / 31) ** 0.5
    for (batch, t), sd in itertools.product(((32, 89), (8, 169), (8, 400)), (f32, bf16)):
        conv = 2 * batch * t * 1024 * 31
        y = torch.randn((batch, t, 2048), generator=g, device=dev).to(sd)
        dz = torch.randn((batch, t, 1024), generator=g, device=dev).to(sd)
        for cd in (f32, bf16):
            if sd == bf16 and cd == f32:
                continue
            label = f"B{batch} T{t} C1024 io {cd_name(sd)} cd {cd_name(cd)}"
            exact = cd == f32 and sd == f32
            compare("conv_glu", label,
                    lambda: conv_glu._fwd_kernel(y, wdw, cd),
                    lambda: conv_glu.glu_dwconv_plain(y, wdw, cd),
                    f32_tol("conv_glu") if exact else bf16_tol, results,
                    (y, wdw), [(conv, product_rate(cd))])
            compare("conv_glu_bwd", label,
                    lambda: conv_glu._bwd_kernel(y, wdw, dz, cd),
                    lambda: conv_glu.glu_dwconv_bwd_plain(y, wdw, dz, cd),
                    f32_rel_tol("conv_glu_bwd") if exact else bf16_tol, results,
                    (y, wdw, dz), [(2 * conv, product_rate(cd))])

    # 5. LayerNorm at the wav2vec2-base (64 x 89 x 768) and conformer (32 x
    # 89 x 1024) shapes, f32 and bf16 streams. The library call: F.layer_norm
    # (forward) and its backward
    for shape in ((64, 89, 768), (32, 89, 1024)):
        c = shape[-1]
        scale = 1 + 0.3 * torch.randn(c, generator=g, device=dev)
        bias = 0.2 * torch.randn(c, generator=g, device=dev)
        for sd in (f32, bf16):
            xs = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(sd)
            dys = torch.randn(shape, generator=g, device=dev).to(sd)
            label = f"B{shape[0]} T{shape[1]} C{c} {cd_name(sd)}"
            elems = xs.numel()
            if sd == f32:
                leaves = [t.detach().requires_grad_(True) for t in (xs, scale, bias)]
                ln_out = F.layer_norm(leaves[0], (c,), leaves[1], leaves[2], LN_EPS)
                ln_fwd = lambda: F.layer_norm(xs, (c,), scale, bias, LN_EPS)  # noqa: E731
                ln_bwd = lambda: torch.autograd.grad(ln_out, leaves, dys, retain_graph=True)  # noqa: E731
            else:  # F.layer_norm takes its weights in the input's dtype: no library row at a bf16 stream
                ln_fwd = ln_bwd = None
            compare("layernorm", label,
                    lambda: layernorm._fwd_kernel(xs, scale, bias, LN_EPS),
                    lambda: layernorm.layer_norm_plain(xs, scale, bias, LN_EPS),
                    f32_tol("layernorm") if sd == f32 else bf16_tol, results,
                    (xs, scale, bias), [(7 * elems, "float32")], ln_fwd)
            compare("layernorm_bwd", label,
                    lambda: layernorm._bwd_kernel(xs, scale, dys, LN_EPS),
                    lambda: layernorm.layer_norm_bwd_plain(xs, scale, dys, LN_EPS),
                    f32_rel_tol("layernorm_bwd") if sd == f32 else bf16_tol, results,
                    (xs, scale, dys), [(14 * elems, "float32")], ln_bwd)

    # 6. the wav2vec2-base path's shapes of the kernels it shares with the
    # conformer (inputs from their own seed): preproc at B=64 with the sweep's
    # smoothing (sigma 1.5); attention at B=64, 12 heads of 64 with q
    # pre-scaled by 1/8 in the stream dtype and the kernel at scale 1
    g_w2v = torch.Generator(device=dev).manual_seed(SEED + 1)
    preproc_rows(g_w2v, 64, 1.5)
    attention_rows(g_w2v, 64, 12, 1.0, 0.125)
    # 7. attention at T'=169 (B=32, 16 heads: the conformer's shape at ~700 frames) and at T'=400 (B=8,
    # ~1,600 frames: key tiles streamed), an f32 stream: bf16 compute in the training setting, f32
    # compute (the split-TF32 kernels) at both rates
    long_rows = [(f32, bf16, 0.1), (f32, f32, 0.0), (f32, f32, 0.1)]
    attention_rows(torch.Generator(device=dev).manual_seed(SEED + 2), 32, 16, 0.125, 1.0, t=169, rows=long_rows)
    attention_rows(torch.Generator(device=dev).manual_seed(SEED + 3), 8, 16, 0.125, 1.0, t=400, rows=long_rows)
    # 8. the audio stream's attention forward (phase 12): B=8 clips of up to 6 s, T'=299 after the conv front
    # end, the w2v heads (q pre-scaled by 1/8, scale 1), eval (rate 0), an f32 stream at f32 compute (the
    # CLI's) and at bf16 compute
    attention_rows(torch.Generator(device=dev).manual_seed(SEED + 5), 8, 12, 1.0, 0.125, t=299,
                   rows=[(f32, f32, 0.0), (f32, bf16, 0.0)], backward=False)
    # 9. attention at f32 compute with logits 8x larger, against the f64 result
    attention_precision_rows(torch.Generator(device=dev).manual_seed(SEED + 4), 64, 12)
    # 10. the CTC loss and its gradient (csrc/ctc.cu; no TPU kernel) at the w2v-base CLI's batch, B=64:
    # F.ctc_loss forward and backward is the plain version and the library call
    ctc_rows(torch.Generator(device=dev).manual_seed(SEED + 6))
    # 11. Adam (csrc/adam.cu; no TPU kernel) at both train cells' full leaf sets
    for family in ("conformer", "w2v"):
        adam_row(dev, family, results)


def adam_row(dev, family, results):
    """Phase 2's Adam row of one family (the module docstring): the bound
    counts p, g, m and v read once and p, m and v written once (bytes at
    3.35 TB/s), ~15 f32 operations an element."""
    import torch

    from wav2vec2forbrain_tpu_torch.models.assembly import init_model_params, param_labels
    from wav2vec2forbrain_tpu_torch.ops import kernels, select
    from wav2vec2forbrain_tpu_torch.profile_train import BRAIN_LR, FAMILIES, W2V_LR
    from wav2vec2forbrain_tpu_torch.train.optim import AdamState, make_optimizer
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves, tree_map_with_path

    spec, _ = _spec_and_batch(family)
    params, _ = init_model_params(torch.Generator(device=dev).manual_seed(SEED + 7), spec, dev)
    labels = param_labels(params, "brain_encoder+w2v")
    opt = make_optimizer(labels, "adam", FAMILIES[family][1])
    state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    grads = tree_map_with_path(lambda path, p, lab: None if lab == "frozen" or path.startswith(ADAM_DROPPED) else
                               torch.randn(p.shape, generator=gen, device=dev) * 1e-2, params, labels)
    label = f"{'conformer' if family == 'conformer' else 'w2v-base'} leaves f32 moments"
    leaves = opt.trained_leaves(params, grads, state, BRAIN_LR, W2V_LR)
    elems = sum(t.p.numel() for t in leaves)
    moved = sum(t.p.numel() * 8 + (0 if t.g is None else t.g.numel() * 4)
                + 2 * (t.m.numel() * t.m.element_size() + t.v.numel() * t.v.element_size()) for t in leaves)
    bound, bound_by = bound_ms(moved, [(15 * elems, "float32")])

    out = [state]

    def step_of(policy):
        def step():
            select.set_kernel_policy(policy)
            out[0] = opt.step(params, grads, out[0], BRAIN_LR, W2V_LR)
        return step

    # one step each way from one state, bitwise
    sides = {}
    for policy in ("auto", "none"):
        select.set_kernel_policy(policy)
        p, st = _clone(params), AdamState(0, _clone(state.mu), _clone(state.nu))
        before = kernels.LAUNCHES["adam"]
        st = opt.step(p, grads, st, BRAIN_LR, W2V_LR)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["adam"] - before != (policy == "auto"):
            fail(f"adam [{label}]: {kernels.LAUNCHES['adam'] - before} launches under {policy}")
        sides[policy] = tree_leaves(p) + tree_leaves(st.mu) + tree_leaves(st.nu)
    select.set_kernel_policy("auto")
    err = max((a - b).abs().max().item() for a, b in zip(*sides.values()))
    bitwise = all(torch.equal(a, b) for a, b in zip(*sides.values()))
    del sides, p, st
    ms, starved = device_ms(step_of("auto"))
    prof_ms = profiler_ms(step_of("auto")) if starved else None
    call_ms = timed_ms(step_of("auto"))
    plain_ms = timed_ms(step_of("none"), iters=5, warmup=1)
    select.set_kernel_policy("auto")
    torch.cuda.synchronize()
    mark = "" if prof_ms is None else f" [starved; profiler {prof_ms:.4f}]"
    print(f"  {'adam':13s} {label:42s} max_abs_err {err:.3e} (bitwise {bitwise}) kernel {ms:.4f} ms{mark} "
          f"(call {call_ms:.4f})  plain {plain_ms:.4f} ms  bound {bound:.4f} ms ({bound_by}; {len(leaves)} leaves, "
          f"{elems / 1e6:.1f}M elements, {moved / 1e9:.2f} GB)  {'ok' if bitwise else 'MISMATCH'}")
    if not bitwise:
        fail(f"adam [{label}]: the kernel's step differs from the loop's (max-abs {err})")
    results.append(dict(name="adam", label=label, err=err, ms=ms, profiler_ms=prof_ms, call_ms=call_ms,
                        plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=None,
                        library_profiler_ms=None))
    del params, grads, state, out, opt
    torch.cuda.empty_cache()


def _spec_and_batch(family):
    import torch

    from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec
    from wav2vec2forbrain_tpu_torch.profile_train import FAMILIES

    fields, _, batch_size = FAMILIES[family]
    return ModelSpec(compute_dtype=torch.bfloat16, activation_dtype=torch.float32, **fields), batch_size


def _check_launches(launches, family, train):
    """Every kernel of the family's path launched, no other kernel did."""
    want = set(PATH_KERNELS[family])
    if train:
        want |= {f"{k}_bwd" for k in want} | {"adam"}
    wrong = sorted(k for k, v in launches.items() if (v > 0) != (k in want))
    if wrong:
        fail(f"{family} {'training' if train else 'serving'}: kernels launched against the path: "
             f"{ {k: launches[k] for k in wrong} } (expected exactly {sorted(want)})")


def serve_phase(dev, device_name, power, family):
    """Phases 3 and 5; returns (launches, samples/s auto, samples/s none)."""
    import dataclasses

    import numpy as np
    import torch

    from wav2vec2forbrain_tpu_torch.data.batch import to_device
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
    from wav2vec2forbrain_tpu_torch.models.assembly import init_model_params
    from wav2vec2forbrain_tpu_torch.ops import kernels, select
    from wav2vec2forbrain_tpu_torch.predict import predict
    from wav2vec2forbrain_tpu_torch.train.steps import build_eval_step
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    spec, batch_size = _spec_and_batch(family)
    t = time.perf_counter()
    params, state = init_model_params(torch.Generator(device=dev).manual_seed(SEED), spec, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"  model: {FAMILY_NAMES[family]}, {n_params / 1e6:.1f}M params, init {time.perf_counter() - t:.2f} s")
    batches = make_requests(N_REQUESTS, batch_size, 384, SEED)
    expected_lens = [(b.input_lens - 32) // 4 for b in batches]

    def check(i, preds):
        logits = preds["logits"]
        if logits.shape != (batch_size, 89, 32):
            fail(f"{family} batch {i}: logits shape {logits.shape} != ({batch_size}, 89, 32)")
        if not np.isfinite(logits).all():
            fail(f"{family} batch {i}: non-finite logits")
        if not np.array_equal(preds["logit_lens"], expected_lens[i]):
            fail(f"{family} batch {i}: logit_lens {preds['logit_lens']} != (input_lens - 32) // 4")
        if not np.isfinite(preds["loss"]) or preds["loss"] <= 0:
            fail(f"{family} batch {i}: CTC loss {preds['loss']} (expected finite and > 0)")

    select.set_kernel_policy("auto")
    predict(params, state, spec, batches[:1])  # warm-up: cuBLAS handles, kernel load
    torch.cuda.synchronize()

    kernels.reset_launches()
    t = time.perf_counter()
    history = predict(params, state, spec, batches, on_batch=check)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    avg = history.get_average()
    n = sum(b.input.shape[0] for b in batches)
    print(f"  predict (auto, bf16 compute, f32 stream): {len(batches)} requests x {batch_size} samples "
          f"in {wall:.3f} s = {n / wall:.1f} samples/s on {device_name} ({power})")
    print(f"  test loss {avg.loss:.4f}  WER {avg.metrics['word_error_rate']:.4f}  "
          f"CER {avg.metrics['char_error_rate']:.4f} (random weights: proves the path, not quality)")
    print(f"  kernel launches in the predict run: {json.dumps(launches)}")
    _check_launches(launches, family, train=False)

    select.set_kernel_policy("none")
    t = time.perf_counter()
    predict(params, state, spec, batches)
    torch.cuda.synchronize()
    wall_none = time.perf_counter() - t
    print(f"  predict (none: plain PyTorch for every kernel): {n / wall_none:.1f} samples/s")

    step = build_eval_step(dataclasses.replace(spec, compute_dtype=torch.float32))
    batch = to_device(batches[0], dev)
    logits = {}
    for policy in ("auto", "none"):
        select.set_kernel_policy(policy)
        logits[policy] = step(params, state, batch)[1]
        torch.cuda.synchronize()
    select.set_kernel_policy("auto")
    diff = (logits["auto"] - logits["none"]).abs().max().item()
    print(f"  f32 logits, auto vs none: max_abs_diff {diff:.3e} (bound {AUTO_VS_NONE_F32_BOUND:.0e}), "
          f"max |logit| {logits['none'].abs().max().item():.3f}")
    if not diff <= AUTO_VS_NONE_F32_BOUND:
        fail(f"{family}: auto vs none logits differ by {diff}")
    return launches, n / wall, n / wall_none


def _clone(tree):
    from wav2vec2forbrain_tpu_torch.tree import tree_map

    return tree_map(lambda t: None if t is None else t.detach().clone(), tree)


def _layer_of(path):
    """The encoder layer index of a param path, or None."""
    parts = path.split("/")
    if "encoder" in parts and "layers" in parts:
        return int(parts[parts.index("layers") + 1])
    return None


def _layerdrop_rng(seed, dev, n_layers, steps):
    """A StepRng of `steps` steps whose encoder streams replay a LayerDrop
    mask (models/seeds.py) that drops layer DROPPED_LAYER and keeps every
    other layer; their dropout seeds come from numpy, the GRU and head
    streams from CPU generators, all from `seed`."""
    import numpy as np
    import torch

    from wav2vec2forbrain_tpu_torch.models.seeds import INT32_MAX, ForwardRng, SeedStream, StepRng

    rs = np.random.default_rng(seed)
    mask = [i == DROPPED_LAYER for i in range(n_layers)]

    def stream():
        return SeedStream(torch.Generator().manual_seed(int(rs.integers(2**62))))

    replay = [ForwardRng(stream(), SeedStream(seeds=rs.integers(0, INT32_MAX, 4096).tolist(), layerdrop=[mask]),
                         stream()) for _ in range(steps)]
    return StepRng(seed, dev, replay=replay)


def train_phase(dev, device_name, power, family):
    """Phases 4 and 6; returns (launches, steps/s, samples/s) of the timed run."""
    import dataclasses

    import numpy as np
    import torch

    from wav2vec2forbrain_tpu_torch.data.batch import to_device
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
    from wav2vec2forbrain_tpu_torch.ops import kernels, select
    from wav2vec2forbrain_tpu_torch.profile_train import BRAIN_LR, STEP_CFG, W2V_LR, build_trainer
    from wav2vec2forbrain_tpu_torch.train.optim import AdamState
    from wav2vec2forbrain_tpu_torch.train.steps import build_grad_fn
    from wav2vec2forbrain_tpu_torch.train.train_loop import train_batches
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves, tree_leaves_with_path as leaves

    select.set_kernel_policy("auto")
    t = time.perf_counter()
    tr = build_trainer(dev, SEED, family)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(tr.params))
    print(f"  model: {FAMILY_NAMES[family]}, {n_params / 1e6:.1f}M params; bf16 compute, f32 stream, "
          f"GRU dropout {tr.spec.gru_dropout}, Adam weight decay {tr.optimizer.weight_decay}; "
          f"init {time.perf_counter() - t:.2f} s")
    bsz = tr.batch_size
    batches = make_requests(N_TRAIN_STEPS + 1, bsz, 384, SEED + 1)
    enc_cfg = tr.spec.w2v_cfg if tr.spec.encoder_family == "wav2vec2" else tr.spec.conformer_cfg
    n_layers = enc_cfg.num_hidden_layers
    rng = _layerdrop_rng(SEED, dev, n_layers, len(batches))
    # warm-up step: cuBLAS handles, the kernels' first launches, Adam state
    run = train_batches(tr.train_step, tr.params, tr.opt_state, tr.state, batches[:1], rng, BRAIN_LR, W2V_LR)
    torch.cuda.synchronize()
    before = dict(leaves(_clone(tr.params)))
    state_before = _clone(run.model_state)

    kernels.reset_launches()
    t = time.perf_counter()
    run = train_batches(tr.train_step, tr.params, run.opt_state, run.model_state, batches[1:], rng,
                        BRAIN_LR, W2V_LR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    n = sum(b.input.shape[0] for b in batches[1:])
    print(f"  train_batches (auto): {run.steps} steps x {bsz} samples in {wall:.3f} s = "
          f"{run.steps / wall:.3f} steps/s, {n / wall:.1f} samples/s on {device_name} ({power})")
    losses = [m.loss for m in run.history.metrics]
    avg = run.history.get_average()
    print(f"  train losses {[round(x, 4) for x in losses]}  WER {avg.metrics['word_error_rate']:.4f}  "
          f"CER {avg.metrics.get('char_error_rate', float('nan')):.4f}")
    print(f"  kernel launches in the train run: {json.dumps(launches)}")
    _check_launches(launches, family, train=True)
    if not all(np.isfinite(losses)):
        fail(f"{family}: non-finite train loss {losses}")

    # which layers ran in some step (LayerDrop decisions of every step, warm-up included)
    masks = [f.enc.layerdrop_drawn[0] for f in rng.forwards]
    ran = [not all(m[i] for m in masks) for i in range(len(masks[0]))]
    print(f"  LayerDrop (replayed): layers dropped per step {[[i for i, d in enumerate(m) if d] for m in masks]}")
    if len(masks) != len(batches) or ran[DROPPED_LAYER] or not all(ran[:DROPPED_LAYER] + ran[DROPPED_LAYER + 1:]):
        fail(f"{family}: the LayerDrop replay did not drop exactly layer {DROPPED_LAYER} in all "
             f"{len(batches)} steps: {masks}")
    label_of = dict(leaves(tr.labels))
    wrong = []
    for path, p in leaves(tr.params):
        if not bool(torch.isfinite(p).all()):
            fail(f"{family}: non-finite parameter after training: {path}")
        moved = not torch.equal(p, before[path])
        layer = _layer_of(path)
        if label_of[path] == "frozen":
            expect = False
        elif layer is not None and not ran[layer]:
            # no gradient: only weight decay moves it, and not a leaf that is all zeros
            expect = tr.optimizer.weight_decay > 0 and bool(before[path].ne(0).any())
        else:
            # the conformer's pos_conv is a dead parity param (its forward never applies it)
            expect = not (family == "conformer" and "/pos_conv/" in path)
        if moved != expect:
            wrong.append((path, moved, expect))
    if wrong:
        fail(f"{family}: params moved (or stayed) against expectation: {wrong[:8]} ({len(wrong)} in all)")
    if family == "conformer":
        for i, (new, old) in enumerate(zip(run.model_state["encoder"]["layers"], state_before["encoder"]["layers"])):
            changed = not torch.equal(new["batch_norm"]["mean"], old["batch_norm"]["mean"])
            if changed != ran[i]:
                fail(f"layer {i}: BN running stats {'changed' if changed else 'unchanged'} but the layer "
                     f"{'ran' if ran[i] else 'was dropped in every step'}")
        print(f"  BN stats updated in the {sum(ran)} layers that ran")
    print("  every trainable leaf of the layers that ran moved (the conformer's dead pos_conv excepted), "
          "frozen leaves did not; a layer dropped in every step moved only by weight decay "
          f"({tr.optimizer.weight_decay})")

    # one f32 step under `auto` and under `none` from the same state and seed streams
    spec32 = dataclasses.replace(tr.spec, compute_dtype=torch.float32)
    batch = to_device(batches[-1], dev)
    res = {}
    for policy in ("auto", "none"):
        select.set_kernel_policy(policy)
        params = _clone(tr.params)
        state = _clone(run.model_state)
        opt_state = AdamState(run.opt_state.count, _clone(run.opt_state.mu), _clone(run.opt_state.nu))
        grad_fn = build_grad_fn(spec32, tr.labels, STEP_CFG)
        kernels.reset_launches()
        # the same replay: layer DROPPED_LAYER, whose Adam moments are still 0, stays dropped (a first
        # Adam step moves each weight by ~lr * sign(g), which an order-level gradient difference flips)
        out, grads, norm = grad_fn(params, state, batch, _layerdrop_rng(SEED + 7, dev, n_layers, 1))
        if policy == "auto":  # at f32 compute attention takes the split-TF32 kernels (D <= 128)
            print(f"  kernel launches in the f32 step (auto): {json.dumps(dict(kernels.LAUNCHES))}")
        if not all(bool(torch.isfinite(gr).all()) for gr in tree_leaves(grads)):
            fail(f"{family}: non-finite gradient at f32 under {policy}")
        tr.optimizer.step(params, grads, opt_state, BRAIN_LR, W2V_LR)
        torch.cuda.synchronize()
        res[policy] = (float(out["loss"].detach()), float(norm), params)
        del out, grads
    select.set_kernel_policy("auto")
    (la, na, pa), (ln, nn, pn) = res["auto"], res["none"]
    loss_rel, norm_rel = abs(la - ln) / abs(ln), abs(na - nn) / abs(nn)
    # each leaf against 0.1 x its own group's LR; the worst leaf of each group
    lr_of = {"brain": BRAIN_LR, "w2v": W2V_LR}
    worst = {}  # group -> (ratio to its bound, max-abs, path)
    for (path, a), (_, b) in zip(leaves(pa), leaves(pn)):
        d = (a - b).abs().max().item()
        label = label_of[path]
        ratio = d / (TRAIN_F32_PARAM_STEPS * lr_of[label]) if label in lr_of else (0.0 if d == 0 else float("inf"))
        if label not in worst or ratio > worst[label][0]:
            worst[label] = (ratio, d, path)
    print(f"  f32 step, auto vs none: loss {la:.6f} vs {ln:.6f} (rel {loss_rel:.2e}, bound {TRAIN_F32_LOSS_REL:.0e}); "
          f"grad norm {na:.6f} vs {nn:.6f} (rel {norm_rel:.2e}, bound {TRAIN_F32_GRAD_NORM_REL:.0e})")
    for label, (ratio, d, path) in sorted(worst.items()):
        bound = TRAIN_F32_PARAM_STEPS * lr_of.get(label, 0.0)
        print(f"  updated params, group {label}: max-abs {d:.3e} at {path} (bound {bound:.1e}, "
              f"{ratio:.3f} of it)")
    if not (loss_rel <= TRAIN_F32_LOSS_REL and norm_rel <= TRAIN_F32_GRAD_NORM_REL
            and all(r <= 1.0 for r, _, _ in worst.values())):
        fail(f"{family}: the f32 train step differs between `auto` and `none` beyond its bounds")
    del res, pa, pn, tr, run
    torch.cuda.empty_cache()
    return launches, N_TRAIN_STEPS / wall, n / wall


def _cli_run(argv):
    """run.main(argv) on the card; (experiment, wall seconds)."""
    import torch

    from wav2vec2forbrain_tpu_torch import run

    t = time.perf_counter()
    exp = run.main(argv)
    torch.cuda.synchronize()
    return exp, time.perf_counter() - t


def cli_phase(device_name, power, family, test_losses, models):
    """Phases 7 and 8; returns {path: launches} of the CLI training run (and
    of the conformer's LM decode run); test_losses[family] = the training
    run's test loss, models[family] = its best model's model.pt."""
    import math

    import torch

    from wav2vec2forbrain_tpu_torch.ops import kernels, select
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    common = ["--w2v_skip_loading_weights=true", "--epochs=2", "--checkpoint_every_n_epochs=1",
              f"--seed={SEED}"]
    argv = CLI_FLAGS[family] + common
    print(f"  python -m wav2vec2forbrain_tpu_torch.run {' '.join(argv)}")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    exp, wall = _cli_run(argv + [f"--results_subdir_name={family}_train"])
    launches = dict(kernels.LAUNCHES)
    results = exp.results_dir
    for name in ("config.json", "history.json", "metrics.jsonl", "model.pt", os.path.join("train_state", "state.pt")):
        if not os.path.exists(os.path.join(results, name)):
            fail(f"{family} CLI: {name} missing from {results}")
    if exp.device.type != "cuda" or not all(p.is_cuda for p in tree_leaves(exp.params) + tree_leaves(exp.model_state)):
        fail(f"{family} CLI: the experiment left the card ({exp.device})")
    with open(os.path.join(results, "history.json")) as f:
        hist = json.load(f)
    with open(os.path.join(results, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [e[s]["average"]["loss"] for e in hist["epochs"] for s in ("train", "val")]
    test_loss = hist["test"]["average"]["loss"]
    test_losses[family] = test_loss
    models[family] = os.path.join(results, "model.pt")
    if len(hist["epochs"]) != 2 or not all(math.isfinite(x) for x in losses + [test_loss]):
        fail(f"{family} CLI: {len(hist['epochs'])} epochs, losses {losses}, test {test_loss}")
    sps = [r["train_samples_per_sec"] for r in rows if "train_samples_per_sec" in r]
    n_train = len(exp.dataloader_train.dataset)
    print(f"  training run: {wall:.2f} s wall for 2 epochs of {n_train} samples (batches "
          f"{[len(b) for b in exp.dataloader_train.iter_index_batches()]}), train samples/s per epoch {sps}, "
          f"batch widths (T, U) {exp.batch_widths}, resident splits {sorted(exp.get_device_caches())}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {device_name} ({power})")
    print(f"  epoch losses (train, val) {[round(x, 4) for x in losses]}; test loss {test_loss!r}, "
          f"WER {hist['test']['average']['metrics'].get('word_error_rate')}")
    print(f"  kernel launches in the CLI training run: {json.dumps(launches)}")
    _check_launches(launches, family, train=True)
    auto = exp.remat_auto  # --remat_policy=auto, the default: none fits this run's batches
    print(f"  --remat_policy=auto: {None if auto is None else auto.policy} after the run, its watched batch shapes "
          f"{None if auto is None else sorted(auto.fitted)}")
    if auto is None or auto.policy != "none" or not auto.fitted:
        fail(f"{family} CLI: --remat_policy=auto left none (or watched no step)")
    out = {f"{family}_cli": launches}
    if family == "w2v":  # the same run again: bitwise the first
        kernels.reset_launches()
        again, wall_again = _cli_run(argv + [f"--results_subdir_name={family}_train_repeat"])
        out[f"{family}_cli_repeat"] = dict(kernels.LAUNCHES)
        with open(os.path.join(again.results_dir, "history.json")) as f:
            same_history = json.load(f) == hist

        def trees(e):
            return (tree_leaves(e.params) + tree_leaves(e.model_state) + tree_leaves(e.opt_state.mu)
                    + tree_leaves(e.opt_state.nu))

        same = (same_history and exp.opt_state.count == again.opt_state.count
                and all(torch.equal(a, b) for a, b in zip(trees(exp), trees(again))))
        print(f"  the training run again from seed {SEED}: {wall_again:.2f} s wall (the first {wall:.2f} s); "
              f"history.json equal {same_history}; final params, BN state, Adam count and moments bitwise "
              f"equal {same}")
        if not same or out[f"{family}_cli_repeat"] != launches:
            fail(f"{family} CLI: two trainings from one seed differ (history {same_history}, leaves {same}, "
                 f"launches {out[f'{family}_cli_repeat']} vs {launches})")
        del again
        torch.cuda.empty_cache()

    kernels.reset_launches()
    only, wall_test = _cli_run(argv + [f"--results_subdir_name={family}_only_test", "--only_test=true",
                                       f"--from_checkpoint={os.path.join(results, 'model.pt')}"])
    test_launches = dict(kernels.LAUNCHES)
    pred_path = os.path.join(only.results_dir, "test_predictions.json")
    if not os.path.exists(pred_path):
        fail(f"{family} CLI: test_predictions.json missing from {only.results_dir}")
    with open(pred_path) as f:
        only_loss = json.load(f)["average"]["loss"]
    rel = abs(only_loss - test_loss) / abs(test_loss)
    print(f"  --only_test run: {wall_test:.2f} s wall; test loss {only_loss!r} vs the training run's "
          f"{test_loss!r}: rel {rel:.2e} (bound {CLI_TEST_LOSS_REL:.0e}), bitwise equal {only_loss == test_loss}")
    print(f"  kernel launches in the --only_test run: {json.dumps(test_launches)}")
    _check_launches(test_launches, family, train=False)
    if not (math.isfinite(only_loss) and rel <= CLI_TEST_LOSS_REL):
        fail(f"{family} CLI: the --only_test loss {only_loss} is not the training run's {test_loss}")
    select.set_kernel_policy("auto")
    del only
    torch.cuda.empty_cache()
    if family == "conformer":
        out["conformer_lm"] = lm_run(argv, os.path.join(results, "model.pt"), device_name, power)
    del exp
    torch.cuda.empty_cache()
    return out


def write_arpa(sentences, path):
    """A 3-gram ARPA of the sentences' maximum-likelihood n-grams (with <s>
    and </s>; every n-gram's prefix is an (n-1)-gram, backoffs log10 0.5)."""
    import math
    from collections import Counter

    counts = [Counter() for _ in range(3)]
    for sentence in sentences:
        words = ["<s>"] + sentence.upper().split() + ["</s>"]
        for n in range(3):
            for i in range(len(words) - n):
                counts[n][tuple(words[i:i + n + 1])] += 1
    counts[0][("<unk>",)] = 1
    total = sum(c for w, c in counts[0].items() if w != ("<s>",))
    lines = ["\\data\\"] + [f"ngram {n + 1}={len(counts[n])}" for n in range(3)]
    for n in range(3):
        lines += ["", f"\\{n + 1}-grams:"]
        for gram, c in sorted(counts[n].items()):
            denom = total if n == 0 else counts[n - 1][gram[:-1]]
            logp = -99.0 if gram == ("<s>",) else math.log10(c / denom)
            backoff = "" if n == 2 or gram[-1] == "</s>" else f"\t{math.log10(0.5):.4f}"
            lines.append(f"{logp:.6f}\t{' '.join(gram)}{backoff}")
    lines += ["", "\\end\\", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


class _RecordedStream:
    """A Trainer epoch's batch stream that records each batch it hands out."""

    def __init__(self, stream, trainer, split, seen):
        self.stream, self.trainer, self.split, self.seen = stream, trainer, split, seen

    def __iter__(self):
        return self

    def __next__(self):
        from wav2vec2forbrain_tpu_torch.util.seq import round_up

        t = time.perf_counter()
        batch, true_b, mask_total, host = item = next(self.stream)
        host_s = time.perf_counter() - t
        exp = self.trainer.experiment
        longest = int(host.input_lens.max())
        self.seen.append((self.split, batch.input.shape[1 + exp.time_axis],
                          round_up(longest, exp.base_config.pad_to_multiple), longest, host_s))
        return item

    def close(self):
        self.stream.close()


@contextlib.contextmanager
def recorded_batches():
    """[(split, time width run, the collate's time width, the longest trial,
    host seconds the epoch waited for the batch)] of every batch the
    Trainer's epochs and predictions take from their input path
    (Trainer._stream_for: gathered on the card or collated and placed)
    while the block runs."""
    from wav2vec2forbrain_tpu_torch.train import train_loop

    stream_for = train_loop.Trainer._stream_for
    seen = []

    def recording(self, loader, split, grouped):
        return _RecordedStream(stream_for(self, loader, split, grouped), self, split, seen)

    train_loop.Trainer._stream_for = recording
    try:
        yield seen
    finally:
        train_loop.Trainer._stream_for = stream_for


@contextlib.contextmanager
def timed_decodes():
    """Host seconds of every CTCBeamDecoder.decode_batch call while the block runs."""
    from wav2vec2forbrain_tpu_torch.decode import lm_decode

    decode = lm_decode.CTCBeamDecoder.decode_batch
    seconds = []

    def timed(self, *args, **kwargs):
        t = time.perf_counter()
        out = decode(self, *args, **kwargs)
        seconds.append(time.perf_counter() - t)
        return out

    lm_decode.CTCBeamDecoder.decode_batch = timed
    try:
        yield seconds
    finally:
        lm_decode.CTCBeamDecoder.decode_batch = decode


def lm_run(argv, model_path, device_name, power):
    """Phase 7's third run; returns its launches."""
    import math

    import torch

    from wav2vec2forbrain_tpu_torch.ops import kernels
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    flags = argv + ["--results_subdir_name=conformer_lm", *LM_FLAGS, f"--from_checkpoint={model_path}"]
    print(f"  python -m wav2vec2forbrain_tpu_torch.run ... {' '.join(flags[len(argv):])}")
    kernels.reset_launches()
    with recorded_batches() as seen, timed_decodes() as decode_s:
        exp, wall = _cli_run(flags)
    widths = [b[:3] for b in seen]
    launches = dict(kernels.LAUNCHES)
    with open(os.path.join(exp.results_dir, "test_predictions.json")) as f:
        pred = json.load(f)
    order = exp.lm_decoder.decoder.lm_order
    metrics = pred["average"]["metrics"]
    lm_wer, lm_cer = metrics.get("word_error_rate_lm_decode"), metrics.get("char_error_rate_lm_decode")
    print(f"  LM decode run: {wall:.2f} s wall; LM order {order}; test loss {pred['average']['loss']!r}; "
          f"WER {metrics.get('word_error_rate')} CER {metrics.get('char_error_rate')}; "
          f"LM WER {lm_wer} CER {lm_cer}; on {device_name} ({power})")
    print(f"  batch widths (split, run, collate): {widths}; length buckets {exp.t_buckets}; resident splits "
          f"{sorted(exp.get_device_caches())}")
    print(f"  LM decode host seconds per test batch (beam {exp.base_config.lm_decode_beam_width}, "
          f"{len(pred['history'])} batches): {[round(x, 4) for x in decode_s]}")
    print(f"  kernel launches in the LM decode run: {json.dumps(launches)}")
    if order != 3:
        fail(f"conformer LM decode: the decoder's LM order is {order}, not 3")
    if not pred["history"] or not all("predictions_lm_decoded" in b["batch"] for b in pred["history"]):
        fail("conformer LM decode: a stored test batch lacks predictions_lm_decoded")
    if not (lm_wer is not None and lm_cer is not None and math.isfinite(lm_wer) and math.isfinite(lm_cer)):
        fail(f"conformer LM decode: LM WER {lm_wer}, CER {lm_cer}")
    if not exp.t_buckets or not widths or any(run != collate for _, run, collate in widths):
        fail(f"conformer LM decode: batches off their collate's width under exact buckets: {widths}, "
             f"buckets {exp.t_buckets}")
    if exp.device.type != "cuda" or not all(p.is_cuda for p in tree_leaves(exp.params) + tree_leaves(exp.model_state)):
        fail(f"conformer LM decode: the experiment left the card ({exp.device})")
    _check_launches(launches, "conformer", train=False)
    del exp
    torch.cuda.empty_cache()
    return launches


def sweep_phase(work, device_name, power):
    """Phase 9; returns the sweep's launches."""
    import math

    import torch

    from wav2vec2forbrain_tpu_torch import sweep
    from wav2vec2forbrain_tpu_torch.ops import kernels
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    repo = os.path.dirname(os.path.abspath(__file__))
    argv = [os.path.join(repo, SWEEP_YAML), "--max_runs", "2", "--config_yaml", os.path.join(work, "config.yaml"),
            "--extra", *SWEEP_EXTRA, f"--seed={SEED}"]
    print(f"  python -m wav2vec2forbrain_tpu_torch.sweep {' '.join(argv)}")
    points = []  # (wall, buckets, [(split, width run, collate width)], params on the card)
    kernels.reset_launches()
    with recorded_batches() as seen:
        def launch(flags):
            start = len(seen)
            exp, wall = _cli_run(flags)
            points.append((wall, exp.t_buckets, [b[:3] for b in seen[start:]],
                           all(p.is_cuda for p in tree_leaves(exp.params))))
            return 0

        summary, best = sweep.main(argv, launch=sweep.in_process(launch))
    launches = dict(kernels.LAUNCHES)
    torch.cuda.empty_cache()
    with open(summary) as f:
        rows = [json.loads(line) for line in f]
    for (wall, buckets, seen, on_card), row in zip(points, rows):
        print(f"  point {row['run']} {row['params']}: {wall:.2f} s wall, test_ctc_loss {row['test_ctc_loss']!r}, "
              f"rc {row['returncode']}, params on the card {on_card}")
        print(f"    length buckets {buckets}; batch widths (split, run, collate) {seen}")
    print(f"  best {best}; on {device_name} ({power})")
    print(f"  kernel launches in the sweep: {json.dumps(launches)}")
    losses = [row["test_ctc_loss"] for row in rows]
    if len(rows) != 2 or any(row["returncode"] != 0 for row in rows) or not all(p[3] for p in points):
        fail(f"sweep: {len(rows)} rows, return codes {[row['returncode'] for row in rows]}, params on the card "
             f"{[p[3] for p in points]}")
    if not all(x is not None and math.isfinite(x) for x in losses):
        fail(f"sweep: test_ctc_loss {losses}")
    if best is None or best[0] != min(losses):
        fail(f"sweep: best {best} is not the smaller of {losses}")
    for _, buckets, seen, _ in points:
        if not buckets or not seen or any(run not in buckets[split] or run < collate for split, run, collate in seen):
            fail(f"sweep: batches off the --length_buckets=4 grid {buckets}: {seen}")
    _check_launches(launches, "w2v_sweep", train=True)
    return launches


def snapshot_tree(checkpoint, seed):
    """Full-width random weights of the checkpoint's encoder in the port's
    layout, on the card: (family, the {"encoder", "lm_head"} tree, the BN
    state tree). The port's init from `seed`, then seeded noise on every
    leaf (BN variances scaled, so they stay positive)."""
    import torch

    from wav2vec2forbrain_tpu_torch.models import conformer, fc, pretrained, wav2vec2
    from wav2vec2forbrain_tpu_torch.tree import tree_map

    family, cfg = pretrained.encoder_config_for_checkpoint(checkpoint)
    g = torch.Generator(device="cuda").manual_seed(seed)
    if family == "conformer":
        tree = {"encoder": conformer.init_conformer_encoder_params(g, cfg, "cuda"),
                "lm_head": fc.init_linear(g, cfg.hidden_size, cfg.vocab_size, "cuda")}
        state = {"encoder": conformer.init_conformer_state(cfg, "cuda")}
    else:
        tree = {"encoder": wav2vec2.init_w2v_encoder_params(g, cfg, "cuda"),
                "lm_head": wav2vec2.init_lm_head_params(g, cfg, "cuda")}
        state = {"encoder": {}}
    noise = lambda t: t + SNAPSHOT_NOISE * torch.randn(t.shape, generator=g, device="cuda")  # noqa: E731
    scale = lambda t: t * (1.0 + torch.rand(t.shape, generator=g, device="cuda"))  # noqa: E731
    for layer in state["encoder"].get("layers", []):
        bn = layer["batch_norm"]
        bn["mean"], bn["var"] = noise(bn["mean"]), scale(bn["var"])
    return family, tree_map(noise, tree), state


def frontend_config(family):
    """The checkpoint's audio front end: w2v-base's (group norm after conv 0,
    no conv bias, 768) or conformer-rope-large's (a LayerNorm after every
    conv, conv bias, 1024); 7 convs of 512 either way."""
    from wav2vec2forbrain_tpu_torch.models.audio_frontend import FeatureEncoderConfig

    conformer = family == "conformer"
    return FeatureEncoderConfig(conv_bias=conformer, feat_extract_norm="layer" if conformer else "group",
                                hidden_size=1024 if conformer else 768)


def snapshot_frontend(family):
    """The audio front end a snapshot holds, in the port's layout: the port's
    init from FRONTEND_SEED plus seeded noise on every leaf, CPU tensors.
    The same values every call (phase 12 checks the snapshot's against it)."""
    import torch

    from wav2vec2forbrain_tpu_torch.models.audio_frontend import init_feature_encoder_params
    from wav2vec2forbrain_tpu_torch.tree import tree_map

    g = torch.Generator().manual_seed(FRONTEND_SEED)
    tree = init_feature_encoder_params(g, frontend_config(family), "cpu")
    return tree_map(lambda t: t + SNAPSHOT_NOISE * torch.randn(t.shape, generator=g), tree)


def hf_state_dict(family, tree, state):
    """The checkpoint files' own key layout for a tree in the port's layout
    (models/convert.py's inverse, written out independently): torch (out,
    in) linears, the pos-conv as weight_g / weight_v, conv weights (out,
    in / groups, k), BN running statistics, and keys the converter drops:
    the audio front end (`snapshot_frontend`, feature_extractor.* and
    feature_projection.*), masked_spec_embed, the rotary inv_freq and the BN
    counters. CPU tensors, each with a storage of its own."""
    import torch

    sd = {}
    base = "wav2vec2_conformer" if family == "conformer" else "wav2vec2"
    enc = f"{base}.encoder"

    def linear(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["kernel"].t(), p["bias"]

    def ln(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["scale"], p["bias"]

    pc = tree["encoder"]["pos_conv"]
    for key in ("weight_g", "weight_v", "bias"):
        sd[f"{enc}.pos_conv_embed.conv.{key}"] = pc[key]
    ln(f"{enc}.layer_norm", tree["encoder"]["layer_norm"])
    for i, layer in enumerate(tree["encoder"]["layers"]):
        p = f"{enc}.layers.{i}"
        if family == "conformer":
            for part in ("ffn1", "ffn2"):
                ln(f"{p}.{part}_layer_norm", layer[f"{part}_layer_norm"])
                for name in ("intermediate_dense", "output_dense"):
                    linear(f"{p}.{part}.{name}", layer[part][name])
            ln(f"{p}.self_attn_layer_norm", layer["self_attn_layer_norm"])
            for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
                linear(f"{p}.self_attn.{name}", layer["self_attn"][name])
            cm, c = layer["conv_module"], f"{p}.conv_module"
            ln(f"{c}.layer_norm", cm["layer_norm"])
            sd[f"{c}.pointwise_conv1.weight"] = cm["pointwise_conv1"]["kernel"].t()[:, :, None]
            sd[f"{c}.depthwise_conv.weight"] = cm["depthwise_conv"]["kernel"].permute(2, 1, 0)
            ln(f"{c}.batch_norm", cm["batch_norm"])  # its affine scale and bias
            bn = state["encoder"]["layers"][i]["batch_norm"]
            sd[f"{c}.batch_norm.running_mean"], sd[f"{c}.batch_norm.running_var"] = bn["mean"], bn["var"]
            sd[f"{c}.batch_norm.num_batches_tracked"] = torch.tensor(0)
            sd[f"{c}.pointwise_conv2.weight"] = cm["pointwise_conv2"]["kernel"].t()[:, :, None]
        else:
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                linear(f"{p}.attention.{name}", layer["attention"][name])
            ln(f"{p}.layer_norm", layer["layer_norm"])
            for name in ("intermediate_dense", "output_dense"):
                linear(f"{p}.feed_forward.{name}", layer["feed_forward"][name])
        ln(f"{p}.final_layer_norm", layer["final_layer_norm"])
    linear("lm_head", tree["lm_head"])
    h = tree["lm_head"]["kernel"].shape[0]
    sd[f"{base}.masked_spec_embed"] = torch.rand(h)
    fe = snapshot_frontend(family)
    for i, layer in enumerate(fe["conv_layers"]):
        p = f"{base}.feature_extractor.conv_layers.{i}"
        sd[f"{p}.conv.weight"] = layer["conv"]["kernel"].permute(2, 1, 0)  # (k, in, out) -> (out, in, k)
        if "bias" in layer["conv"]:
            sd[f"{p}.conv.bias"] = layer["conv"]["bias"]
        for norm in ("group_norm", "layer_norm"):  # HF names both conv_layers.{i}.layer_norm
            if norm in layer:
                ln(f"{p}.layer_norm", layer[norm])
    ln(f"{base}.feature_projection.layer_norm", fe["projection"]["layer_norm"])
    linear(f"{base}.feature_projection.projection", fe["projection"]["projection"])
    if family == "conformer":
        sd[f"{enc}.embed_positions.inv_freq"] = 1.0 / 10000 ** (torch.arange(0, 64, 2).float() / 64)
    return {k: v.detach().contiguous().to("cpu") for k, v in sd.items()}


def write_safetensors(path, tensors):
    """A .safetensors file: an 8-byte little-endian header length, a JSON
    header of {name: dtype, shape, data_offsets} padded to 8 bytes, the raw
    bytes."""
    import torch

    names = {torch.float32: "F32", torch.int64: "I64"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for t in tensors.values():
            f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


def write_snapshots(cache_dir):
    """The two checkpoints' hub-cache snapshots under cache_dir (models--
    {org}--{name}/refs/main -> snapshots/<revision>/); {checkpoint: (its
    tree, its BN state)} on the card."""
    import torch

    trees = {}
    for i, (checkpoint, weights) in enumerate(SNAPSHOTS.items()):
        t = time.perf_counter()
        family, tree, state = snapshot_tree(checkpoint, SEED + 10 + i)
        sd = hf_state_dict(family, tree, state)
        repo = os.path.join(cache_dir, "models--" + checkpoint.replace("/", "--"))
        revision = f"{SEED + 10 + i:040x}"
        snap = os.path.join(repo, "snapshots", revision)
        os.makedirs(snap)
        os.makedirs(os.path.join(repo, "refs"))
        with open(os.path.join(repo, "refs", "main"), "w") as f:
            f.write(revision)
        if weights == "model.safetensors":
            write_safetensors(os.path.join(snap, weights), sd)
        else:
            torch.save(sd, os.path.join(snap, weights))
        size = os.path.getsize(os.path.join(snap, weights))
        print(f"  snapshot {checkpoint}: {weights}, {len(sd)} keys, {size / 1e9:.3f} GB, "
              f"written in {time.perf_counter() - t:.2f} s")
        trees[checkpoint] = (tree, state)
    return trees


@contextlib.contextmanager
def timed_loads():
    """[(part, seconds)] of the pretrained loader's parts while the block
    runs: snapshot_read (hf_snapshot.read_state_dict), convert
    (convert_from_hf less its read), cache_write and cache_read."""
    from wav2vec2forbrain_tpu_torch.models import hf_snapshot, pretrained

    seen = []
    originals = {(hf_snapshot, "read_state_dict"): "snapshot_read", (pretrained, "convert_from_hf"): "convert",
                 (pretrained, "write_msgpack"): "cache_write", (pretrained, "read_msgpack"): "cache_read"}

    def timed(fn, part):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            seen.append((part, time.perf_counter() - t))
            return out
        return run

    saved = {key: getattr(*key) for key in originals}
    for (module, name), part in originals.items():
        setattr(module, name, timed(saved[(module, name)], part))
    try:
        yield seen
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)


def load_seconds(seen):
    """{part: seconds} of timed_loads' record; convert less its read."""
    out = {}
    for part, seconds in seen:
        out[part] = out.get(part, 0.0) + seconds
    if "convert" in out:
        out["convert"] -= out.get("snapshot_read", 0.0)
    return {k: round(v, 3) for k, v in out.items()}


@contextlib.contextmanager
def initial_brains():
    """Clones of the brain leaves at each Trainer's construction (before
    training) while the block runs."""
    from wav2vec2forbrain_tpu_torch.train import train_loop
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves_with_path

    init = train_loop.Trainer.__init__
    seen = []

    def recording(self, experiment):
        init(self, experiment)
        seen.append({p: t.clone() for p, t in tree_leaves_with_path(experiment.params["brain"])})

    train_loop.Trainer.__init__ = recording
    try:
        yield seen
    finally:
        train_loop.Trainer.__init__ = init


def _w2v_mismatches(exp, tree, state):
    """Paths of the experiment's w2v leaves and BN state that are not
    bitwise the snapshot's (or live off the card)."""
    import torch

    from wav2vec2forbrain_tpu_torch.tree import tree_leaves_with_path

    want = dict(tree_leaves_with_path({"w2v": tree, "state": state}))
    got = dict(tree_leaves_with_path({"w2v": exp.params["w2v"], "state": exp.model_state}))
    if set(want) != set(got):
        return sorted(set(want) ^ set(got))
    return [p for p in want if not (got[p].device == want[p].device and torch.equal(got[p], want[p]))]


def _test_loss(exp):
    with open(os.path.join(exp.results_dir, "test_predictions.json")) as f:
        return json.load(f)["average"]["loss"]


def weights_phase(work, device_name, power):
    """Phase 10; returns {"w2v_frozen": launches of run a, "conformer_pretrained": launches of run b's two runs}."""
    import math

    import torch

    from wav2vec2forbrain_tpu_torch import convert, sweep
    from wav2vec2forbrain_tpu_torch.models import pretrained
    from wav2vec2forbrain_tpu_torch.ops import kernels
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves, tree_leaves_with_path

    t_phase = time.perf_counter()
    cache_dir = os.path.join(work, "cache")
    trees = write_snapshots(cache_dir)
    w2v_ckpt, conf_ckpt = SNAPSHOTS

    # a. the frozen sweep's first point, through the sweep runner in process
    repo = os.path.dirname(os.path.abspath(__file__))
    argv = [os.path.join(repo, FROZEN_YAML), "--max_runs", "1", "--config_yaml", os.path.join(work, "config.yaml"),
            "--extra", *SWEEP_EXTRA, f"--seed={SEED}"]
    print(f"  a. python -m wav2vec2forbrain_tpu_torch.sweep {' '.join(argv)}")
    runs = []  # (flags, experiment, wall)
    kernels.reset_launches()
    with timed_loads() as loads, initial_brains() as brains:
        def launch(flags):
            exp, wall = _cli_run(flags)
            runs.append((flags, exp, wall))
            return 0

        summary, _ = sweep.main(argv, launch=sweep.in_process(launch))
    frozen_launches = dict(kernels.LAUNCHES)
    with open(summary) as f:
        rows = [json.loads(line) for line in f]
    (flags_a, exp_a, wall_a), = runs
    runs.clear()
    loss_a = rows[0]["test_ctc_loss"] if rows else None
    cache_a = pretrained.converted_cache_path(w2v_ckpt, cache_dir)
    moved = [p for p, t in tree_leaves_with_path(exp_a.params["brain"]) if not torch.equal(t, brains[0][p])]
    n_brain = len(brains[0])
    brains.clear()
    frozen_wrong = _w2v_mismatches(exp_a, *trees[w2v_ckpt])
    print(f"  point {rows[0]['params'] if rows else None}: {wall_a:.2f} s wall, test_ctc_loss {loss_a!r}, "
          f"rc {rows[0]['returncode'] if rows else None}; load seconds {load_seconds(loads)}; "
          f"on {device_name} ({power})")
    print(f"  frozen w2v leaves bitwise the snapshot's after training: {not frozen_wrong}; "
          f"brain leaves moved {len(moved)} of {n_brain}")
    print(f"  kernel launches in run a: {json.dumps(frozen_launches)}")
    if len(rows) != 1 or rows[0]["returncode"] != 0 or loss_a is None or not math.isfinite(loss_a):
        fail(f"weights in, run a: rows {rows}")
    if not os.path.exists(cache_a):
        fail(f"weights in, run a: no converted cache at {cache_a}")
    if frozen_wrong or not moved:
        fail(f"weights in, run a: w2v leaves off the snapshot {frozen_wrong[:5]}, brain leaves moved {len(moved)}")
    _check_launches(frozen_launches, "w2v_sweep", train=True)

    # b. the conformer's default flags, --only_test, twice: the first run converts, the second reads the cache
    conf_launches = {}
    losses = []
    for i in range(2):
        flags = ["--experiment_type=b2p2t_gru+w2v_conformer", "--only_test=true", f"--seed={SEED}",
                 f"--results_subdir_name=conformer_pretrained_{i}"]
        print(f"  b{i + 1}. python -m wav2vec2forbrain_tpu_torch.run {' '.join(flags)}")
        kernels.reset_launches()
        with timed_loads() as loads:
            exp, wall = _cli_run(flags)
        launches = dict(kernels.LAUNCHES)
        parts = load_seconds(loads)
        losses.append(_test_loss(exp))
        wrong = _w2v_mismatches(exp, *trees[conf_ckpt])
        leaves = tree_leaves(exp.params) + tree_leaves(exp.model_state)
        on_card = exp.device.type == "cuda" and all(p.is_cuda for p in leaves)
        print(f"    {wall:.2f} s wall; test loss {losses[-1]!r}; load seconds {parts}; w2v and BN state bitwise "
              f"the snapshot's {not wrong}; params on the card {on_card}")
        print(f"    kernel launches: {json.dumps(launches)}")
        if wrong or not on_card:
            fail(f"weights in, run b{i + 1}: w2v leaves off the snapshot {wrong[:5]}, on the card {on_card}")
        if set(parts) != ({"snapshot_read", "convert", "cache_write"} if i == 0 else {"cache_read"}):
            fail(f"weights in, run b{i + 1}: the loader's parts {parts}")
        _check_launches(launches, "conformer", train=False)
        conf_launches = {k: conf_launches.get(k, 0) + v for k, v in launches.items()}
        del exp
        torch.cuda.empty_cache()
    print(f"  b. test losses {losses}: bitwise equal {losses[0] == losses[1]}")
    if not (math.isfinite(losses[0]) and losses[0] == losses[1]):
        fail(f"weights in, run b: the cached load's test loss {losses[1]} is not the converting load's {losses[0]}")

    # c. run a's model.pt in the JAX package's format, served at run a's flags
    model_pt = os.path.join(exp_a.results_dir, "model.pt")
    model_msgpack = os.path.join(work, "model.msgpack")
    t = time.perf_counter()
    convert.main(["to-msgpack", model_pt, model_msgpack])
    print(f"  c. convert to-msgpack {model_pt} -> {model_msgpack}: {time.perf_counter() - t:.2f} s, "
          f"{os.path.getsize(model_msgpack) / 1e6:.1f} MB")
    del exp_a
    served = {}
    for path in (model_msgpack, model_pt):
        kernels.reset_launches()
        exp, wall = _cli_run(flags_a + ["--only_test=true", f"--from_checkpoint={path}",
                                        f"--results_subdir_name=served_{os.path.basename(path)}"])
        served[path] = _test_loss(exp)
        launches = dict(kernels.LAUNCHES)
        print(f"    --from_checkpoint={os.path.basename(path)}: {wall:.2f} s wall, test loss {served[path]!r}")
        _check_launches(launches, "w2v_sweep", train=False)
        del exp
        torch.cuda.empty_cache()
    if not (math.isfinite(served[model_pt]) and served[model_msgpack] == served[model_pt]):
        fail(f"weights in, run c: the .msgpack's test loss {served[model_msgpack]} is not the .pt's "
             f"{served[model_pt]}")
    print(f"  c. test losses bitwise equal: True; phase 10 took {time.perf_counter() - t_phase:.2f} s "
          f"on {device_name} ({power})")
    return {"w2v_frozen": frozen_launches, "conformer_pretrained": conf_launches}


def _leaf_sums(tree):
    """A fingerprint of a tensor tree: each leaf's f64 sum, as floats."""
    import torch

    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    return torch.stack([t.double().sum() for t in tree_leaves(tree)]).tolist()


def dp_rank(rank: int, port: str, out_path: str) -> None:
    """Phase 11a's rank `rank` of two, on cuda:0 over gloo (this script run
    with --dp-rank); rank 0 then takes the one-process step and compares.
    Writes its results as JSON to out_path."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch, to_device
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
    from wav2vec2forbrain_tpu_torch.models.assembly import init_model_params
    from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
    from wav2vec2forbrain_tpu_torch.ops import kernels, select
    from wav2vec2forbrain_tpu_torch.parallel import distributed
    from wav2vec2forbrain_tpu_torch.parallel.mesh import make_mesh
    from wav2vec2forbrain_tpu_torch.parallel.zero import Zero1, zero1_dim
    from wav2vec2forbrain_tpu_torch.profile_train import BRAIN_LR, STEP_CFG, W2V_LR, build_trainer
    from wav2vec2forbrain_tpu_torch.train.checkpoint import to_cpu
    from wav2vec2forbrain_tpu_torch.train.optim import make_optimizer
    from wav2vec2forbrain_tpu_torch.train.steps import build_grad_fn
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves, tree_leaves_with_path as leaves, tree_map

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    select.f32_products()
    select.set_kernel_policy("auto")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
    shard = make_mesh(0, 1)
    tr = build_trainer(dev, SEED, "conformer", compute_dtype=torch.float32)
    spec = tr.spec
    whole = make_requests(1, 2 * DP_ROWS, 384, SEED + 1)[0]
    mine = shard.rows(2 * DP_ROWS)
    batch = to_device(B2tBatch(*(None if a is None else a[mine] for a in whole)), dev)
    kernels.lib()

    # the (row0, head0) the attention kernels are launched at, and the gradient all-reduce's seconds
    offsets, _, undo = _tp_recorders(lambda group: False)
    reduce_s = []
    all_reduce = distributed.all_reduce_tensors

    def timed_all_reduce(tensors, group=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        all_reduce(tensors, group)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t)

    distributed.all_reduce_tensors = timed_all_reduce

    res = {"rank": rank}
    keep = {}
    for variant in ("replicated", "zero1"):
        if variant == "zero1":  # the same initial weights again
            tr.params.clear()
            tr.params.update(init_model_params(torch.Generator(device=dev).manual_seed(SEED), spec, dev)[0])
        params, state = tr.params, tr.state
        opt = make_optimizer(tr.labels, "adam", 0.0, zero=Zero1(shard) if variant == "zero1" else None)
        opt_state = opt.init(params)
        grad_fn = build_grad_fn(spec, tr.labels, STEP_CFG, shard)
        offsets.clear()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, grads, norm = grad_fn(params, state, batch, StepRng(SEED, dev), float(2 * DP_ROWS))
        opt.step(params, grads, opt_state, BRAIN_LR, W2V_LR)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        moments = []  # (moment shape, param shape) of every trained leaf
        tree_map(lambda p, m: m is not None and moments.append((tuple(m.shape), tuple(p.shape))), params,
                 opt_state.mu)
        res[variant] = dict(
            loss=float(out["loss"].detach()), norm=float(norm), wall_s=wall, all_reduce_s=reduce_s[-1],
            launches=dict(kernels.LAUNCHES), offsets=sorted(offsets), params=_leaf_sums(params),
            split=sum(zero1_dim(p, 2) is not None for _, p in moments),
            halves=sum(zero1_dim(p, 2) is not None and m[zero1_dim(p, 2)] * 2 == p[zero1_dim(p, 2)]
                       for m, p in moments),
        )
        if rank == 0 and variant == "replicated":
            keep = dict(grads=to_cpu(grads), state=to_cpu(out["state"]), params=to_cpu(params))
        elif rank == 0:
            res["zero1_params_bitwise"] = all(
                torch.equal(a, b.to(dev)) for a, b in zip(tree_leaves(params), tree_leaves(keep["params"])))
        del out, grads, opt_state, opt
    del tr, params, state, batch
    torch.cuda.empty_cache()
    undo()
    distributed.all_reduce_tensors = all_reduce
    dist.barrier()  # rank 1's memory is free
    dist.destroy_process_group()
    if rank == 0:
        # the same step in one process on the whole batch
        tr = build_trainer(dev, SEED, "conformer", compute_dtype=torch.float32)
        grad_fn = build_grad_fn(tr.spec, tr.labels, STEP_CFG)
        out, grads, norm = grad_fn(tr.params, tr.state, to_device(whole, dev), StepRng(SEED, dev))
        res["single"] = dict(loss=float(out["loss"].detach()), norm=float(norm))
        worst = (0.0, "")
        got = dict(leaves(keep["grads"]))
        if set(got) != {path for path, _ in leaves(grads)}:
            raise RuntimeError("phase 11a: the two-rank step's gradient leaves are not the one-process step's")
        for path, ref in leaves(grads):
            ratio = (got[path].to(dev) - ref).abs().max().item() / (DP_GRAD_REL * max(1.0, ref.abs().max().item()))
            worst = max(worst, (ratio, path))
        res["grad_worst"] = worst
        bn = 0.0
        got = dict(leaves(keep["state"]))
        for path, b in leaves(out["state"]):
            bn = max(bn, (got[path].to(dev) - b).abs().max().item() / max(1.0, b.abs().max().item()))
        res["bn_rel"] = bn
        res["single"]["grad_leaves"] = len(leaves(grads))
    with open(out_path, "w") as f:
        json.dump(res, f)


def dp_step_phase(device_name, power):
    """Phase 11a; returns the launches summed over both ranks and both steps."""
    import math
    import shutil

    import torch

    torch.cuda.empty_cache()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "dp_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    port = _port()
    wall = _run_ranks(lambda r: ["--dp-rank", str(r), port, os.path.join(work, f"rank{r}.json")], 2, DP_TIMEOUT,
                      "phase 11a")
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(work, ignore_errors=True)
    single = ranks[0]["single"]
    launches = {}
    for r, res in enumerate(ranks):
        for variant in ("replicated", "zero1"):
            v = res[variant]
            for k, n in v["launches"].items():
                launches[k] = launches.get(k, 0) + n
            _check_launches(v["launches"], "conformer", train=True)
            rel = abs(v["loss"] - single["loss"]) / abs(single["loss"])
            print(f"  rank {r} {variant:10s}: loss {v['loss']!r} (one process {single['loss']!r}, rel {rel:.2e}, "
                  f"bound {DP_LOSS_REL:.0e}); grad norm {v['norm']:.6f} (one process {single['norm']:.6f}); "
                  f"step {v['wall_s']:.3f} s, gradient all-reduce {v['all_reduce_s']:.3f} s (gloo through the "
                  f"host, CUDA tensors: no NCCL figure) on {device_name} ({power}); attention (row0, head0) "
                  f"{v['offsets']}; moment leaves split {v['halves']} of {v['split']} splittable")
            if rel > DP_LOSS_REL or not math.isfinite(v["loss"]):
                fail(f"phase 11a rank {r} {variant}: loss {v['loss']} vs one process {single['loss']}")
            if v["offsets"] != [[DP_ROWS * r, 0]]:
                fail(f"phase 11a rank {r}: attention launched at (row0, head0) {v['offsets']}, not "
                     f"[({DP_ROWS * r}, 0)]")
            want_half = v["split"] if variant == "zero1" else 0
            if v["halves"] != want_half or v["split"] < 100:
                fail(f"phase 11a rank {r} {variant}: {v['halves']} of {v['split']} moment leaves halved")
        if res["replicated"]["params"] != ranks[0]["replicated"]["params"] or \
                res["zero1"]["params"] != ranks[0]["zero1"]["params"]:
            fail(f"phase 11a: rank {r}'s params differ from rank 0's after the step")
    ratio, path = ranks[0]["grad_worst"]
    print(f"  all-reduced gradients vs one process: worst leaf {path} at {ratio:.3f} of its bound "
          f"(DP_GRAD_REL {DP_GRAD_REL:.0e} x max(1, max |g|)), {single['grad_leaves']} leaves; BN running stats "
          f"rel {ranks[0]['bn_rel']:.2e} (bound {DP_BN_REL:.0e}); ZeRO-1 params bitwise the replicated ones: "
          f"{ranks[0]['zero1_params_bitwise']}; both ranks hold the same params; phase 11a {wall:.2f} s on {power}")
    if not (ratio <= 1.0 and ranks[0]["bn_rel"] <= DP_BN_REL and ranks[0]["zero1_params_bitwise"]):
        fail("phase 11a: the two-rank step differs from the one-process step beyond its bounds")
    return launches


def dp_cli_phase(work, device_name, power, ref):
    """Phase 11b: phase 7's CLI run under torchrun, one rank on NCCL, ZeRO-1;
    ref is phase 7's test loss."""
    argv = CLI_FLAGS["conformer"] + ["--w2v_skip_loading_weights=true", "--epochs=2", "--checkpoint_every_n_epochs=1",
                                     f"--seed={SEED}", "--results_subdir_name=dp_cli", "--mesh_data_parallel=0",
                                     "--optimizer_state_sharding=zero1"]
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
           "-m", "wav2vec2forbrain_tpu_torch.run", *argv]
    print(f"  {' '.join(cmd[1:])}")
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True, text=True, timeout=DP_TIMEOUT)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        print(proc.stdout[-3000:])
        print(proc.stderr[-3000:])
        fail(f"phase 11b: torchrun exited with {proc.returncode}")
    root = os.path.join(work, "cache", "experiment_results", "b2p2t_gru+w2v_conformer", "dp_cli")
    runs = os.listdir(root)
    if len(runs) != 1:
        fail(f"phase 11b: {len(runs)} results dirs under {root}")
    results = os.path.join(root, runs[0])
    for name in ("config.json", "history.json", "metrics.jsonl", "model.pt", os.path.join("train_state", "state.pt")):
        if not os.path.exists(os.path.join(results, name)):
            fail(f"phase 11b: {name} missing from {results}")
    with open(os.path.join(results, "metrics.jsonl")) as f:
        n_config = sum(json.loads(line)["_type"] == "run_config" for line in f)
    with open(os.path.join(results, "history.json")) as f:
        test_loss = json.load(f)["test"]["average"]["loss"]
    resident = [line.strip() for line in proc.stdout.splitlines() if line.startswith("device_data_cache: resident")]
    print(f"  the rank's input path: {resident or 'streamed (no resident split)'}")
    print(f"  torchrun (NCCL, 1 rank, ZeRO-1): {wall:.2f} s wall; test loss {test_loss!r} vs phase 7's {ref!r}: "
          f"bitwise equal {test_loss == ref}; run_config rows in metrics.jsonl: {n_config}; on {device_name} ({power})")
    if test_loss != ref or n_config != 1:
        fail("phase 11b: the torchrun CLI run is not phase 7's run")


def _port():
    s = __import__("socket").socket()
    s.bind(("localhost", 0))
    port = str(s.getsockname()[1])
    s.close()
    return port


def _run_ranks(args_of, n, timeout, name, cwd=None):
    """This script re-run as n ranks (argv from args_of(rank)); as soon as one
    fails (the others then wait in a collective) or the time runs out, stop
    them all and fail. Returns the wall seconds."""
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args_of(r)], cwd=cwd) for r in range(n)]
    try:
        while any(p.poll() is None for p in procs) and time.perf_counter() - t < timeout:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t
    codes = [p.returncode for p in procs]
    if any(codes):
        fail(f"{name}: the ranks exited with {codes} after {wall:.1f} s (limit {timeout} s)")
    return wall


def _tp_recorders(is_model_group):
    """Record the (row0, head0) of every attention launch and time every
    all_reduce by process group (a model group's, the others'), with the
    card synchronized around each. Returns (attention offsets, seconds by
    group, undo)."""
    import torch
    import torch.distributed as dist

    from wav2vec2forbrain_tpu_torch.ops import attention

    offsets, seconds = set(), {"model": 0.0, "data": 0.0}
    fwd_kernel, bwd_kernel, all_reduce = attention._fwd_kernel, attention._bwd_kernel, dist.all_reduce

    def fwd_rec(q, k, v, num_heads, scale, rate, cd, seed, row0=0, head0=0):
        offsets.add((int(row0), int(head0)))
        return fwd_kernel(q, k, v, num_heads, scale, rate, cd, seed, row0, head0)

    def bwd_rec(q, k, v, g, num_heads, scale, rate, cd, seed, row0=0, head0=0):
        offsets.add((int(row0), int(head0)))
        return bwd_kernel(q, k, v, g, num_heads, scale, rate, cd, seed, row0, head0)

    def timed_all_reduce(tensor, *args, group=None, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = all_reduce(tensor, *args, group=group, **kwargs)
        torch.cuda.synchronize()
        seconds["model" if is_model_group(group) else "data"] += time.perf_counter() - t
        return out

    def undo():
        attention._fwd_kernel, attention._bwd_kernel, dist.all_reduce = fwd_kernel, bwd_kernel, all_reduce

    attention._fwd_kernel, attention._bwd_kernel, dist.all_reduce = fwd_rec, bwd_rec, timed_all_reduce
    return offsets, seconds, undo


def tp_rank(case: str, rank: int, port: str, out_path: str) -> None:
    """Phase 14a / b's rank `rank` of TP_CASES[case], on cuda:0 over gloo
    (this script run with --tp-rank): an eval forward and one train step
    of the family at full width and f32 compute on its data index's rows of
    one batch, its pieces of the encoder split over the model axis; rank 0
    then takes the same eval and step in one process on the whole batch and
    compares. Writes its results as JSON to out_path."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch, to_device
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
    from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
    from wav2vec2forbrain_tpu_torch.ops import kernels, select
    from wav2vec2forbrain_tpu_torch.parallel import distributed
    from wav2vec2forbrain_tpu_torch.parallel.mesh import make_mesh
    from wav2vec2forbrain_tpu_torch.parallel.tensor import gather_tree, split_dim, split_tree
    from wav2vec2forbrain_tpu_torch.parallel.zero import Zero1, zero1_dim
    from wav2vec2forbrain_tpu_torch.profile_train import BRAIN_LR, FAMILIES, STEP_CFG, W2V_LR, build_trainer
    from wav2vec2forbrain_tpu_torch.train.checkpoint import to_cpu
    from wav2vec2forbrain_tpu_torch.train.optim import make_optimizer
    from wav2vec2forbrain_tpu_torch.train.steps import build_eval_step, build_grad_fn
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves_with_path as leaves

    c = TP_CASES[case]
    family, world = c["family"], c["world"]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    select.f32_products()
    select.set_kernel_policy("auto")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    shard = make_mesh(0, TP_MODEL)
    tp = shard.model
    tr = build_trainer(dev, SEED, family, compute_dtype=torch.float32)
    spec, labels, batch_size, weight_decay = tr.spec, tr.labels, tr.batch_size, FAMILIES[family][1]
    params, state = split_tree(tr.params, tp), tr.state
    whole_shapes = {p: tuple(t.shape) for p, t in leaves(tr.params)}
    del tr
    torch.cuda.empty_cache()
    whole = make_requests(1, batch_size, 384, SEED + 1)[0]
    batch = to_device(B2tBatch(*(None if a is None else a[shard.rows(batch_size)] for a in whole)), dev)
    kernels.lib()
    offsets, seconds, undo = _tp_recorders(lambda group: group is tp.group)

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    eval_loss, logits = build_eval_step(spec, shard)(params, state, batch, float(batch_size))[:2]
    logits = distributed.gather_rows(logits, shard.group)
    opt = make_optimizer(labels, "adam", weight_decay, TP_ADAM_EPS, zero=Zero1(shard) if c["zero1"] else None)
    opt_state = opt.init(params)
    grad_fn = build_grad_fn(spec, labels, STEP_CFG, shard)
    eval_head0s = sorted({h for _, h in offsets})
    offsets.clear()  # the step's offsets: its dropout keys rows at row0 (the eval's rate 0 keys nothing)
    seconds.update(model=0.0, data=0.0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out, grads, norm = grad_fn(params, state, batch, StepRng(SEED, dev), float(batch_size))
    opt.step(params, grads, opt_state, BRAIN_LR, W2V_LR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    step_s = dict(seconds)
    peak = torch.cuda.max_memory_allocated(dev)
    # every moment leaf: its shape against the whole param's, split over the model axis, then ZeRO-1's data axis
    twice = quarters = 0
    for path, m in leaves(opt_state.mu):
        full = whole_shapes[path]
        md = split_dim(path, len(full))
        zd = zero1_dim(full, shard.size, md) if c["zero1"] else None
        twice += md is not None and zd is not None
        quarters += md is not None and zd is not None and m.numel() * TP_MODEL * shard.size == \
            torch.Size(full).numel()
    gathered = dict(grads=gather_tree(grads, tp), params=gather_tree(params, tp))
    res = dict(rank=rank, loss=float(out["loss"].detach()), eval_loss=float(eval_loss), norm=float(norm),
               wall_s=wall, model_all_reduce_s=step_s["model"], data_all_reduce_s=step_s["data"],
               peak_gb=peak / 2**30, launches=launches, offsets=sorted(offsets), eval_head0s=eval_head0s,
               twice=twice, quarters=quarters,
               params=_leaf_sums(gathered["params"]))
    keep = None
    if rank == 0:
        keep = dict(grads=to_cpu(gathered["grads"]), params=to_cpu(gathered["params"]), state=to_cpu(out["state"]),
                    logits=logits.cpu())
    undo()
    del out, grads, opt_state, opt, params, state, batch, gathered, logits
    torch.cuda.empty_cache()
    dist.barrier()  # every rank's memory is free
    dist.destroy_process_group()
    if rank == 0:
        # the same eval and step in one process on the whole batch
        tr = build_trainer(dev, SEED, family, compute_dtype=torch.float32)
        full_batch = to_device(whole, dev)
        ref_eval_loss, ref_logits = build_eval_step(tr.spec)(tr.params, tr.state, full_batch)[:2]
        opt = make_optimizer(tr.labels, "adam", weight_decay, TP_ADAM_EPS)
        opt_state = opt.init(tr.params)
        out, grads, norm = build_grad_fn(tr.spec, tr.labels, STEP_CFG)(tr.params, tr.state, full_batch,
                                                                         StepRng(SEED, dev))
        opt.step(tr.params, grads, opt_state, BRAIN_LR, W2V_LR)
        res["single"] = dict(loss=float(out["loss"].detach()), eval_loss=float(ref_eval_loss), norm=float(norm))
        res["logits_err"] = (keep["logits"].to(dev) - ref_logits).abs().max().item()

        def worst(got_tree, ref_tree, bound):
            got = dict(leaves(got_tree))
            ref = leaves(ref_tree)
            if set(got) != {p for p, _ in ref}:
                raise RuntimeError(f"phase 14{case}: the gathered tree's leaves are not the one-process tree's")
            return max(((((got[p].to(dev) - r).abs() / bound(r)).max().item(), p) for p, r in ref), default=(0.0, ""))

        res["grad_worst"] = worst(keep["grads"], grads, lambda r: TP_GRAD_ATOL + TP_GRAD_RTOL * r.abs())
        res["bn_worst"] = worst(keep["state"], out["state"], lambda r: TP_GRAD_ATOL + TP_GRAD_RTOL * r.abs())
        lr = {"brain": BRAIN_LR, "w2v": W2V_LR}
        label_of = dict(leaves(tr.labels))
        got = dict(leaves(keep["params"]))
        res["param_worst"] = max(((got[p].to(dev) - r).abs().max().item() / (TRAIN_F32_PARAM_STEPS *
                                  lr[label_of[p]]), p) for p, r in leaves(tr.params) if label_of[p] != "frozen")
        res["single"]["grad_leaves"] = len(leaves(grads))
    with open(out_path, "w") as f:
        json.dump(res, f)


def tp_step_phase(case, device_name, power):
    """Phase 14a or b; returns the launches summed over the ranks."""
    import math
    import shutil

    import torch

    c = TP_CASES[case]
    world, family = c["world"], c["family"]
    torch.cuda.empty_cache()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "tp_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    port = _port()
    wall = _run_ranks(lambda r: ["--tp-rank", case, str(r), port, os.path.join(work, f"rank{r}.json")], world,
                      TP_TIMEOUT, f"phase 14{case}")
    ranks = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(work, ignore_errors=True)
    single = ranks[0]["single"]
    heads = FAMILY_HEADS[family]
    rows = (TP_ROWS[family] // (world // TP_MODEL))
    launches = {}
    for r, res in enumerate(ranks):
        d, m = divmod(r, TP_MODEL)
        for k, n in res["launches"].items():
            launches[k] = launches.get(k, 0) + n
        _check_launches(res["launches"], family, train=True)
        rel = abs(res["loss"] - single["loss"]) / abs(single["loss"])
        want_offsets = [(d * rows, m * heads // TP_MODEL)]
        print(f"  rank {r} (data {d}, model {m}): loss {res['loss']!r} (one process {single['loss']!r}, rel "
              f"{rel:.2e}, bound {TP_LOSS_REL:.0e}); eval loss {res['eval_loss']!r} (one process "
              f"{single['eval_loss']!r}); grad norm {res['norm']:.6f} (one process {single['norm']:.6f}); step "
              f"{res['wall_s']:.3f} s, model-group all-reduces {res['model_all_reduce_s']:.3f} s, data-group "
              f"{res['data_all_reduce_s']:.3f} s (gloo through the host, CUDA tensors; the card synchronized "
              f"around each), peak memory {res['peak_gb']:.2f} GiB on {device_name} ({power}); attention (row0, "
              f"head0) {res['offsets']}; moment leaves split twice {res['quarters']} of {res['twice']} a quarter")
        if rel > TP_LOSS_REL or not math.isfinite(res["loss"]):
            fail(f"phase 14{case} rank {r}: loss {res['loss']} vs one process {single['loss']}")
        if [tuple(o) for o in res["offsets"]] != want_offsets or res["eval_head0s"] != [want_offsets[0][1]]:
            fail(f"phase 14{case} rank {r}: attention launched at (row0, head0) {res['offsets']} in the step and "
                 f"head0 {res['eval_head0s']} in the eval, not {want_offsets}")
        if c["zero1"] and (res["quarters"] != res["twice"] or res["twice"] < TP_MIN_SPLIT_TWICE):
            fail(f"phase 14{case} rank {r}: {res['quarters']} of {res['twice']} moment leaves split twice hold "
                 f"a quarter")
        if res["params"] != ranks[0]["params"]:
            fail(f"phase 14{case}: rank {r}'s gathered params differ from rank 0's after the step")
    g_ratio, g_path = ranks[0]["grad_worst"]
    b_ratio, b_path = ranks[0]["bn_worst"]
    p_ratio, p_path = ranks[0]["param_worst"]
    print(f"  gathered gradients vs one process: worst {g_path} at {g_ratio:.3f} of its bound (atol {TP_GRAD_ATOL:.0e}"
          f" + rtol {TP_GRAD_RTOL:.0e}), {single['grad_leaves']} leaves; BN stats worst {b_path or '-'} at "
          f"{b_ratio:.3f}; params after Adam worst {p_path} at {p_ratio:.3f} of {TRAIN_F32_PARAM_STEPS} x its LR; "
          f"eval logits max-abs {ranks[0]['logits_err']:.2e} (bound {AUTO_VS_NONE_F32_BOUND:.0e}); every rank "
          f"holds the same params; phase 14{case} {wall:.2f} s on {power}")
    if not (g_ratio <= 1.0 and b_ratio <= 1.0 and p_ratio <= 1.0 and ranks[0]["logits_err"] <= AUTO_VS_NONE_F32_BOUND):
        fail(f"phase 14{case}: the tensor-parallel step differs from the one-process step beyond its bounds")
    return launches


def tp_cli_rank(rank: int, port: str, work: str, out_path: str) -> None:
    """Phase 14c's rank `rank` of two (this script run with --tp-cli-rank):
    joins a gloo group on cuda:0, then runs the conformer CLI in process at
    --mesh_model_parallel=2 from `work` (its config.yaml)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wav2vec2forbrain_tpu_torch.ops import kernels

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=TP_MODEL)
    os.chdir(work)
    # at (1, 2) the model group is the one group of both ranks besides the world's
    offsets, seconds, undo = _tp_recorders(
        lambda group: group is not None and group is not dist.group.WORLD and dist.get_world_size(group) == TP_MODEL)
    kernels.reset_launches()
    exp, wall = _cli_run(TP_CLI_FLAGS + [f"--mesh_model_parallel={TP_MODEL}", "--results_subdir_name=tp_cli"])
    undo()
    res = dict(results=exp.results_dir, wall_s=wall, launches=dict(kernels.LAUNCHES), offsets=sorted(offsets),
               model_all_reduce_s=seconds["model"], peak_gb=torch.cuda.max_memory_allocated() / 2**30,
               model=exp.shard.model.rank, resident={s: c.nbytes for s, c in exp.get_device_caches().items()})
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(res, f)


def tp_cli_phase(work, device_name, power):
    """Phase 14c (in phase 7's scratch dir); returns the ranks' launches."""
    import math

    import torch

    from wav2vec2forbrain_tpu_torch.train.checkpoint import load_tree
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves_with_path as leaves

    torch.cuda.empty_cache()
    port = _port()
    argv = TP_CLI_FLAGS + [f"--mesh_model_parallel={TP_MODEL}"]
    print(f"  2 ranks (gloo, cuda:0): python -m wav2vec2forbrain_tpu_torch.run {' '.join(argv)}")
    wall = _run_ranks(lambda r: ["--tp-cli-rank", str(r), port, work, os.path.join(work, f"tp_cli{r}.json")],
                      TP_MODEL, TP_TIMEOUT, "phase 14c")
    ranks = []
    for r in range(TP_MODEL):
        with open(os.path.join(work, f"tp_cli{r}.json")) as f:
            ranks.append(json.load(f))
    results = ranks[0]["results"]
    if any(res["results"] != results for res in ranks):
        fail("phase 14c: the ranks ran in different results dirs")
    ref, ref_wall = _cli_run(TP_CLI_FLAGS + ["--results_subdir_name=tp_cli_ref"])
    with open(os.path.join(results, "history.json")) as f:
        test_loss = json.load(f)["test"]["average"]["loss"]
    with open(os.path.join(ref.results_dir, "history.json")) as f:
        ref_loss = json.load(f)["test"]["average"]["loss"]
    shapes = {p: tuple(t.shape) for p, t in leaves(load_tree(os.path.join(results, "model.pt"))["params"])}
    ref_shapes = {p: tuple(t.shape) for p, t in leaves(load_tree(os.path.join(ref.results_dir, "model.pt"))["params"])}
    launches = {}
    heads = FAMILY_HEADS["conformer"]
    for r, res in enumerate(ranks):
        for k, n in res["launches"].items():
            launches[k] = launches.get(k, 0) + n
        _check_launches(res["launches"], "conformer", train=True)
        head0s = sorted({h for _, h in res["offsets"]})
        print(f"  rank {r} (model {res['model']}): {res['wall_s']:.2f} s wall, model-group all-reduces "
              f"{res['model_all_reduce_s']:.2f} s, peak memory {res['peak_gb']:.2f} GiB; attention head0 {head0s}; "
              f"resident splits (bytes) {res['resident']}")
        if head0s != [res["model"] * heads // TP_MODEL]:
            fail(f"phase 14c rank {r}: attention launched at head0 {head0s}")
    rel = abs(test_loss - ref_loss) / abs(ref_loss)
    print(f"  test loss {test_loss!r} vs one process {ref_loss!r} ({ref_wall:.2f} s wall): rel {rel:.2e} (bound "
          f"{TP_CLI_TEST_LOSS_REL:.0e}); model.pt whole: {shapes == ref_shapes} ({len(shapes)} leaves); phase 14c "
          f"{wall:.2f} s for the ranks on {device_name} ({power})")
    if not math.isfinite(test_loss) or rel > TP_CLI_TEST_LOSS_REL or shapes != ref_shapes:
        fail("phase 14c: the tensor-parallel CLI run differs from the one-process run")
    return launches


def write_clips(audio_dir):
    """AUDIO_CLIPS seeded mono PCM16 clips at AUDIO_RATE in audio_dir, the
    first 6 s long, the others 2-6 s: seven harmonics of a 90-220 Hz voice
    under a 3-6 Hz syllable envelope, plus noise. Returns (paths, seconds)."""
    import wave

    import numpy as np

    rng = np.random.default_rng(SEED + 30)
    paths, seconds = [], []
    for i in range(AUDIO_CLIPS):
        n = 6 * AUDIO_RATE if i == 0 else int(rng.uniform(2.0, 6.0) * AUDIO_RATE)
        t = np.arange(n) / AUDIO_RATE
        f0 = rng.uniform(90.0, 220.0)
        voice = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 8))
        syllables = np.clip(np.sin(2 * np.pi * rng.uniform(3.0, 6.0) * t), 0.0, None)
        x = 0.15 * syllables * voice + 0.01 * rng.standard_normal(n)
        path = os.path.join(audio_dir, f"{i}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(AUDIO_RATE)
            w.writeframes(np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16).tobytes())
        paths.append(path)
        seconds.append(n / AUDIO_RATE)
    return paths, seconds


def analysis_phase(work, models, device_name, power):
    """Phase 12; returns {path: launches} of its three `auto` runs: the w2v
    and conformer brain streams (embed_brain_representations, then
    embed_brain) and the audio stream."""
    import numpy as np
    import torch

    from wav2vec2forbrain_tpu_torch.analysis import latent_analysis as la
    from wav2vec2forbrain_tpu_torch.args.argparsing import get_experiment_from_args
    from wav2vec2forbrain_tpu_torch.models.audio_frontend import feature_encoder_from_torch
    from wav2vec2forbrain_tpu_torch.models.hf_snapshot import read_state_dict
    from wav2vec2forbrain_tpu_torch.ops import kernels, select
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves_with_path

    t_phase = time.perf_counter()
    seconds = {}

    def timed(step, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[step] = time.perf_counter() - t
        return out

    exps = {}
    for family in ("w2v", "conformer"):
        flags = CLI_FLAGS[family] + ["--w2v_skip_loading_weights=true", f"--seed={SEED}",
                                     f"--from_checkpoint={models[family]}", f"--results_subdir_name={family}_analysis"]
        exps[family] = timed(f"build {family}", lambda: get_experiment_from_args(flags))
        if exps[family].spec.compute_dtype != torch.float32 or exps[family].device.type != "cuda":
            fail(f"analysis: the {family} experiment is at {exps[family].spec.compute_dtype} on {exps[family].device}")
    w2v = exps["w2v"]
    n_brain = {family: len(exp.dataloader_test.dataset) for family, exp in exps.items()}

    audio_dir = os.path.join(work, "audio")
    os.makedirs(audio_dir)
    paths, clip_seconds = timed("write clips", lambda: write_clips(audio_dir))
    batches = timed("read clips", lambda: list(la.load_wav_batches(paths, batch_size=AUDIO_CLIPS)))
    n_samples = int(max(clip_seconds) * AUDIO_RATE)
    if [b.shape for b in batches] != [(AUDIO_CLIPS, n_samples)] or batches[0].dtype != np.float32:
        fail(f"analysis: audio batches {[(b.shape, b.dtype) for b in batches]}")
    checkpoint = next(iter(SNAPSHOTS))  # facebook/wav2vec2-base-960h, phase 10's snapshot
    sd = timed("read snapshot", lambda: read_state_dict(checkpoint, os.path.join(work, "cache")))
    frontend = feature_encoder_from_torch(sd, "wav2vec2.feature_extractor", "wav2vec2.feature_projection")
    del sd
    written = dict(tree_leaves_with_path(snapshot_frontend("w2v")))
    read = dict(tree_leaves_with_path(frontend))
    if set(read) != set(written) or not all(torch.equal(read[p], written[p]) for p in read):
        fail("analysis: the front end read from the snapshot is not the one phase 10 wrote")
    fe_cfg = frontend_config("w2v")
    print(f"  front end: {checkpoint} snapshot in {os.path.join(work, 'cache')}, {len(read)} leaves, bitwise "
          f"the written ones; {AUDIO_CLIPS} clips of {[round(x, 2) for x in clip_seconds]} s at {AUDIO_RATE} Hz")

    def embed_audio():
        return la.embed_audio_representations(batches, frontend, fe_cfg, w2v.params["w2v"]["encoder"],
                                              w2v.spec.w2v_cfg, device=w2v.device)

    out, launches = {}, {}
    for policy in ("auto", "none"):
        select.set_kernel_policy(policy)
        for family in ("w2v", "conformer"):
            path = f"{family}_analysis"
            kernels.reset_launches()
            reps = timed(f"{policy} {family} embed_brain_representations",
                         lambda: la.embed_brain_representations(exps[family]))
            pre = timed(f"{policy} {family} embed_brain", lambda: la.embed_brain(exps[family]))
            launches[(policy, path)] = dict(kernels.LAUNCHES)
            out[(policy, path)] = reps
            width = exps[family].spec.latent_size
            err = float(np.abs(reps["pre"] - pre).max())
            ok = (reps["pre"].shape == reps["post"].shape == pre.shape and pre.shape[1] == width
                  and reps["pre_agg"].shape == reps["post_agg"].shape == (n_brain[family], width)
                  and all(np.isfinite(x).all() for x in (*reps.values(), pre)))
            print(f"  {policy} {family}: pre {reps['pre'].shape}, pre vs embed_brain max_abs {err:.3e} "
                  f"(tol {ANALYSIS_PRE_TOL:.0e}), post vs pre max_abs {np.abs(reps['post'] - reps['pre']).max():.3e}; "
                  f"launches {json.dumps(launches[(policy, path)])}")
            if not ok or not err <= ANALYSIS_PRE_TOL or np.allclose(reps["post"], reps["pre"], atol=1e-3):
                fail(f"analysis {policy} {family}: shapes, finiteness, pre vs embed_brain {err} or post == pre")
        kernels.reset_launches()
        audio = timed(f"{policy} audio embed_audio_representations", embed_audio)
        launches[(policy, "audio_analysis")] = dict(kernels.LAUNCHES)
        out[(policy, "audio_analysis")] = audio
        frames = n_samples
        for k, stride in zip(fe_cfg.conv_kernel, fe_cfg.conv_stride):
            frames = (frames - k) // stride + 1
        shapes = {k: v.shape for k, v in audio.items()}
        want = {"pre": (AUDIO_CLIPS * frames, 768), "post": (AUDIO_CLIPS * frames, 768),
                "pre_agg": (AUDIO_CLIPS, 768), "post_agg": (AUDIO_CLIPS, 768)}
        print(f"  {policy} audio: T' {frames}, {shapes}; launches {json.dumps(launches[(policy, 'audio_analysis')])}")
        if shapes != want or not all(np.isfinite(x).all() for x in audio.values()):
            fail(f"analysis {policy} audio: shapes {shapes} (want {want}) or non-finite values")
    select.set_kernel_policy("auto")

    for path, family in (("w2v_analysis", "w2v_brain"), ("conformer_analysis", "conformer_brain"),
                         ("audio_analysis", "w2v_audio")):
        _check_launches(launches[("auto", path)], family, train=False)
        if any(launches[("none", path)].values()):
            fail(f"analysis {path} under none launched {launches[('none', path)]}")
        post, ref = out[("auto", path)]["post"], out[("none", path)]["post"]
        diff, bound = float(np.abs(post - ref).max()), AUTO_VS_NONE_REL * float(np.abs(ref).max())
        print(f"  {path}: post auto vs none max_abs {diff:.3e} (bound {bound:.3e} = {AUTO_VS_NONE_REL:.0e} x max |x|)")
        if not diff <= bound:
            fail(f"analysis {path}: post hidden states auto vs none differ by {diff} > {bound}")

    stats = la.representation_statistics(out[("auto", "w2v_analysis")], out[("auto", "audio_analysis")])
    for space, st in stats.items():
        values = [st["centroid_cosine"], *st["pca_explained"], *st["brain"].values(), *st["audio"].values()]
        finite = all(np.isfinite(values)) and np.isfinite(st["brain_pca"]).all() and np.isfinite(st["audio_pca"]).all()
        print(f"  statistics {space}: centroid cosine {st['centroid_cosine']:.4f}, pca_explained "
              f"{[round(x, 4) for x in st['pca_explained']]}, norms brain {st['brain']} audio {st['audio']}")
        if not finite or not sum(st["pca_explained"]) <= 1.0:
            fail(f"analysis statistics {space}: not finite or pca_explained {st['pca_explained']} sums over 1")

    # the rates from a second call of each stream (the first calls above paid the libraries' set-up)
    for family in ("w2v", "conformer"):
        timed(f"auto {family} embed_brain_representations, warm", lambda: la.embed_brain_representations(exps[family]))
    timed("auto audio embed_audio_representations, warm", embed_audio)
    for step, s in seconds.items():
        print(f"  {step}: {s:.3f} s")
    for family in ("w2v", "conformer"):
        s = seconds[f"auto {family} embed_brain_representations, warm"]
        print(f"  {family} brain stream (auto, warm): {n_brain[family]} samples in {s:.3f} s = "
              f"{n_brain[family] / s:.1f} samples/s")
    s = seconds["auto audio embed_audio_representations, warm"]
    print(f"  audio stream (auto, warm): {sum(clip_seconds):.2f} s of audio in {s:.3f} s = "
          f"{sum(clip_seconds) / s:.1f} audio seconds a wall second; phase 12 took "
          f"{time.perf_counter() - t_phase:.2f} s on {device_name} ({power})")
    del exps, w2v
    torch.cuda.empty_cache()
    return {path: launches[("auto", path)] for path in ("w2v_analysis", "conformer_analysis", "audio_analysis")}


def _grouped_run(argv, device_name, power):
    """Phase 13b: one w2v CLI epoch whose train batches the JAX package would chunk and group by width.
    Returns its launches."""
    from wav2vec2forbrain_tpu_torch.args.argparsing import get_experiment_from_args
    from wav2vec2forbrain_tpu_torch.ops import kernels
    from wav2vec2forbrain_tpu_torch.train.buckets import width_for

    exp = get_experiment_from_args(argv)
    loader, buckets = exp.dataloader_train, exp.t_buckets.get("train")
    if exp.resolve_multi_step_chunk() < 2 or not buckets:
        fail(f"phase 13b: the epoch is not one the JAX package chunks (K {exp.resolve_multi_step_chunk()}, "
             f"buckets {buckets})")
    lengths = exp.sample_lengths["train"]
    state = loader.rng_state()
    loader_order = [max(lengths[i] for i in idxs) for idxs in loader.iter_index_batches()]
    loader.set_rng_state(state)
    kernels.reset_launches()
    t = time.perf_counter()
    with recorded_batches() as seen:
        exp.run()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    ran = [longest for split, _, _, longest, _ in seen if split == "train"]  # in the order the epoch runs them
    widths = [width_for(buckets, n) for n in ran]
    stable = sorted(range(len(loader_order)), key=lambda i: width_for(buckets, loader_order[i]))
    ok = widths == sorted(widths) and ran == [loader_order[i] for i in stable] and len(set(widths)) >= 2
    print(f"  {' '.join(argv[-4:])}: {wall:.2f} s wall on {device_name} ({power}); {len(ran)} train batches at widths "
          f"{widths} (buckets {buckets}; the loader's order {[width_for(buckets, n) for n in loader_order]}), "
          f"sorted stably: {ok}; resident splits {sorted(exp.get_device_caches())}")
    print(f"  kernel launches in the grouped run: {json.dumps(launches)}")
    _check_launches(launches, "w2v", train=True)
    if not ok:
        fail("phase 13b: the train batches did not run stably sorted by width")
    return launches


def crossing_phase(work, results, device_name, power):
    """Phase 13; returns {"w2v_resumed": launches, "w2v_grouped": launches}. results: phase 8's first
    training run's results dir."""
    import math

    import torch

    from wav2vec2forbrain_tpu_torch.args.argparsing import get_experiment_from_args
    from wav2vec2forbrain_tpu_torch.ops import kernels
    from wav2vec2forbrain_tpu_torch.train.checkpoint import load_tree
    from wav2vec2forbrain_tpu_torch.train.jax_train_state import read_jax_train_state
    from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves_with_path

    src, jax_dir = os.path.join(results, "train_state"), os.path.join(work, "jax_train_state")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "wav2vec2forbrain_tpu_torch.convert", "train-state", src, jax_dir]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True, text=True, timeout=600)
    convert_s = time.perf_counter() - t
    if proc.returncode != 0:
        print(proc.stdout[-3000:])
        print(proc.stderr[-3000:])
        fail(f"phase 13: the converter exited with {proc.returncode}")
    path = os.path.join(jax_dir, "state.msgpack")
    saved = load_tree(os.path.join(src, "state.pt"))
    argv = CLI_FLAGS["w2v"] + ["--w2v_skip_loading_weights=true", "--epochs=3", f"--seed={SEED}",
                               f"--resume_train_state={jax_dir}", "--results_subdir_name=w2v_resumed"]
    print(f"  python -m wav2vec2forbrain_tpu_torch.convert train-state <phase 8>/train_state {jax_dir}: "
          f"{os.path.getsize(path) / 1e9:.3f} GB msgpack (state.pt {os.path.getsize(os.path.join(src, 'state.pt')) / 1e9:.3f} "
          f"GB) in {convert_s:.2f} s (a fresh interpreter included)")
    exp = get_experiment_from_args(argv)
    t = time.perf_counter()
    read_jax_train_state(path, exp.base_config.unfreeze_strategy, exp.base_config.optimizer)
    read_s = time.perf_counter() - t
    trainer = Trainer(exp)
    t = time.perf_counter()
    epoch, history = trainer.restore_train_state(jax_dir)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t

    def bitwise(port_tree, ref_tree):
        a, b = dict(tree_leaves_with_path(port_tree)), dict(tree_leaves_with_path(ref_tree))
        return a.keys() == b.keys() and all(torch.equal(a[k].cpu(), b[k]) for k in a)

    with open(os.path.join(src, "history.json")) as f:
        saved_history = json.load(f)["epochs"]
    checks = {
        "params": bitwise(trainer.params, saved["params"]),
        "BN state": bitwise(trainer.model_state, saved["state"]),
        "mu": bitwise(trainer.opt_state.mu, saved["opt"]["mu"]),
        "nu": bitwise(trainer.opt_state.nu, saved["opt"]["nu"]),
        "count": trainer.opt_state.count == saved["opt"]["count"],
        "epoch": epoch == saved["epoch"] + 1,
        "history": [e.to_dict() for e in history] == saved_history,
    }
    print(f"  read {read_s:.2f} s; restored on the card in {restore_s:.2f} s (epoch {epoch}, Adam count "
          f"{trainer.opt_state.count}); bitwise the state.pt's: {json.dumps(checks)}")
    if not all(checks.values()):
        fail(f"phase 13: the converted state did not restore bitwise: {checks}")
    del trainer
    kernels.reset_launches()
    t = time.perf_counter()
    exp.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    with open(os.path.join(exp.results_dir, "history.json")) as f:
        hist = json.load(f)
    losses = [hist["epochs"][-1][s]["average"]["loss"] for s in ("train", "val")]
    print(f"  --resume_train_state=<the msgpack's dir> --epochs=3: {wall:.2f} s wall on {device_name} ({power}); "
          f"{len(hist['epochs'])} epochs in history.json, epoch 3 losses (train, val) {losses}, test loss "
          f"{hist['test']['average']['loss']!r}")
    print(f"  kernel launches in the resumed run: {json.dumps(launches)}")
    _check_launches(launches, "w2v", train=True)
    if len(hist["epochs"]) != 3 or not all(math.isfinite(x) for x in losses) or hist["epochs"][:2] != saved_history:
        fail(f"phase 13: the resumed run's history ({len(hist['epochs'])} epochs, losses {losses})")
    del exp
    torch.cuda.empty_cache()
    grouped = CLI_FLAGS["w2v"] + ["--w2v_skip_loading_weights=true", "--epochs=1", f"--seed={SEED}",
                                  "--results_subdir_name=w2v_grouped", "--batch_size=4", "--device_data_cache=on",
                                  "--length_buckets=4", "--length_bucket_order=grouped"]
    return {"w2v_resumed": launches, "w2v_grouped": _grouped_run(grouped, device_name, power)}


def _train_state(trainer):
    """A copy of what a train epoch changes: params, Adam state, BN state, the
    step RNG's generators and the train loader's shuffle stream."""
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    opt = trainer.opt_state
    return dict(params=[t.detach().clone() for t in tree_leaves(trainer.params)],
                mu=_clone(opt.mu), nu=_clone(opt.nu), count=opt.count, state=_clone(trainer.model_state),
                rng=(trainer.rng._host.get_state(), trainer.rng._device.get_state()),
                loader=trainer.dataloader_train.rng_state())


def _restore_train_state(trainer, saved):
    import torch

    from wav2vec2forbrain_tpu_torch.train.optim import AdamState
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    with torch.no_grad():
        for t, v in zip(tree_leaves(trainer.params), saved["params"]):
            t.copy_(v)
        opt = trainer.opt_state
        for tree, want in ((opt.mu, saved["mu"]), (opt.nu, saved["nu"])):
            for t, v in zip(tree_leaves(tree), tree_leaves(want)):
                t.copy_(v)
    trainer.opt_state = AdamState(saved["count"], opt.mu, opt.nu)
    trainer.model_state = _clone(saved["state"])
    trainer.rng._host.set_state(saved["rng"][0])
    trainer.rng._device.set_state(saved["rng"][1])
    trainer.rng.forwards.clear()
    trainer.dataloader_train.set_rng_state(saved["loader"])


def _gathers_equal_place(trainer, caches, split):
    """Phase 15a: every batch of one epoch of `split`, gathered from its
    cache, against Trainer._place of the collated batch, bitwise in every
    field. Returns (batches, the widths they ran at)."""
    import torch

    loader = {"train": trainer.dataloader_train, "val": trainer.dataloader_val}[split]
    state = loader.rng_state()
    index_batches = list(loader.iter_index_batches())
    loader.set_rng_state(state)
    widths = set()
    for idxs in index_batches:
        host = loader.collate_fn([loader.dataset[i] for i in idxs])
        placed, true_b, mask_total = trainer._place(host, split)
        got, got_b, got_total, _ = next(caches[split].stream([idxs], trainer.config.batch_size, trainer.shard))
        fields = [name for name, a, b in zip(got._fields, got, placed) if a.dtype != b.dtype or not torch.equal(a, b)]
        if fields or (got_b, got_total) != (true_b, mask_total):
            fail(f"phase 15a: the {split} batch {idxs} gathered differs from _place's in {fields or 'its counts'}")
        widths.add(got.input.shape[1 + trainer.experiment.time_axis])
    return len(index_batches), sorted(widths)


def _input_way_epoch(trainer, caches, way, profiled):
    """One train epoch from the input path `way`; (history, launches, train
    samples/s, host ms a step on the batch, epoch s, device busy s or None)."""
    import torch

    from wav2vec2forbrain_tpu_torch.ops import kernels

    trainer.caches = caches if way == "resident" else {}
    trainer.config.host_prefetch = way == "prefetch"
    trainer.step_timer.reset()
    kernels.reset_launches()
    torch.cuda.synchronize()
    profiler = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) if profiled
                else contextlib.nullcontext())
    with recorded_batches() as seen, profiler as prof:
        hist = trainer._train_epoch(trainer.dataloader_train, 0)
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    timer = trainer.step_timer
    host_ms = 1e3 * sum(b[4] for b in seen if b[0] == "train") / timer.steps
    busy_s = None
    if profiled:  # the raw trace: key_averages() takes tens of seconds over an epoch's kernels
        cuda = torch.autograd.DeviceType.CUDA
        busy_s = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                     if e.device_type() == cuda) / 1e9 or None
    return hist.to_dict(), launches, timer.samples_per_sec, host_ms, timer.total_time, busy_s


def input_path_phase(work, device_name, power):
    """Phase 15 (in its own scratch dir under phase 7's); returns
    {"<family>_input": launches of the first resident epoch}."""
    import torch

    from wav2vec2forbrain_tpu_torch.args.argparsing import get_experiment_from_args
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_synthetic_splits_dir
    from wav2vec2forbrain_tpu_torch.train.buckets import plan_buckets
    from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    os.makedirs(work)
    make_synthetic_splits_dir(os.path.join(work, "t12"), seed=SEED + 15, min_frames=200, max_frames=700,
                              **INPUT_SPLITS)
    with open(os.path.join(work, "config.yaml"), "w") as f:
        f.write(f"cache_dir: {work}/cache\nfig_dir: {work}/figs\nn3gram_lm_model_path: {work}/missing_3gram.arpa\n"
                f"n5gram_lm_model_path: {work}/missing_5gram.arpa\ndataset_splits_dir: {work}/t12\n"
                "wandb_api_key: offline\n")
    cwd = os.getcwd()
    os.chdir(work)
    out = {}
    try:
        for family in ("conformer", "w2v"):
            t_family = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            exp = get_experiment_from_args(CLI_FLAGS[family] + [
                "--w2v_skip_loading_weights=true", "--epochs=1", f"--seed={SEED}", f"--results_subdir_name={family}"])
            caches = exp.get_device_caches()
            sizes = {split: len(loader.dataset) for split, loader in (
                ("train", exp.dataloader_train), ("val", exp.dataloader_val), ("test", exp.dataloader_test))}
            if sorted(caches) != ["test", "train", "val"] or sizes["train"] < 256:
                fail(f"phase 15 {family}: resident splits {sorted(caches)} (want all three), split sizes {sizes}")
            print(f"  {FAMILY_NAMES[family]}, batch {exp.base_config.batch_size}, f32 compute, splits {sizes}")
            print("  (d) resident: " + "; ".join(
                f"{split} {c.nbytes} bytes at (T, U) ({c.t_full}, {c.u_full}), uploaded in {c.upload_s:.4f} s"
                for split, c in caches.items()) + f"; on {power}")
            trainer = Trainer(exp)
            # (a) the gather against _place, at the splits' widths and on a --length_buckets=4 grid
            checked = {}
            for label in ("split widths", f"--length_buckets={INPUT_BUCKETS}"):
                if label != "split widths":
                    grid = plan_buckets({s: c.input_lens for s, c in caches.items()},
                                        {s: c.t_full for s, c in caches.items()}, INPUT_BUCKETS,
                                        exp.base_config.pad_to_multiple)
                    for split, c in caches.items():
                        c.set_buckets(grid.get(split))
                    exp.t_buckets = {split: c.buckets for split, c in caches.items() if c.buckets}
                checked[label] = {split: _gathers_equal_place(trainer, caches, split) for split in ("train", "val")}
            for c in caches.values():
                c.set_buckets(None)
            exp.t_buckets = {}
            print(f"  (a) every gathered batch bitwise _place's (batches, widths): {checked}")
            # (b) one train epoch three ways from the same state, in turns, each twice (the second time profiled)
            for way in INPUT_WAYS:  # warm-up: each way once on the val split
                trainer.caches = caches if way == "resident" else {}
                trainer.config.host_prefetch = way == "prefetch"
                trainer._train_epoch(exp.dataloader_val, 0, split="val")
            saved = _train_state(trainer)
            runs, final = [], None
            for profiled in (False, True):
                for way in INPUT_WAYS:
                    _restore_train_state(trainer, saved)
                    hist, launches, sps, host_ms, epoch_s, busy_s = _input_way_epoch(trainer, caches, way, profiled)
                    params = tree_leaves(trainer.params)
                    if final is None:
                        final = [t.detach().clone() for t in params]
                        out[f"{family}_input"] = launches
                    same = all(torch.equal(a, b) for a, b in zip(params, final))
                    runs.append(dict(way=way, profiled=profiled, hist=hist, launches=launches, sps=sps,
                                     host_ms=host_ms, epoch_s=epoch_s, busy_s=busy_s, same_params=same))
            busy = {r["way"]: r["busy_s"] for r in runs if r["profiled"]}
            for r in runs:
                b = busy[r["way"]]
                share = "not measured" if b is None else f"{100 * b / r['epoch_s']:.1f}%"
                print(f"  (b) {r['way']:8s} {'profiled' if r['profiled'] else 'plain   '}: {r['sps']:.2f} train "
                      f"samples/s, {r['host_ms']:.3f} host ms a step on the batch, epoch {r['epoch_s']:.3f} s, device "
                      f"busy {share}{'' if b is None else f' ({b:.3f} s of kernels and copies)'}; on {power}")
            hist_same = all(r["hist"] == runs[0]["hist"] for r in runs)
            launch_same = all(r["launches"] == runs[0]["launches"] for r in runs)
            params_same = all(r["same_params"] for r in runs)
            print(f"  (b) histories bitwise equal {hist_same}, final params bitwise equal {params_same}; (c) kernel "
                  f"launches equal {launch_same}: {json.dumps(runs[0]['launches'])}")
            _check_launches(runs[0]["launches"], family, train=True)
            if not (hist_same and launch_same and params_same):
                fail(f"phase 15 {family}: the three input paths differ (histories {hist_same}, params "
                     f"{params_same}, launches {launch_same})")
            print(f"  {family}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                  f"{time.perf_counter() - t_family:.2f} s on {power}")
            del exp, trainer, caches, saved, runs, final
            torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
    print(f"  phase 15 took {time.perf_counter() - t_phase:.2f} s on {device_name} ({power})")
    return out


def _largest_rel(a_leaves, b_leaves):
    """The largest max-abs difference of two lists of tensors (None leaves
    skipped), each relative to the second's largest magnitude: 0.0 where
    every pair is bitwise equal."""
    import torch

    worst = 0.0
    for a, b in zip(a_leaves, b_leaves):
        if a is not None and not torch.equal(a, b):
            worst = max(worst, (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30))
    return worst


@contextlib.contextmanager
def _peak_before_pos_conv_bwd(marks):
    """Append to `marks` the allocator's peak when the gradient of w2v's
    pos-conv output is ready (every encoder layer's backward done, the
    pos-conv's not begun); a no-op for the conformer, which has none.
    w2v-base at phase 6's point peaks in that backward under every policy
    (`profile_train --family w2v --memory`: convolution_backward adds 24.28
    GiB over 3.59 live on an H100 80GB HBM3 at 700 W), so 16b holds the
    peak before it to `none`'s and prints the step's."""
    import torch

    from wav2vec2forbrain_tpu_torch.models import wav2vec2

    orig = wav2vec2.pos_conv_embed

    def hooked(*args, **kwargs):
        y = orig(*args, **kwargs)
        if y.requires_grad:
            y.register_hook(lambda g: marks.append(torch.cuda.max_memory_allocated()))
        return y

    wav2vec2.pos_conv_embed = hooked
    try:
        yield None
    finally:
        wav2vec2.pos_conv_embed = orig


def remat_step_phase(dev, power, family, policies, frames, compute_dtype, auto=False):
    """Phase 16a / 16b: two train steps of `family` under each policy from one
    set of params, Adam and BN state, seed streams (a LayerDrop replay that
    drops DROPPED_LAYER) and batches; then, with `auto`, phase 16c on the same
    (remat_auto_steps). Returns the launches of the second step under `min`."""
    import dataclasses

    import torch

    from wav2vec2forbrain_tpu_torch.data.batch import to_device
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
    from wav2vec2forbrain_tpu_torch.models import remat
    from wav2vec2forbrain_tpu_torch.ops import kernels, select
    from wav2vec2forbrain_tpu_torch.profile_train import BRAIN_LR, STEP_CFG, W2V_LR, build_trainer
    from wav2vec2forbrain_tpu_torch.train.optim import AdamState
    from wav2vec2forbrain_tpu_torch.train.steps import build_grad_fn
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    select.set_kernel_policy("auto")
    tr = build_trainer(dev, SEED, family, compute_dtype)
    enc_cfg = tr.spec.w2v_cfg if tr.spec.encoder_family == "wav2vec2" else tr.spec.conformer_cfg
    n_layers = enc_cfg.num_hidden_layers
    ran = n_layers - 1  # the replay drops DROPPED_LAYER in both steps
    batches = [to_device(b, dev) for b in make_requests(2, tr.batch_size, frames, SEED + 16)]
    opt0 = AdamState(tr.opt_state.count, _clone(tr.opt_state.mu), _clone(tr.opt_state.nu))
    print(f"  {FAMILY_NAMES[family]}, batch {tr.batch_size} x {frames} frames, {compute_dtype} compute, f32 stream, "
          f"layer {DROPPED_LAYER} dropped; two steps a policy from one state")
    ref, min_launches, step_peaks = None, None, {}
    for policy in policies:
        spec = dataclasses.replace(tr.spec, remat_policy=policy)
        grad_fn = build_grad_fn(spec, tr.labels, STEP_CFG)
        params, state = _clone(tr.params), _clone(tr.state)
        opt = AdamState(opt0.count, _clone(opt0.mu), _clone(opt0.nu))
        rng = _layerdrop_rng(SEED + 16, dev, n_layers, 2)
        losses, grads_by_step, states = [], [], []
        marks = []  # the allocator's peak when the pos-conv's output gradient is ready (w2v, the second step)
        for step, batch in enumerate(batches):
            torch.cuda.synchronize()
            if step == 1:
                gc.collect()  # the earlier phases' host garbage is not this step's time
                kernels.reset_launches()
                before = torch.cuda.memory_allocated()
                stats = torch.cuda.memory_stats()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
            with remat.counting() if step == 0 else _peak_before_pos_conv_bwd(marks) as saved:
                out, grads, _ = grad_fn(params, state, batch, rng)
            opt = tr.optimizer.step(params, grads, opt, BRAIN_LR, W2V_LR)  # the moments in place, the count anew
            torch.cuda.synchronize()
            if step == 0:
                saved_bytes = saved
            else:
                step_ms = 1e3 * (time.perf_counter() - t)
                launches = dict(kernels.LAUNCHES)
                step_peak = torch.cuda.max_memory_allocated() - before
                after = torch.cuda.memory_stats()
                mallocs = {k: after.get(k, 0) - stats.get(k, 0) for k in ("segment.all.allocated", "num_alloc_retries")}
            state = out["state"]
            losses.append(out["loss"].detach())
            grads_by_step.append(grads if ref is None else None)
            if ref is not None:  # against `none`'s step, then drop this policy's gradients
                grads_by_step[-1] = _largest_rel(tree_leaves(grads), tree_leaves(ref["grads"][step]))
            states.append(state)
            del out, grads
        step_peaks[policy] = step_peak
        resident = sum(t.numel() * t.element_size() for t in tree_leaves(params) + tree_leaves(opt.mu)
                       + tree_leaves(opt.nu) + tree_leaves(state) + list(batches[1]) if t is not None)
        peak = (resident + step_peak) / 2**30
        # the peak remat governs: the step's, or w2v's before its pos-conv's backward (_peak_before_pos_conv_bwd)
        governed = (resident + marks[-1] - before) / 2**30 if marks else peak
        governed_text = f"before the pos-conv's backward {governed:.2f}" if marks else ""
        row = dict(policy=policy, losses=losses, states=states, params=params, launches=launches, peak=peak,
                   governed=governed, step_ms=step_ms, saved=saved_bytes)
        if ref is None:
            if policy != "none":
                fail(f"phase 16 {family}: the first policy must be none, not {policy}")
            ref = dict(row, grads=grads_by_step)
            print(f"  none: step {step_ms:.1f} ms (cudaMalloc calls, allocator retries in it: {mallocs}), peak "
                  f"{peak:.2f} GiB (resident {resident / 2**30:.2f} + the step's {step_peak / 2**30:.2f}"
                  f"{'; ' + governed_text if governed_text else ''}), saved "
                  f"{saved_bytes.total / 2**30:.3f} GiB; losses "
                  f"{[float(x) for x in losses]}; launches a step {json.dumps(launches)} on {power}")
            continue
        loss_rel = max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(losses, ref["losses"]))
        state_rel = max(_largest_rel(tree_leaves(a), tree_leaves(b)) for a, b in zip(states, ref["states"]))
        grad_rel = max(grads_by_step)
        param_rel = _largest_rel(tree_leaves(params), tree_leaves(ref["params"]))
        bitwise = loss_rel == state_rel == grad_rel == param_rel == 0.0
        governed_ratio = f"; {governed_text}, {governed / ref['governed']:.3f}x" if governed_text else ""
        recomputed = WIDE_FWD_KERNELS if policy == "all_but_wide" else tuple(LAYER_FWD_KERNELS[family])
        want = {k: v + (ran * LAYER_FWD_KERNELS[family].get(k, 0) if k in recomputed else 0)
                for k, v in ref["launches"].items()}
        s = saved_bytes
        print(f"  {policy}: step {step_ms:.1f} ms ({step_ms / ref['step_ms']:.3f}x none; {mallocs}), peak "
              f"{peak:.2f} GiB ({peak / ref['peak']:.3f}x; the step's {step_peak / 2**30:.2f}{governed_ratio}), "
              f"saved {s.total / 2**30:.3f} GiB "
              f"(outside regions {s.saved / 2**30:.3f}, region inputs {s.inputs / 2**30:.3f}, kept products "
              f"{s.kept / 2**30:.3f}); against none: bitwise {bitwise} (loss rel {loss_rel:.2e}, BN {state_rel:.2e}, "
              f"gradients {grad_rel:.2e}, params {param_rel:.2e}); forward launches a step "
              f"{ {k: launches[k] for k in LAYER_FWD_KERNELS[family]} } (none's "
              f"{ {k: ref['launches'][k] for k in LAYER_FWD_KERNELS[family]} }) on {power}")
        if max(loss_rel, state_rel, grad_rel, param_rel) > REMAT_REL:
            fail(f"phase 16 {family} {policy}: the step differs from none's beyond {REMAT_REL}")
        if launches != want:
            fail(f"phase 16 {family} {policy}: launches a step {launches}, expected {want} (the recompute's)")
        if not (s.total < ref["saved"].total and governed < ref["governed"]):
            fail(f"phase 16 {family} {policy}: peak {governed:.2f} GiB / saved {s.total} bytes against none's "
                 f"{ref['governed']:.2f} / {ref['saved'].total}")
        if policy == "min":
            min_launches = launches
        del row, params, states
    if auto:
        print("  c. --remat_policy=auto's train steps (train/steps.py::RematAuto) on the same params, streams and "
              "batches")
        remat_auto_steps(dev, power, tr, batches, opt0, ref, step_peaks, n_layers)
    del ref, tr, batches, opt0
    torch.cuda.empty_cache()
    return min_launches


def remat_auto_steps(dev, power, tr, batches, opt0, ref, step_peaks, n_layers):
    """Phase 16c: two train steps through build_train_step under a RematAuto
    from 16a's params, Adam and BN state, streams and batches, the peak
    counter reset where none, the first candidate, takes over. `halfway`
    lies between the steps' own peaks under none and blocks (16a). a. At a
    budget of what is allocated plus halfway, the first step runs none and
    passes the budget, the second runs blocks. b. With the card filled (a
    uint8 ballast) to leave halfway free, at a budget of its whole memory,
    the first step runs out of memory under none and runs again under
    blocks. Both fail unless the steps are `none`'s (bitwise, else within
    REMAT_REL)."""
    import torch

    from wav2vec2forbrain_tpu_torch.profile_train import BRAIN_LR, STEP_CFG, W2V_LR
    from wav2vec2forbrain_tpu_torch.train.optim import AdamState
    from wav2vec2forbrain_tpu_torch.train.steps import RematAuto, build_train_step
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    class Logged(RematAuto):
        def __init__(self, budget):
            super().__init__(budget, dev)
            self.log = []  # (policy, ran) of every watched step

        def settle(self, batch, ran):
            self.log.append((self.policy, ran))
            return super().settle(batch, ran)

    def run(fill):
        params, state = _clone(tr.params), _clone(tr.state)
        opt = AdamState(opt0.count, _clone(opt0.mu), _clone(opt0.nu))
        rng = _layerdrop_rng(SEED + 16, dev, n_layers, 2)
        ballast = None
        if fill:
            torch.cuda.empty_cache()
            ballast = torch.empty(int(torch.cuda.mem_get_info(dev)[0] - halfway), dtype=torch.uint8, device=dev)
            auto = Logged(torch.cuda.get_device_properties(dev).total_memory)
        else:
            auto = Logged(torch.cuda.memory_allocated() + halfway)
        step = build_train_step(tr.spec, tr.labels, tr.optimizer, STEP_CFG, auto=auto)
        losses = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for batch in batches:
            out = step(params, opt, state, batch, rng, BRAIN_LR, W2V_LR)
            opt, state = out.opt_state, out.model_state
            losses.append(out.loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rel = max(max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(losses, ref["losses"])),
                  _largest_rel(tree_leaves(params), tree_leaves(ref["params"])))
        del params, state, opt, out, ballast
        torch.cuda.empty_cache()
        return auto, rel, wall

    halfway = (step_peaks["none"] + step_peaks["blocks"]) / 2  # between the steps' own peaks (16a)
    print(f"  the steps' own peaks (16a): none {step_peaks['none'] / 2**30:.2f} GiB, blocks "
          f"{step_peaks['blocks'] / 2**30:.2f} GiB; halfway {halfway / 2**30:.2f} GiB")
    for fill in (False, True):
        auto, rel, wall = run(fill)
        how = "the card filled to leave halfway free" if fill else "what is allocated plus halfway"
        print(f"  {'b' if fill else 'a'}. budget {auto.budget / 2**30:.2f} GiB ({how}): watched steps {auto.log}, "
              f"policy after them {auto.policy}; "
              f"against none's steps rel {rel:.2e}; two steps {wall:.2f} s on {power}")
        want = [("none", False), ("blocks", True)] if fill else [("none", True), ("blocks", True)]
        if auto.log != want or auto.policy != "blocks" or rel > REMAT_REL:
            fail(f"phase 16c: auto watched {auto.log} and ended at {auto.policy} (want {want}, blocks), rel {rel:.2e}")


def remat_phase(work, device_name, power, test_losses):
    """Phase 16 (in phase 7's scratch dir); returns {path: launches} of 16a's
    and 16b's second steps under min and of 16d's CLI run."""
    import math

    import torch

    from wav2vec2forbrain_tpu_torch.models import remat
    from wav2vec2forbrain_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    out = {}
    print("  a. the conformer at phase 15's shape, every policy")
    out["conformer_remat"] = remat_step_phase(dev, power, "conformer", remat.POLICIES, REMAT_FRAMES, torch.float32,
                                              auto=True)
    print(f"  b. w2v-base at phase 6's point, {REMAT_W2V_POLICIES}")
    out["w2v_remat"] = remat_step_phase(dev, power, "w2v", REMAT_W2V_POLICIES, 384, torch.bfloat16)

    print("  d. phase 7's conformer CLI at --remat_policy=min")
    kernels.reset_launches()
    exp, wall = _cli_run(CLI_FLAGS["conformer"] + [
        "--w2v_skip_loading_weights=true", "--epochs=2", "--checkpoint_every_n_epochs=1", f"--seed={SEED}",
        "--remat_policy=min", "--results_subdir_name=conformer_remat"])
    out["conformer_remat_cli"] = dict(kernels.LAUNCHES)
    with open(os.path.join(exp.results_dir, "history.json")) as f:
        test_loss = json.load(f)["test"]["average"]["loss"]
    ref = test_losses["conformer"]
    rel = abs(test_loss - ref) / abs(ref)
    print(f"  the CLI at min: {wall:.2f} s wall, test loss {test_loss!r} vs phase 7's {ref!r}: bitwise "
          f"{test_loss == ref}, rel {rel:.2e}; launches {json.dumps(out['conformer_remat_cli'])}")
    _check_launches(out["conformer_remat_cli"], "conformer", train=True)
    if not math.isfinite(test_loss) or rel > TP_CLI_TEST_LOSS_REL:
        fail(f"phase 16d: the test loss at min {test_loss} is not phase 7's {ref} (rel {rel:.2e})")
    if test_loss != ref:
        print(f"  (not bitwise: within {TP_CLI_TEST_LOSS_REL:.0e}; a policy changes no product, so look for a "
              f"kernel or library call that depends on its buffers' addresses)")
    del exp
    torch.cuda.empty_cache()
    print(f"  phase 16 took {time.perf_counter() - t_phase:.2f} s on {device_name} ({power})")
    return out


def cli_phases(device_name, power, phases):
    """Phases 7-16 (those in `phases`) in a scratch dir under build/
    (git-ignored), removed after; {path: launches} of the CLI training runs,
    the LM decode run, the sweep, phase 10's runs, phase 11a's ranks, phase
    12's `auto` paths, phase 13's runs, phase 14's ranks, phase 15's first
    resident epochs and phase 16's runs."""
    import shutil

    from scipy.io import loadmat

    from wav2vec2forbrain_tpu_torch.data.synthetic import make_synthetic_splits_dir

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cwd = os.getcwd()
    try:
        t = time.perf_counter()
        # train/: 2 sessions x 40 trials in 8 blocks -> test 10, train 70 (32 + 32 + 6 at batch 32, 64 + 6
        # at 64); test/ (the val split): 2 x 12 -> val 24
        splits = make_synthetic_splits_dir(os.path.join(work, "t12"), n_trials=40, n_blocks=8, test_dir_n_trials=12,
                                           seed=SEED, min_frames=200, max_frames=700)
        sentences = [str(s).strip() for name in sorted(os.listdir(os.path.join(splits, "train")))
                     for s in loadmat(os.path.join(splits, "train", name))["sentenceText"]]
        write_arpa(sentences, os.path.join(work, "3gram.arpa"))
        with open(os.path.join(work, "config.yaml"), "w") as f:
            f.write(f"cache_dir: {work}/cache\nfig_dir: {work}/figs\n"
                    f"n3gram_lm_model_path: {work}/3gram.arpa\n"
                    f"n5gram_lm_model_path: {work}/missing_5gram.arpa\n"
                    f"dataset_splits_dir: {work}/t12\nwandb_api_key: offline\n")
        print(f"  synthetic T12 splits, a 3-gram ARPA of their {len(sentences)} train sentences and config.yaml "
              f"written in {time.perf_counter() - t:.2f} s")
        os.chdir(work)  # the CLI reads ./config.yaml
        out, test_losses, models = {}, {}, {}
        for i, family in enumerate(("conformer", "w2v")):
            if 7 + i in phases:
                print(f"[{7 + i}] CLI: {FAMILY_NAMES[family]}")
                out.update(cli_phase(device_name, power, family, test_losses, models))
        if 9 in phases:
            print("[9] the sweep runner: sweeps/b2p2t_gru+w2v_training_from_scratch.yaml, the first two points")
            out["w2v_sweep"] = sweep_phase(work, device_name, power)
        if 10 in phases:
            print("[10] weights in: pretrained snapshots in the hub cache, the frozen sweep's first point, the "
                  "conformer's defaults, a JAX-format checkpoint")
            out.update(weights_phase(work, device_name, power))
        if 11 in phases:
            print("[11] data parallel: a. two ranks on the card over gloo, one conformer train step each, "
                  "replicated and ZeRO-1; b. the CLI under torchrun (NCCL, one rank, ZeRO-1)")
            out["conformer_dp"] = dp_step_phase(device_name, power)
            dp_cli_phase(work, device_name, power, test_losses["conformer"])
        if 12 in phases:
            print("[12] analysis: the brain streams of phases 8 and 7's models and an audio stream through the "
                  "snapshot's front end and the w2v-base encoder, auto and none")
            out.update(analysis_phase(work, models, device_name, power))
        if 13 in phases:
            print("[13] the train-state crossing: phase 8's train_state/ converted to the JAX package's "
                  "state.msgpack and resumed on the card; a w2v CLI epoch with its train batches grouped by width")
            out.update(crossing_phase(work, os.path.dirname(models["w2v"]), device_name, power))
        if 14 in phases:
            print(f"[14] tensor parallel (--mesh_model_parallel={TP_MODEL}), the ranks on the card over gloo: a. "
                  f"(1, 2), one conformer train step; b. (2, 2), one w2v-base step under ZeRO-1; c. the conformer "
                  f"CLI at (1, 2), one epoch")
            out["conformer_tp"] = tp_step_phase("a", device_name, power)
            out["w2v_tp"] = tp_step_phase("b", device_name, power)
            out["conformer_tp_cli"] = tp_cli_phase(work, device_name, power)
        if 15 in phases:
            print("[15] the input path: resident splits against _place, and train epochs resident, streamed with "
                  "prefetch and streamed inline, for both families")
            out.update(input_path_phase(os.path.join(work, "input_path"), device_name, power))
        if 16 in phases:
            print("[16] --remat_policy: every policy's train step against none's (peak memory, step ms, saved "
                  "bytes, the recompute's launches), auto's choice, the conformer CLI at min")
            out.update(remat_phase(work, device_name, power, test_losses))
        return out
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def parse_phases(argv):
    """The phases to run: every one without --phases; with --phases a,b,...
    those (1, the build, always), and the earlier phases whose results a
    listed phase reads (PHASE_NEEDS)."""
    if not argv:
        return set(range(1, LAST_PHASE + 1)), False
    if argv[0] != "--phases" or len(argv) != 2:
        fail(f"usage: python3 chip_smoke.py [--phases 1,2,14] (got {' '.join(argv)})")
    try:
        phases = {int(p) for p in argv[1].split(",") if p}
    except ValueError:
        fail(f"--phases takes phase numbers 1-{LAST_PHASE} separated by commas, not {argv[1]!r}")
    if not phases <= set(range(1, LAST_PHASE + 1)):
        fail(f"--phases: no phase {sorted(phases - set(range(1, LAST_PHASE + 1)))} (1-{LAST_PHASE})")
    for p in sorted(phases, reverse=True):
        phases |= PHASE_NEEDS.get(p, set())
    return phases | {1}, True


def main() -> None:
    phases, partial = parse_phases(sys.argv[1:])
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test runs on a CUDA card only")
    if torch.cuda.get_device_capability(0) != (9, 0):
        fail(f"needs compute capability 9.0 (Hopper), found {torch.cuda.get_device_capability(0)}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from wav2vec2forbrain_tpu_torch.ops import kernels, select
    except ImportError as e:
        fail(f"the port package is not beside this script ({e})")

    dev = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    power = smi.stdout.strip()
    print(power)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    if partial:
        print(f"--phases: running phases {sorted(phases)} only")
    select.f32_products()

    print("[1] build")
    kernels.lib(verbose=True)
    info = kernels.build_info
    print(f"  {info['path']} ({'cached' if info['cached'] else 'built'} in {info['seconds']:.1f} s)")
    for line in info["log"].splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    results = []
    if 2 in phases:
        print("[2] kernels vs plain on the card")
        kernel_phases(dev, results)
        torch.cuda.synchronize()

    serve, train = {}, {}
    for i, family in enumerate(("conformer", "w2v")):
        if 3 + 2 * i in phases:
            print(f"[{3 + 2 * i}] serving: {FAMILY_NAMES[family]}")
            serve[family] = serve_phase(dev, device_name, power, family)
            torch.cuda.synchronize()
        if 4 + 2 * i in phases:
            print(f"[{4 + 2 * i}] training: {FAMILY_NAMES[family]}")
            train[family] = train_phase(dev, device_name, power, family)
            torch.cuda.synchronize()
    cli = cli_phases(device_name, power, phases) if phases & set(range(7, LAST_PHASE + 1)) else {}

    rows = []
    for name, label in ROW_LABELS.items():
        mine = [r for r in results if r["name"] == name]
        at = next((r for r in mine if r["label"] == label), None)
        if at is None and not partial:
            fail(f"{name}: phase 2 timed no row at {label}")
        by_path = {f"{fam}_train": train[fam][0][name] for fam in train}
        by_path.update({path: cli[path][name] for path in cli})
        launches = sum(by_path.values())
        if launches <= 0 and not partial:
            fail(f"{name}: launched in no training run")
        for path in cli:
            family, training = CLI_PATHS[path]
            want = training if name == "adam" else (
                name.split("_bwd")[0] in PATH_KERNELS[family] and (training or not name.endswith("_bwd")))
            if (by_path[path] > 0) != want:
                fail(f"{name}: {by_path[path]} launches in the {path} run")
        timed = (lambda key: None) if at is None else at.get  # a partial run without phase 2: no times
        rows.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": max((r["err"] for r in mine), default=None),
            "ms": timed("ms"),
            "profiler_ms": timed("profiler_ms"),
            "call_ms": timed("call_ms"),
            "plain_ms": timed("plain_ms"),
            "bound_ms": timed("bound_ms"),
            "bound_by": timed("bound_by"),
            "library_ms": timed("library_ms"),
            "library_profiler_ms": timed("library_profiler_ms"),
            "at": label,
        })
    for family in serve:
        _, sps, sps_none = serve[family]
        print(f"{family}: serving samples/s auto {sps:.2f} none {sps_none:.2f} on {power}")
    for family in train:
        _, steps_ps, train_sps = train[family]
        print(f"{family}: training {steps_ps:.3f} steps/s, {train_sps:.2f} samples/s on {power}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # phase 11a's ranks
        dp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    elif sys.argv[1:2] == ["--tp-rank"]:  # phase 14a / b's ranks
        tp_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5])
    elif sys.argv[1:2] == ["--tp-cli-rank"]:  # phase 14c's ranks
        tp_cli_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
    else:
        main()
