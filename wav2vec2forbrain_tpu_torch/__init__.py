"""wav2vec2forbrain_tpu_torch — the PyTorch + CUDA port of wav2vec2forbrain_tpu.

The JAX package (`wav2vec2forbrain_tpu`) is the reference; this package
mirrors its layout (`args/`, `data/`, `experiments/`, `models/`, `ops/`,
`train/`, `util/`) so each module's counterpart is easy to find. Plain
tensor code is eager PyTorch; every Pallas kernel on the ported path is a hand-written CUDA C++ kernel for
Hopper (`csrc/*.cu`), built with nvcc at first use and bound with ctypes
(`ops/kernels.py`).

Ported: both model families, `b2p2t_gru+w2v_conformer`
(conformer-rope-large) and `b2p2t_gru+w2v` (wav2vec2-base), each
preprocessing -> biGRU -> FC -> encoder -> CTC head, for serving
(`predict.py::predict`, `train/steps.py::build_eval_step`) and for train
steps (`train/steps.py::build_train_step`, the Adam port in
`train/optim.py`, the loop `train/train_loop.py::train_batches`). All 11
`pl.pallas_call` sites of the JAX package's `ops/` have a CUDA counterpart,
forward and backward: preproc, the biGRU (fused and per direction),
attention with hash dropout, GLU -> depthwise conv and LayerNorm. The
entry points put their tensors on the card unless the caller names
another device (`bridge.py`, `models/seeds.py::StepRng`).

The CLI, `python -m wav2vec2forbrain_tpu_torch.run --experiment_type=...`
(`run.py` -> `args/argparsing.py` -> `experiments/impl.py` ->
`train/train_loop.py::Trainer`), takes the JAX CLI's flags and
config.yaml, reads the T12 `.mat` splits (`data/`) and trains, evaluates,
checkpoints (torch files, `train/checkpoint.py`) and predicts on the card
for both experiment types.

The paper's results path: the LM beam-search decode of the test split
(`decode/lm_decode.py`, a first-party C++ beam search over an ARPA or
kenlm binary n-gram model, built by g++ at first use into `build/`),
`--length_buckets` (`train/buckets.py`) and the sweep runner over
`sweeps/*.yaml` (`python -m wav2vec2forbrain_tpu_torch.sweep`).

Weights from files: pretrained HF encoders read offline from a local hub
cache (`models/hf_snapshot.py` -> `models/convert.py` -> the converted
cache of `models/pretrained.py`, shared with the JAX package), the JAX
package's msgpack checkpoints (`train/msgpack_codec.py`,
`train/checkpoint.py`) and the original reference's model.pt /
brain_encoder.pt; the converter CLI is `python -m
wav2vec2forbrain_tpu_torch.convert`.

Data parallelism (`parallel/`): one process a card under torchrun
(NCCL), BatchNorm over the global batch, dropout masks of the global rows,
optional ZeRO-1 (`--optimizer_state_sharding=zero1`).

The analysis (`analysis/`): the paper's brain-vs-audio latent comparison
(`analysis/latent_analysis.py`, the audio conv front end in
`models/audio_frontend.py`; both streams through the model on the card),
the sweep statistics (`analysis/results_analysis.py`) and the raw-data
EDA (`python -m wav2vec2forbrain_tpu_torch.analysis.raw_data_analysis`).

Not ported: tensor parallelism (`--mesh_model_parallel` above 1 raises),
and crossing a JAX train state (`train_state/`) into a port resume.

This package never imports jax, optax, flax, msgpack, transformers,
huggingface_hub, safetensors, pydantic, yaml, soundfile or pydub, and
imports matplotlib only inside the functions that plot.
"""

__version__ = "0.1.0"
