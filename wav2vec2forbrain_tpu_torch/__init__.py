"""wav2vec2forbrain_tpu_torch — the PyTorch + CUDA port of wav2vec2forbrain_tpu.

The JAX package (`wav2vec2forbrain_tpu`) is the reference; this package
mirrors its layout (`models/`, `ops/`, `train/`) so each module's
counterpart is easy to find. Plain tensor code is eager PyTorch; every
Pallas kernel on the ported path is a hand-written CUDA C++ kernel for
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
another device (`bridge.py`, `models/seeds.py::StepRng`). Not ported: the
Trainer's epochs and checkpoints, the CLI, LM decoding, multi-GPU.

This package never imports jax, optax, flax, transformers or pydantic.
"""

__version__ = "0.1.0"
