"""Per-kernel selection policy (counterpart of wav2vec2forbrain_tpu/ops/select.py).

Same kernel names and the same policy values as the JAX package:
  - "auto" (default): every kernel this port has a CUDA kernel for
  - "all" / "none": force every kernel on / off
  - comma list, e.g. "attention,gru": exactly these kernels

"ctc" is the port's own (csrc/ctc.cu, a fixed-order CTC loss and gradient
that makes w2v-base training reproducible on the card); the JAX package
has no such kernel (it runs optax's CTC), so its policies do not name it.
"adam" is the port's own too (csrc/adam.cu, the optimizer's update of
every trained leaf in one launch, train/optim.py); XLA fuses the JAX
package's optax update.

None of the JAX package's `auto` verdicts carry over: they were measured on a
TPU (the JAX `auto` keeps "layernorm" on XLA after a TPU A/B). The port's
`auto` turns on every ported kernel (PORTED), and stays so until an H100
A/B of the end-to-end metrics moves one off (PERF.md has the per-kernel
times). "dropout" has no kernel: it runs its plain PyTorch version whatever
the policy says.

A routed kernel's wrapper runs the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises.

`f32_products()` is the port's one switch for the libraries' numerics: the
experiment, `predict.predict` and the chip scripts call it.
"""

import torch

KERNELS = ("preproc", "gru", "attention", "conv_glu", "layernorm", "dropout", "ctc", "adam")
PORTED = ("preproc", "gru", "attention", "conv_glu", "layernorm", "ctc", "adam")

_policy = "auto"


def validate_kernel_policy(policy: str) -> None:
    """Raise ValueError unless policy is a valid --pallas_kernels value."""
    if policy in ("auto", "all", "none"):
        return
    names = {s.strip() for s in policy.split(",") if s.strip()}
    if not names or names - set(KERNELS):
        raise ValueError(
            f"kernel policy {policy!r}: expected 'auto', 'all', 'none' or "
            f"a comma list drawn from {KERNELS}"
        )


def set_kernel_policy(policy: str) -> None:
    """Install the process-wide kernel policy (validated)."""
    global _policy
    validate_kernel_policy(policy)
    _policy = policy


def kernel_enabled(name: str) -> bool:
    """Should the hand-written kernel `name` run?"""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; expected one of {KERNELS}")
    if name not in PORTED:
        return False
    if _policy in ("auto", "all"):
        return True
    if _policy == "none":
        return False
    return name in {s.strip() for s in _policy.split(",") if s.strip()}


def f32_products() -> None:
    """Turn TF32 off for cuBLAS and cuDNN, process-wide, so that f32
    compute takes f32 products in the library calls too (the w2v pos-conv's
    cuDNN convolution, the f32 matmuls around the kernels)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
