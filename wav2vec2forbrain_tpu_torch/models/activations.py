"""Activation registry (counterpart of wav2vec2forbrain_tpu/models/activations.py):
the 18 names `--encoder_fc_activation_function` accepts, with the JAX
package's formulas (`gelu` the exact erf form, the gelu_* aliases the tanh
form, jax.nn.softplus's log(1 + e^x) inside mish)."""

import math

import torch
import torch.nn.functional as F


def _gelu(x):
    return F.gelu(x, approximate="none")


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def _laplace(x, mu=0.707107, sigma=0.282095):
    return 0.5 * (1.0 + torch.erf((x - mu) / (sigma * math.sqrt(2.0))))


def _mish(x):
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


ACT2FN = {
    "gelu": _gelu,
    "gelu_10": lambda x: torch.clamp(_gelu_tanh(x), -10.0, 10.0),
    "gelu_fast": _gelu_tanh,
    "gelu_new": _gelu_tanh,
    "gelu_python": _gelu,
    "gelu_pytorch_tanh": _gelu_tanh,
    "gelu_accurate": _gelu_tanh,
    "laplace": _laplace,
    "linear": lambda x: x,
    "mish": _mish,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
}
