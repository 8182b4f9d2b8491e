"""The port's hash dropout against the JAX package's, bit for bit: the
element mask of ops/hash_dropout.py over 1-D to 4-D shapes and seeds up to
2^31 - 2, its backward, and the attention mask of
ops/xla_attention.py::hash_keep_mask and of the Pallas kernel's
_keep_mask / _mix. Exact equality throughout: both sides compute the same
uint32 hash and compare the same f32 uniform with the same f32 keep
probability."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu.ops import hash_dropout as jax_hd
from wav2vec2forbrain_tpu.ops import pallas_attention as jax_pa
from wav2vec2forbrain_tpu.ops import xla_attention as jax_xa
from wav2vec2forbrain_tpu_torch.ops import hash_dropout as port_hd

SEEDS = [0, 1, 977, 2**31 - 2]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(37,), (5, 9), (3, 4, 33), (2, 3, 17, 5)], ids=["1d", "2d", "3d", "4d"])
def test_hash_dropout_is_bit_identical(shape, seed):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax_hd.hash_dropout(jnp.asarray(x), jnp.int32(seed), 0.1))
    got = port_hd.hash_dropout(torch.from_numpy(x), seed, 0.1).numpy()
    np.testing.assert_array_equal(got, ref)
    u_ref = np.asarray(jax_hd._uniform(shape, jnp.int32(seed)))
    np.testing.assert_array_equal(port_hd.hash_uniform(shape, seed).numpy(), u_ref)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hash_dropout_backward_and_bf16(rate):
    x = np.random.default_rng(3).standard_normal((4, 6, 8)).astype(np.float32)
    g = np.random.default_rng(4).standard_normal((4, 6, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_hd.hash_dropout(a, jnp.int32(123), rate), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    port_hd.hash_dropout(xt, 123, rate).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jax_hd.hash_dropout(xb, jnp.int32(5), rate).astype(jnp.float32))
    got = port_hd.hash_dropout(torch.from_numpy(x).to(torch.bfloat16), 5, rate)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_attention_keep_mask_is_bit_identical(seed):
    shape = (3, 4, 11, 13)
    ref = np.asarray(jax_xa.hash_keep_mask(jnp.int32(seed), shape, 0.9))
    got = port_hd.hash_keep_mask(seed, shape, 0.9).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0.8 < got.mean() < 0.97


def test_attention_keep_mask_matches_the_pallas_kernel_streams():
    """The Pallas kernel keys its mask on _mix(seed, global row, head) and
    then (q row, k col): the same mask, head by head."""
    b, h, t, d = 2, 3, 9, 4
    seed = 2**31 - 5
    got = port_hd.hash_keep_mask(seed, (b, h, t, t), 0.9).numpy()
    seed_ref = jnp.asarray([seed], jnp.int32)
    rows = jnp.arange(b, dtype=jnp.int32)
    heads = jnp.repeat(jnp.arange(h, dtype=jnp.int32), d)
    for r in range(b):
        for hh in range(h):
            mix = jax_pa._mix(seed_ref, rows, heads, r, hh, d)
            np.testing.assert_array_equal(got[r, hh], np.asarray(jax_pa._keep_mask((t, t), 0.9, mix)))
