"""Preprocessing chain: the port's plain version against the JAX package's
plain chain and its Pallas kernel (interpret mode on CPU), plus the CUDA
kernels against the plain version on a card.

Tolerance at f32: atol 1e-5 — the features are softsign outputs in (-1, 1)
and the only difference is the summation order of the 256-term affine
(on the card: split-TF32 tensor-core products, ~22 bits a product)."""

import numpy as np
import pytest
import torch

from test_torch_attention_conv import _mm1, _mm3
from test_torch_backward import _cuda_preproc_inputs
from wav2vec2forbrain_tpu_torch.models import preprocessing as port_pre
from wav2vec2forbrain_tpu_torch.ops import preproc as port_ops

torch.set_num_threads(1)
ATOL = 1e-5
SIGMA = 0.3


def _jax():
    """The JAX side, imported by the tests that use it, so that the `cuda`
    tests also run where jax is not installed (the card's machine)."""
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.models import preprocessing
    from wav2vec2forbrain_tpu.ops import pallas_preproc

    return jnp, preprocessing, pallas_preproc


def _inputs(seed=0, b=4, t=96):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, 256)).astype(np.float32)
    w = (np.eye(256)[None] + 0.05 * rng.standard_normal((24, 256, 256))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((24, 1, 256))).astype(np.float32)
    days = np.array([0, 7, 23, 7][:b], np.int32)
    lens = np.array([96, 90, 40, 33][:b], np.int32)
    return x, {"day_weights": w, "day_bias": bias}, days, lens


def _port(x, params, days, lens, fused):
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    taps = port_pre.gaussian_kernel(20, SIGMA)
    fn = port_ops.apply_preproc_fused if fused else port_pre.apply_preproc
    feats, out_lens = fn(tparams, torch.from_numpy(x), torch.from_numpy(days), torch.from_numpy(lens), taps)
    return feats.numpy(), out_lens.numpy()


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "wrapper_on_cpu"])
def test_port_matches_jax_plain_chain(fused):
    jnp, jax_pre, _ = _jax()
    x, params, days, lens = _inputs()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref, ref_lens = jax_pre.apply_preproc(
        jp, jnp.asarray(x), jnp.asarray(days), jnp.asarray(lens),
        jax_pre.gaussian_kernel(20, SIGMA),
    )
    feats, out_lens = _port(x, params, days, lens, fused)
    assert feats.shape == (4, 17, 8192)
    np.testing.assert_allclose(feats, np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(out_lens, np.asarray(ref_lens))


def test_port_matches_jax_pallas_kernel_interpret():
    jnp, _, pallas_preproc = _jax()
    x, params, days, lens = _inputs(seed=1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref, ref_lens = pallas_preproc.apply_preproc_pallas(jp, jnp.asarray(x), jnp.asarray(days), jnp.asarray(lens), SIGMA)
    feats, out_lens = _port(x, params, days, lens, fused=True)
    np.testing.assert_allclose(feats, np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(out_lens, np.asarray(ref_lens))


def test_channel_major_unfold_and_padding():
    """out[b, t', c*32 + j] = z[b, 4t' + j, c], and the 9/10 'same' padding."""
    x = torch.arange(2 * 40 * 3, dtype=torch.float32).reshape(2, 40, 3)
    u = port_pre.unfold_time(x, 32, 4)
    assert u.shape == (2, 3, 96)
    for t_out in range(3):
        for c in range(3):
            for j in (0, 5, 31):
                assert u[1, t_out, c * 32 + j] == x[1, 4 * t_out + j, c]
    impulse = torch.zeros(1, 30, 1)
    impulse[0, 15, 0] = 1.0
    taps = torch.arange(1, 21, dtype=torch.float32)
    y = port_pre.gaussian_smooth(impulse, taps)[0, :, 0]
    # y[t] = taps[i] where t - 9 + i == 15  ->  y[t] = taps[24 - t]
    for t in range(5, 25):
        assert y[t] == taps[24 - t]


def test_out_lens_floor_division():
    jnp, jax_pre, _ = _jax()
    lens = torch.tensor([384, 100, 35, 32, 31, 3])
    got = port_pre.preproc_out_lens(lens, 32, 4)
    ref = np.asarray(jax_pre.preproc_out_lens(jnp.asarray(lens.numpy()), 32, 4))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.tolist() == [88, 17, 0, 0, -1, -8] and got.dtype == torch.int32


def _preproc_fwd_with(mm, x, w, bias, days, taps):
    """fused_preproc_plain with its affine formed by mm, as the forward
    kernel forms it on the card."""
    d = days.long()
    pre = mm(port_pre.gaussian_smooth(x, taps), w[d]) + bias[d]
    return port_pre.unfold_time(pre / (1.0 + torch.abs(pre)), 32, 4)


@pytest.mark.parametrize("sigma", [0.3, 1.5])
@pytest.mark.parametrize("t", [96, 99])
def test_split_tf32_preproc_fwd_holds_the_f32_tolerance(t, sigma):
    """The forward's affine as split-TF32 products (emulated on the CPU:
    TF32 rounding on the int32 view, three products of TF32 parts, the small
    ones first) keeps the features within 1e-5 of the JAX package's Pallas
    kernel (interpret mode); one TF32 pass does not. T 96 and a ragged T 99,
    at both smoothing widths the models use."""
    jnp, _, pallas_preproc = _jax()
    x, params, days, _ = _inputs(seed=11, b=3, t=t)
    ref = np.asarray(pallas_preproc.fused_preproc(
        jnp.asarray(x), jnp.asarray(params["day_weights"]), jnp.asarray(params["day_bias"]), jnp.asarray(days),
        sigma))
    args = (torch.from_numpy(x), torch.from_numpy(params["day_weights"]), torch.from_numpy(params["day_bias"]),
            torch.from_numpy(days), port_pre.gaussian_kernel(20, sigma))

    def error(mm):
        out = _preproc_fwd_with(mm, *args).numpy()
        assert out.shape == ref.shape
        return float(np.abs(out - ref).max())

    split = error(_mm3)
    assert split <= ATOL, split
    assert error(_mm1) > ATOL


@pytest.mark.parametrize("t,kernel_len,stride", [(32, 32, 4), (99, 32, 4), (384, 32, 4), (700, 32, 4), (99, 20, 3)])
def test_preproc_fwd_wrapper_takes_any_length(t, kernel_len, stride):
    """The forward kernels take any T >= kernel_len and any window: the
    wrapper gets past its shape checks and refuses only operands off the
    card; it refuses more smoothing taps than the kernels hold (32)."""
    x = torch.empty((2, t, 256), device="meta")
    w, bias = torch.empty((24, 256, 256), device="meta"), torch.empty((24, 1, 256), device="meta")
    days = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_ops._fwd_kernel(x, w, bias, days, torch.empty((20,), device="meta"), kernel_len, stride)
    with pytest.raises(ValueError, match="smoothing taps"):
        port_ops._fwd_kernel(x, w, bias, days, torch.empty((33,), device="meta"), kernel_len, stride)


# --- on the card -------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(1, 32), (3, 99), (4, 384), (64, 384), (2, 700)],
                         ids=["B1_T32", "B3_T99", "B4_T384", "B64_T384", "B2_T700"])
@pytest.mark.parametrize("sigma", [0.3, 1.5])
def test_cuda_kernel_matches_plain(b, t, sigma):
    """The forward kernels (split-TF32 affine, the staged unfold of
    kernel_len 32 and stride 4) against the plain version: one window (T
    32), a ragged T 99 (T - 32 not a multiple of the stride), the main
    paths' T 384 at B 4 and the w2v batch of 64, and T 700 (the corpus'
    long end); days that repeat."""
    dev = _cuda()
    x, w, bias, days, _ = _cuda_preproc_inputs(dev, 2, b, t)
    taps = port_pre.gaussian_kernel(20, sigma, dev)
    out = port_ops.fused_preproc(x, w, bias, days, taps)
    ref = port_ops.fused_preproc_plain(x, w, bias, days, taps)
    assert out.shape == (b, (t - 32) // 4 + 1, 8192)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_len,stride", [(16, 4), (32, 2), (20, 3)])
def test_cuda_preproc_fwd_takes_other_windows(kernel_len, stride):
    """Windows other than (32, 4) take the unfold kernel's scalar copy; the
    affine is the main path's."""
    dev = _cuda()
    x, w, bias, days, _ = _cuda_preproc_inputs(dev, 3, 3, 99)
    taps = port_pre.gaussian_kernel(20, SIGMA, dev)
    out = port_ops._fwd_kernel(x, w, bias, days, taps, kernel_len, stride)
    ref = port_ops.fused_preproc_plain(x, w, bias, days, taps, kernel_len, stride)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_preproc_fwd_is_deterministic():
    """No atomics: two runs of the forward on the same inputs give bitwise
    equal features (B 8, T 384)."""
    dev = _cuda()
    x, w, bias, days, _ = _cuda_preproc_inputs(dev, 4, 8, 384)
    taps = port_pre.gaussian_kernel(20, 1.5, dev)
    first = port_ops._fwd_kernel(x, w, bias, days, taps, 32, 4)
    assert torch.equal(first, port_ops._fwd_kernel(x, w, bias, days, taps, 32, 4))
