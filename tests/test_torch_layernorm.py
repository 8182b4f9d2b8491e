"""Row LayerNorm: the port's ops/layernorm.py against the JAX package's
ops/pallas_layernorm.py::layer_norm_fused (Pallas in interpret mode on the
CPU), forward and backward through its custom VJP; the routed model-side
entry; and the CUDA kernels against their plain versions on a card.

Tolerances: f32 forward 1e-5 absolute (outputs O(1)); f32 backward 2e-5 of
max(1, |largest output|) (dscale and dbias sum B * T products); a bf16
stream: two bf16 ulps of the largest output, 2^-6 * max(1, |ref|) (both
sides round the same f32 value to bf16, but f32 sums in another order can
move it across a rounding boundary)."""

import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu_torch.models.wav2vec2 import _layer_norm_routed
from wav2vec2forbrain_tpu_torch.ops import layernorm as port_ln
from wav2vec2forbrain_tpu_torch.ops import select as port_select

torch.set_num_threads(1)
EPS = 1e-5
B, T = 3, 8
BF16_ULPS = 2.0**-6


def _inputs(seed, c):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, c)) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal((B, T, c)).astype(np.float32)
    return x, scale, bias, dy


def _jax(x, scale, bias, dy, dtype):
    """The JAX package's layer_norm_fused and its VJP (imported here, so that
    the `cuda` tests also run where jax is not installed); dtype a name."""
    import jax
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops.pallas_layernorm import layer_norm_fused as jax_layer_norm_fused

    dtype = jnp.dtype(dtype)
    jx = jnp.asarray(x).astype(dtype)
    y, vjp = jax.vjp(lambda a, s, b: jax_layer_norm_fused(a, s, b, EPS), jx, jnp.asarray(scale), jnp.asarray(bias))
    dx, ds, db = vjp(jnp.asarray(dy).astype(dtype))
    return [np.asarray(a.astype(jnp.float32)) for a in (y, dx, ds, db)]


def _port(x, scale, bias, dy, dtype):
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    y = port_ln.layer_norm(tx, ts, tb, EPS)
    assert y.dtype == dtype
    # an f32 upstream gradient: the VJP rounds it to the stream dtype first
    y.backward(torch.from_numpy(dy).to(dtype).float().to(y.dtype))
    return [a.detach().float().numpy() for a in (y, tx.grad, ts.grad, tb.grad)]


@pytest.mark.parametrize("c", [96, 100], ids=["C96", "C100"])
def test_layer_norm_f32_matches_jax(c):
    args = _inputs(0, c)
    ref = _jax(*args, "float32")
    got = _port(*args, torch.float32)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5, rtol=0)
    for name, g, r in zip(("dx", "dscale", "dbias"), got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, atol=2e-5 * max(1.0, np.abs(r).max()), rtol=0, err_msg=name)


def test_layer_norm_bf16_stream_matches_jax():
    args = _inputs(1, 96)
    ref = _jax(*args, "bfloat16")
    got = _port(*args, torch.bfloat16)
    for name, g, r in zip(("y", "dx", "dscale", "dbias"), got, ref):
        np.testing.assert_allclose(g, r, atol=BF16_ULPS * max(1.0, np.abs(r).max()), rtol=0, err_msg=name)


def test_kernel_entries_refuse_what_the_kernels_do_not_take():
    """The kernel entries never run a plain version: CPU tensors, 2-D x and
    C > 1024 are refused before any launch."""
    x, scale, bias, dy = (torch.from_numpy(a) for a in _inputs(2, 96))
    with pytest.raises(ValueError, match="CUDA"):
        port_ln._fwd_kernel(x, scale, bias, EPS)
    with pytest.raises(ValueError, match="CUDA"):
        port_ln._bwd_kernel(x, scale, dy, EPS)
    with pytest.raises(ValueError, match=r"\(B, T, C\)"):
        port_ln._fwd_kernel(x[0], scale, bias, EPS)
    wide = torch.zeros(1, 2, 1056)
    with pytest.raises(ValueError, match="1024"):
        port_ln._fwd_kernel(wide, torch.ones(1056), torch.zeros(1056), EPS)


def test_plain_backward_partials_sum_to_the_autograd_gradient():
    """layer_norm_bwd_plain's (B, C) partials summed over B are autograd's
    gradient of the plain forward."""
    x, scale, bias, dy = (torch.from_numpy(a) for a in _inputs(3, 64))
    xs, ss, bs = (a.clone().requires_grad_(True) for a in (x, scale, bias))
    port_ln.layer_norm_plain(xs, ss, bs, EPS).backward(dy)
    dx, dg, db = port_ln.layer_norm_bwd_plain(x, scale, dy, EPS)
    assert dg.shape == db.shape == (B, 64)
    torch.testing.assert_close(dx, xs.grad, atol=2e-6, rtol=0)
    torch.testing.assert_close(dg.sum(0), ss.grad, atol=2e-5, rtol=0)
    torch.testing.assert_close(db.sum(0), bs.grad, atol=2e-5, rtol=0)


@pytest.mark.parametrize("policy", ["auto", "none"])
def test_routed_layer_norm_is_the_plain_math_on_cpu(policy):
    x, scale, bias, _ = (torch.from_numpy(a) for a in _inputs(4, 96))
    p = {"scale": scale, "bias": bias}
    port_select.set_kernel_policy(policy)
    try:
        y3 = _layer_norm_routed(p, x, EPS)
        y2 = _layer_norm_routed(p, x[0], EPS)  # 2-D: always the plain version
    finally:
        port_select.set_kernel_policy("auto")
    torch.testing.assert_close(y3, port_ln.layer_norm_plain(x, scale, bias, EPS), atol=0, rtol=0)
    torch.testing.assert_close(y2, port_ln.layer_norm_plain(x[0], scale, bias, EPS), atol=0, rtol=0)


def _cuda_inputs(shape, dtype, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    scale = 1 + 0.3 * torch.randn(c, generator=g, device=dev)
    bias = 0.2 * torch.randn(c, generator=g, device=dev)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    return x, scale, bias, dy


def _cuda_tol(r, f32_tol, dtype):
    return (BF16_ULPS if dtype == torch.bfloat16 else f32_tol) * max(1.0, r.float().abs().max().item())


def _check_bwd(x, scale, dy):
    for out, r in zip(port_ln._bwd_kernel(x, scale, dy, EPS), port_ln.layer_norm_bwd_plain(x, scale, dy, EPS)):
        assert out.dtype == r.dtype and out.shape == r.shape
        torch.testing.assert_close(out.float(), r.float(), atol=_cuda_tol(r, 2e-5, x.dtype), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 89, 768), (32, 89, 1024), (3, 8, 100), (64, 1, 768), (5, 37, 1024)],
                         ids=["w2v", "conformer", "ragged", "T1", "T37"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_kernels_match_plain(shape, dtype):
    """The encoders' shapes, a ragged C (the generic kernels), one row per
    batch element (one T chunk), and T = 37 (prime: whatever the chunk count
    the host picks, a chunk is partial, and the last ones may be empty)."""
    x, scale, bias, dy = _cuda_inputs(shape, dtype)
    y = port_ln._fwd_kernel(x, scale, bias, EPS)
    ref = port_ln.layer_norm_plain(x, scale, bias, EPS)
    assert y.dtype == dtype
    atol = _cuda_tol(ref, 0.0, dtype) if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=0)
    _check_bwd(x, scale, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 3, 4, 9])
@pytest.mark.parametrize("c", [768, 100], ids=["C768", "C100"])
def test_cuda_bwd_chunk_edges_match_plain(monkeypatch, chunks, c):
    """The backward at T = 9 split into a given number of T chunks: one, 3
    whole chunks, 4 (3 + 3 + 3 + an empty one, whose partial is zero) and
    one row per chunk; the vector and generic kernels."""
    x, scale, _, dy = _cuda_inputs((4, 9, c), torch.float32, seed=1)
    monkeypatch.setattr(port_ln, "_bwd_chunks", lambda *a: chunks)
    _check_bwd(x, scale, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_bwd_is_deterministic(dtype):
    """No atomics: two runs of the backward give bitwise-equal dx and partials."""
    x, scale, _, dy = _cuda_inputs((64, 89, 768), dtype, seed=2)
    first = port_ln._bwd_kernel(x, scale, dy, EPS)
    second = port_ln._bwd_kernel(x, scale, dy, EPS)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_forward_takes_rows_off_the_16_byte_grid(dtype):
    """x at C = 768 but 4 or 2 bytes off a 16-byte boundary: the forward
    takes its generic kernel (scalar loads) and agrees with the plain
    version as the vector kernel does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    shape = (5, 89, 768)
    flat = (torch.randn(1 + 5 * 89 * 768, generator=g, device=dev) * 2 + 0.5).to(dtype)
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    scale = 1 + 0.3 * torch.randn(768, generator=g, device=dev)
    bias = 0.2 * torch.randn(768, generator=g, device=dev)
    y = port_ln._fwd_kernel(x, scale, bias, EPS)
    ref = port_ln.layer_norm_plain(x, scale, bias, EPS)
    atol = BF16_ULPS * max(1.0, ref.float().abs().max().item()) if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=0)
