"""Backward passes of the port's four kernels: each plain backward twin
against jax.vjp of the JAX package's Pallas kernel (interpret mode on CPU),
the autograd.Function wrappers against autograd of the plain forwards, and,
on a card, each CUDA backward kernel (and the attention forward with
dropout) against its plain twin.

Tolerances at f32, absolute per element: attention 2e-5 (64-term dots and a
T-term row sum in another order), GLU -> depthwise conv 1e-5 (31-tap and
T-term sums), biGRU 2e-5 (the carry passes the other-order sums through
every step), preproc 2e-5 (dW sums T rows of products; g is scaled by 0.1
so that dW stays O(1)). The dropout masks themselves are compared bit for
bit in test_torch_hash_dropout.py.
"""

import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu_torch.models.preprocessing import gaussian_kernel
from wav2vec2forbrain_tpu_torch.ops import attention as port_attn
from wav2vec2forbrain_tpu_torch.ops import conv_glu as port_conv
from wav2vec2forbrain_tpu_torch.ops import gru as port_gru
from wav2vec2forbrain_tpu_torch.ops import preproc as port_pre

torch.set_num_threads(1)
B, T, NH, D, C, KS = 3, 17, 4, 24, 96, 31


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _maxdiff(got, ref):
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32)).max())


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
def test_attention_bwd_plain_matches_jax_vjp(rate):
    import jax
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops.pallas_attention import mha_fused_bth as jax_mha

    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((B, T, NH * D)).astype(np.float32) for _ in range(4))
    seed, scale = 123457, 1.0 / np.sqrt(D)
    ctx, vjp = jax.vjp(lambda q, k, v: jax_mha(q, k, v, jnp.int32(seed), NH, scale, rate, jnp.float32),
                       *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    got = port_attn.mha_bwd_plain(*_t(q, k, v, g), NH, scale, rate, torch.float32, seed)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert _maxdiff(a.numpy(), b) <= 2e-5, name
    fwd = port_attn.mha_dense_bth(*_t(q, k, v), NH, scale, rate, torch.float32, seed)
    assert _maxdiff(fwd.numpy(), ctx) <= 2e-5


def test_attention_function_matches_autograd_of_dense():
    rng = np.random.default_rng(1)
    q, k, v, g = _t(*(rng.standard_normal((B, T, NH * D)).astype(np.float32) for _ in range(4)))
    grads = []
    for fn in (port_attn.mha_fused_bth, port_attn.mha_dense_bth):
        qkv = [a.clone().requires_grad_() for a in (q, k, v)]
        fn(*qkv, NH, 0.3, 0.1, torch.float32, 99).backward(g)
        grads.append([a.grad for a in qkv])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)


def test_conv_glu_bwd_plain_matches_jax_vjp():
    import jax
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops.pallas_conv_glu import glu_dwconv as jax_glu

    rng = np.random.default_rng(2)
    y = rng.standard_normal((B, T, 2 * C)).astype(np.float32)
    w = rng.uniform(-0.3, 0.3, (KS, C)).astype(np.float32)
    dz = rng.standard_normal((B, T, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda y, w: jax_glu(y, w, jnp.float32), jnp.asarray(y), jnp.asarray(w))
    dy_ref, dw_ref = vjp(jnp.asarray(dz))
    dy, dk = port_conv.glu_dwconv_bwd_plain(*_t(y, w, dz))
    assert dk.shape == (B, KS, C)
    assert _maxdiff(dy.numpy(), dy_ref) <= 1e-5
    assert _maxdiff(dk.sum(0).numpy(), dw_ref) <= 1e-5
    # the Function's gradient is the same twin, dK summed over the batch
    yt, wt = (a.clone().requires_grad_() for a in _t(y, w))
    port_conv.glu_dwconv(yt, wt).backward(torch.from_numpy(dz))
    assert _maxdiff(yt.grad.numpy(), dy_ref) <= 1e-5 and _maxdiff(wt.grad.numpy(), dw_ref) <= 1e-5


def _gru_inputs(seed, h=32, t=9, b=3):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((t, 2, b, 3 * h)).astype(np.float32),
        rng.uniform(-0.2, 0.2, (2, h, 3 * h)).astype(np.float32),
        rng.uniform(-0.2, 0.2, (2, 1, 3 * h)).astype(np.float32),
        (0.5 * rng.standard_normal((2, b, h))).astype(np.float32),
        rng.standard_normal((t, 2, b, h)).astype(np.float32),
    )


def test_gru_bwd_plain_matches_jax_vjp():
    import jax
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops.pallas_gru import gru_recurrence as jax_gru

    gi, w, b, h0, g = _gru_inputs(3)
    _, vjp = jax.vjp(lambda *a: jax_gru(*a, jnp.float32), *(jnp.asarray(a) for a in (gi, w, b, h0)))
    ref = vjp(jnp.asarray(g))
    tgi, tw, tb, th0, tg = _t(gi, w, b, h0, g)
    ys = port_gru.gru_recurrence_plain(tgi, tw, tb, th0)
    got = port_gru.gru_recurrence_bwd_plain(tgi, tw, tb, th0, ys, tg)
    for name, a, r in zip(("dgi", "dw_hh", "db_hh", "dh0"), got, ref):
        assert a.shape == r.shape, name
        assert _maxdiff(a.numpy(), r) <= 2e-5, name


def test_gru_function_matches_autograd_of_plain():
    gi, w, b, h0, g = _t(*_gru_inputs(4))
    grads = []
    for fn in (port_gru.gru_recurrence, port_gru.gru_recurrence_plain):
        args = [a.clone().requires_grad_() for a in (gi, w, b, h0)]
        fn(*args).backward(g)
        grads.append([a.grad for a in args])
    for a, r in zip(*grads):
        torch.testing.assert_close(a, r, atol=2e-5, rtol=0)


def _preproc_inputs(seed, b=2, t=96):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, 256)).astype(np.float32)
    w = (np.eye(256)[None] + 0.05 * rng.standard_normal((24, 256, 256))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((24, 1, 256))).astype(np.float32)
    days = np.array([3, 3, 17, 0][:b], np.int32)
    return x, w, bias, days


def test_preproc_bwd_plain_and_function_match_jax_vjp():
    """Two samples share a day, so the day-table sum (index_add_) is exercised."""
    import jax
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops.pallas_preproc import fused_preproc as jax_pre

    x, w, bias, days = _preproc_inputs(5, b=3)
    feats, vjp = jax.vjp(lambda x, w, b: jax_pre(x, w, b, jnp.asarray(days), 0.3),
                         *(jnp.asarray(a) for a in (x, w, bias)))
    g = (0.1 * np.random.default_rng(6).standard_normal(feats.shape)).astype(np.float32)
    dx_ref, dw_ref, db_ref = vjp(jnp.asarray(g))
    taps = gaussian_kernel(20, 0.3)
    dx, dw_b, db_b = port_pre.fused_preproc_bwd_plain(*_t(x, w, bias, days), taps, torch.from_numpy(g))
    assert dw_b.shape == (3, 256, 256) and db_b.shape == (3, 1, 256)
    assert _maxdiff(dx.numpy(), dx_ref) <= 2e-5
    assert _maxdiff((dw_b[0] + dw_b[1]).numpy(), np.asarray(dw_ref)[3]) <= 2e-5
    assert _maxdiff(db_b[2].numpy(), np.asarray(db_ref)[17]) <= 2e-5
    args = [a.clone().requires_grad_() for a in _t(x, w, bias)]
    port_pre.fused_preproc(args[0], args[1], args[2], torch.from_numpy(days), taps).backward(torch.from_numpy(g))
    for a, r in zip(args, (dx_ref, dw_ref, db_ref)):
        assert _maxdiff(a.grad.numpy(), r) <= 2e-5


# --- on the card -------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _bf16_tol(ref):
    return 2.0**-6 * max(1.0, ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("sd,cd", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.bfloat16)], ids=["f32", "f32_bf16cd", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
def test_cuda_attention_kernels_match_plain(sd, cd, rate):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, g = (torch.randn((4, 89, 1024), generator=gen, device=dev).to(sd) for _ in range(4))
    out = port_attn.mha_fused_bth(q, k, v, 16, 0.125, rate, cd, 2024)
    ref = port_attn.mha_dense_bth(q, k, v, 16, 0.125, rate, cd, 2024)
    atol = 2e-5 if cd == torch.float32 else _bf16_tol(ref)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    got = port_attn._bwd_kernel(q, k, v, g, 16, 0.125, rate, cd, 2024)
    want = port_attn.mha_bwd_plain(q, k, v, g, 16, 0.125, rate, cd, 2024)
    for a, r in zip(got, want):
        atol = 2e-5 if cd == torch.float32 else _bf16_tol(r)
        torch.testing.assert_close(a.float(), r.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("t", [118, 393, 1000])
def test_attention_bwd_wrapper_has_no_sequence_limit(t):
    """The backward kernels stream tiles: at any T the wrapper gets past its
    shape checks and refuses only operands that are not on a card. So does
    the forward's, which streams key tiles where they do not stay resident."""
    q = torch.zeros((1, t, 128))
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_attn._bwd_kernel(q, q, q, q, 2, 0.125, 0.1, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="head dim"):
        port_attn._bwd_kernel(*[torch.zeros((1, t, 256))] * 4, 1, 0.125, 0.1, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_attn._fwd_kernel(q, q, q, 2, 0.125, 0.0, torch.float32, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("t,b", [(169, 4), (393, 2)], ids=["T169", "T393"])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
def test_cuda_attention_bwd_long_sequences_match_plain(t, b, cd, rate):
    """Past T' = 117, where a backward kernel of (T, T) tiles would stop, to
    393; 16 heads of 64, an f32 stream (at f32 compute the split-TF32
    kernels)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(t)
    q, k, v, g = (torch.randn((b, t, 1024), generator=gen, device=dev) for _ in range(4))
    got = port_attn._bwd_kernel(q, k, v, g, 16, 0.125, rate, cd, 7)
    want = port_attn.mha_bwd_plain(q, k, v, g, 16, 0.125, rate, cd, 7)
    for a, r in zip(got, want):
        atol = 2e-5 * max(1.0, r.abs().max().item()) if cd == torch.float32 else _bf16_tol(r)
        torch.testing.assert_close(a, r, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 17, 89, 169, 400])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
def test_cuda_attention_bwd_bf16_matches_plain(t, rate):
    """The tensor-core backward (bf16 compute, f32 stream), 16 heads of 64,
    from one row to past the forward's shared-memory length."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(1000 + t)
    q, k, v, g = (torch.randn((2, t, 1024), generator=gen, device=dev) for _ in range(4))
    got = port_attn._bwd_kernel(q, k, v, g, 16, 0.125, rate, torch.bfloat16, 9)
    want = port_attn.mha_bwd_plain(q, k, v, g, 16, 0.125, rate, torch.bfloat16, 9)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, atol=_bf16_tol(r), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [24, 80, 100, 128])
@pytest.mark.parametrize("sd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_attention_bwd_bf16_head_dims_match_plain(d, sd):
    """Head dims the tensor-core kernels pad (to 64 or 128 columns), with
    and without 16-byte rows (d = 100), at an f32 and a bf16 stream."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(d)
    q, k, v, g = (torch.randn((3, 89, 4 * d), generator=gen, device=dev).to(sd) for _ in range(4))
    got = port_attn._bwd_kernel(q, k, v, g, 4, d**-0.5, 0.1, torch.bfloat16, 3)
    want = port_attn.mha_bwd_plain(q, k, v, g, 4, d**-0.5, 0.1, torch.bfloat16, 3)
    for a, r in zip(got, want):
        torch.testing.assert_close(a.float(), r.float(), atol=_bf16_tol(r), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 17, 89, 169, 400, 700])
@pytest.mark.parametrize("d", [24, 64, 80, 100, 128])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
def test_cuda_attention_bwd_tf32x3_matches_plain(t, d, rate):
    """The split-TF32 backward (f32 compute, f32 stream) against
    mha_bwd_plain, B 2, from one row to 700; head dims padded to 64 (24, 64)
    or 128 (80, 100, 128), 100 off the 16-byte grid; 16 heads at D 64, else
    4. The f32 tolerance: 2e-5 relative to the largest output."""
    dev = _cuda()
    heads = 16 if d == 64 else 4
    gen = torch.Generator(device=dev).manual_seed(10 * t + d)
    q, k, v, g = (torch.randn((2, t, heads * d), generator=gen, device=dev) for _ in range(4))
    got = port_attn._bwd_kernel(q, k, v, g, heads, d**-0.5, rate, torch.float32, 13)
    want = port_attn.mha_bwd_plain(q, k, v, g, heads, d**-0.5, rate, torch.float32, 13)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, atol=2e-5 * max(1.0, r.abs().max().item()), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [89, 400])
def test_cuda_attention_bwd_tf32x3_takes_a_bf16_stream(t):
    """f32 compute on a bf16 stream: outputs rounded to bf16 on both sides,
    so two bf16 ulps of the largest one."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(t)
    q, k, v, g = (torch.randn((2, t, 1024), generator=gen, device=dev).to(torch.bfloat16) for _ in range(4))
    got = port_attn._bwd_kernel(q, k, v, g, 16, 0.125, 0.1, torch.float32, 4)
    want = port_attn.mha_bwd_plain(q, k, v, g, 16, 0.125, 0.1, torch.float32, 4)
    for a, r in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), r.float(), atol=_bf16_tol(r), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_attention_bwd_is_deterministic(cd):
    """No atomics: two runs on the same inputs give bitwise-equal dq, dk, dv."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, g = (torch.randn((8, 89, 1024), generator=gen, device=dev) for _ in range(4))
    first = port_attn._bwd_kernel(q, k, v, g, 16, 0.125, 0.1, cd, 21)
    second = port_attn._bwd_kernel(q, k, v, g, 16, 0.125, 0.1, cd, 21)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _conv_bwd_inputs(dev, seed, t, c, ks, sd):
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn((4, t, 2 * c), generator=gen, device=dev).to(sd)
    dz = torch.randn((4, t, c), generator=gen, device=dev).to(sd)
    w = torch.rand((ks, c), generator=gen, device=dev) * 0.6 - 0.3
    return y, w, dz


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 15, 31, 89, 169, 400, 700])
@pytest.mark.parametrize("c", [100, 1024])
@pytest.mark.parametrize("ks", [31, 3])
@pytest.mark.parametrize("sd,cd", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.bfloat16)], ids=["f32", "f32_bf16cd", "bf16"])
def test_cuda_conv_glu_bwd_matches_plain(t, c, ks, sd, cd):
    """The backward kernel against its plain version at lengths within one
    96-frame chunk (1, 15, 31, 89), several chunks with a ragged last one
    (169, 400, 700), a channel count off the 16-byte grid and the
    32-channel tile (100), and a short kernel (3 taps)."""
    dev = _cuda()
    y, w, dz = _conv_bwd_inputs(dev, 1, t, c, ks, sd)
    dy, dk = port_conv._bwd_kernel(y, w, dz, cd)
    dy_ref, dk_ref = port_conv.glu_dwconv_bwd_plain(y, w, dz, cd)
    atol = 1e-5 if sd == torch.float32 else _bf16_tol(dy_ref)
    torch.testing.assert_close(dy.float(), dy_ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(dk, dk_ref, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("sd,cd", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.bfloat16)], ids=["f32", "f32_bf16cd", "bf16"])
def test_cuda_conv_glu_bwd_is_deterministic(sd, cd):
    """No atomics: two runs of the backward on the same inputs give bitwise
    equal dy and dK partials (the conformer's C 1024, several chunks)."""
    dev = _cuda()
    y, w, dz = _conv_bwd_inputs(dev, 2, 169, 1024, 31, sd)
    first = port_conv._bwd_kernel(y, w, dz, cd)
    second = port_conv._bwd_kernel(y, w, dz, cd)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _cuda_gru_inputs(dev, seed, t, b, h):
    gen = torch.Generator(device=dev).manual_seed(seed)
    gi = torch.randn((t, 2, b, 3 * h), generator=gen, device=dev)
    w = (torch.rand((2, h, 3 * h), generator=gen, device=dev) * 2 - 1) / h**0.5
    bias = (torch.rand((2, 1, 3 * h), generator=gen, device=dev) * 2 - 1) / h**0.5
    h0 = torch.randn((2, b, h), generator=gen, device=dev) * 0.5
    g = torch.randn((t, 2, b, h), generator=gen, device=dev)
    return gi, w, bias, h0, g


def _gru_bwd_tol(r, cd):
    # bf16: the carried dh and dgh are rounded to bf16 before each product
    return 1e-4 if cd == torch.float32 else 2.0**-6 * max(1.0, r.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("h", [32, 128, 256, 480])
@pytest.mark.parametrize("b", [3, 32])
@pytest.mark.parametrize("t", [1, 89])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_gru_bwd_matches_plain(h, b, t, cd):
    """The fused entry's backward at every width the model routes to it (H
    32 .. 480: 16 x 16 step tiles up to H 480 at B 32, Hp padding 32 -> 64
    at H 32 and 480 -> 512), a ragged and a full 32-row batch tile, one
    step and the conformer's 89."""
    dev = _cuda()
    gi, w, bias, h0, g = _cuda_gru_inputs(dev, 2, t, b, h)
    ys = port_gru.gru_recurrence_plain(gi, w, bias, h0, cd)
    got = port_gru._bwd_kernel(gi, w, bias, h0, ys, g, cd)
    want = port_gru.gru_recurrence_bwd_plain(gi, w, bias, h0, ys, g, cd)
    for a, r in zip(got, want):
        torch.testing.assert_close(a.reshape(r.shape), r, atol=_gru_bwd_tol(r, cd), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_gru_bwd_is_deterministic(cd):
    """No atomics: two runs of the fused backward on the same inputs give
    bitwise-equal dgi, dW_hh, db_hh and dh0 (the conformer's H256 B32 T89)."""
    dev = _cuda()
    gi, w, bias, h0, g = _cuda_gru_inputs(dev, 4, 89, 32, 256)
    ys = port_gru.gru_recurrence_plain(gi, w, bias, h0, cd)
    first = port_gru._bwd_kernel(gi, w, bias, h0, ys, g, cd)
    second = port_gru._bwd_kernel(gi, w, bias, h0, ys, g, cd)
    for a, r in zip(first, second):
        assert torch.equal(a, r)


@pytest.mark.cuda
def test_cuda_gru_fused_and_dir_bwd_agree_at_f32():
    """At f32 compute the fused entry's backward (dW in its own kernel) and
    the per-direction entry's (dW by the f32 product outside) compute the
    same function, at H = 256, a width both take."""
    dev = _cuda()
    gi, w, bias, h0, g = _cuda_gru_inputs(dev, 6, 89, 32, 256)
    ys = port_gru.gru_recurrence_plain(gi, w, bias, h0, torch.float32)
    fused = port_gru._bwd_kernel(gi, w, bias, h0, ys, g, torch.float32)
    per_dir = port_gru._bwd_kernel(gi, w, bias, h0, ys, g, torch.float32, per_direction=True)
    for a, r in zip(fused, per_dir):
        torch.testing.assert_close(a, r, atol=2e-5 * max(1.0, r.abs().max().item()), rtol=0)


@pytest.mark.cuda
def test_cuda_preproc_bwd_matches_plain():
    dev = _cuda()
    x, w, bias, days = (torch.from_numpy(a).to(dev) for a in _preproc_inputs(7, b=4, t=384))
    days = torch.tensor([0, 7, 23, 7], dtype=torch.int32, device=dev)
    taps = gaussian_kernel(20, 0.3, dev)
    g = 0.1 * torch.randn((4, 89, 8192), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    got = port_pre._bwd_kernel(x, w, bias, days, taps, g, 32, 4)
    want = port_pre.fused_preproc_bwd_plain(x, w, bias, days, taps, g)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, atol=2e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_hash_masks_equal_the_cpu_masks():
    """The int64 emulation gives the same bits on the card as on the CPU
    (where test_torch_hash_dropout.py holds it to the JAX package)."""
    from wav2vec2forbrain_tpu_torch.ops import hash_dropout as hd

    dev = _cuda()
    x = torch.randn((3, 17, 40), generator=torch.Generator().manual_seed(0))
    for seed in (0, 12345, 2**31 - 2):
        torch.testing.assert_close(hd.hash_dropout(x.to(dev), seed, 0.1).cpu(), hd.hash_dropout(x, seed, 0.1),
                                   atol=0, rtol=0)
        assert torch.equal(hd.hash_keep_mask(seed, (2, 4, 9, 9), 0.9, dev).cpu(), hd.hash_keep_mask(seed, (2, 4, 9, 9), 0.9))


@pytest.mark.cuda
def test_cuda_tiny_train_step_auto_matches_none():
    """A tiny conformer train step with dropout and LayerDrop on, through the
    kernels (`auto`) and the plain versions (`none`) from the same params and
    seed streams: loss rel 1e-5, updated params atol 2e-5 (f32; with Adam eps
    1e-4 a gradient difference d moves a param by at most lr * d / eps, as
    in test_torch_train_step.py)."""
    from wav2vec2forbrain_tpu_torch.data.batch import to_device
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
    from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec, init_model_params, param_labels
    from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
    from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
    from wav2vec2forbrain_tpu_torch.ops import kernels, select
    from wav2vec2forbrain_tpu_torch.train.optim import make_optimizer
    from wav2vec2forbrain_tpu_torch.train.steps import StepConfig, build_train_step
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    dev = _cuda()
    spec = ModelSpec(gru_hidden_size=128, latent_size=96, gru_dropout=0.1,
                     conformer_cfg=ConformerEncoderConfig.tiny_test(hidden_act="swish", layerdrop=0.3))
    batch = to_device(make_requests(1, 4, 160, 0)[0], dev)
    out = {}
    try:
        for policy in ("auto", "none"):
            select.set_kernel_policy(policy)
            params, state = init_model_params(torch.Generator(device=dev).manual_seed(0), spec, dev)
            labels = param_labels(params, "brain_encoder+w2v")
            opt = make_optimizer(labels, "adam", 0.0, 1e-4)
            step = build_train_step(spec, labels, opt, StepConfig(None, 0.02, 0.25))
            kernels.reset_launches()
            res = step(params, opt.init(params), state, batch, StepRng(3, dev), 1e-3, 1e-4)
            if policy == "auto":  # every kernel of the conformer path, forward and backward
                path = ("preproc", "gru", "attention", "conv_glu", "layernorm")
                assert all(kernels.LAUNCHES[k] > 0 and kernels.LAUNCHES[f"{k}_bwd"] > 0 for k in path), kernels.LAUNCHES
            out[policy] = (float(res.loss), [p.detach().clone() for p in tree_leaves(params)])
    finally:
        select.set_kernel_policy("auto")
    assert abs(out["auto"][0] - out["none"][0]) <= 1e-5 * abs(out["none"][0])
    for a, b in zip(out["auto"][1], out["none"][1]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
