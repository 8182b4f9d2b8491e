"""Attention and GLU -> depthwise conv: the port's plain versions against the
JAX package's Pallas kernels (interpret mode on CPU, dropout rate 0) and
dense/XLA paths; the CUDA kernels against the plain versions on a card.

Tolerances at f32: attention atol 2e-5 (64-term dots and a T-term softmax
sum in another order), conv_glu atol 1e-5 (31-tap sums in another order)."""

import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu_torch.ops import attention as port_attn
from wav2vec2forbrain_tpu_torch.ops import conv_glu as port_conv

torch.set_num_threads(1)
B, T, NH, D, C, KS = 3, 17, 4, 24, 96, 31


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, NH * D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("route", ["pallas_interpret", "dense"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_attention_matches_jax(route, cd):
    # the JAX side is imported here, so that the `cuda` tests below also run
    # where jax is not installed (the card's machine)
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops.pallas_attention import mha_fused_bth as jax_mha_fused
    from wav2vec2forbrain_tpu.ops.xla_attention import mha_dense_bth as jax_mha_dense

    q, k, v = _qkv(0)
    scale = 1.0 / np.sqrt(D)
    fn = jax_mha_fused if route == "pallas_interpret" else jax_mha_dense
    ref = np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.zeros((), jnp.int32),
                        NH, scale, 0.0, jnp.dtype(cd)))
    got = port_attn.mha_fused_bth(*(torch.from_numpy(a) for a in (q, k, v)), NH, scale, 0.0,
                                  getattr(torch, cd)).numpy()
    # bf16: q, k, p, v rounded to bf16 in both; a probability rounded to the
    # other side of a bf16 boundary moves the output by < 1e-3
    np.testing.assert_allclose(got, ref, atol=2e-5 if cd == "float32" else 1e-3, rtol=0)


def test_attention_no_padding_mask_and_dropout_raises():
    """No key-padding mask; a dropout rate outside [0, 1) raises (train-mode
    dropout itself runs since the training slice, test_torch_backward.py)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1))
    ctx = port_attn.mha_dense_bth(q, k, v, NH, 0.2, 0.0, torch.float32)
    # changing a late frame's key changes every query's output: no mask
    k2 = k.clone()
    k2[:, -1] += 1.0
    ctx2 = port_attn.mha_dense_bth(q, k2, v, NH, 0.2, 0.0, torch.float32)
    assert torch.all((ctx2 - ctx).abs().amax(dim=-1) > 0)
    for fn in (port_attn.mha_fused_bth, port_attn.mha_dense_bth):
        with pytest.raises(ValueError, match="dropout rate"):
            fn(q, k, v, NH, 0.2, 1.0, torch.float32)


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
def test_dense_attention_matches_jax_at_a_long_sequence(rate):
    """T' = 400 (past the lengths at which the forward kernels keep a head's
    key tiles resident): the port's dense version, which the kernels are
    held to on the card, against the JAX dense path, B = 1, 2 heads of 64,
    f32, the same dropout hash. Tolerance 2e-5: 64-term dots and a 400-term
    softmax sum in another order."""
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops.xla_attention import mha_dense_bth as jax_mha_dense

    rng = np.random.default_rng(400)
    q, k, v = (rng.standard_normal((1, 400, 128)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax_mha_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(11, jnp.int32),
                                   2, 0.125, rate, jnp.float32))
    got = port_attn.mha_dense_bth(*(torch.from_numpy(a) for a in (q, k, v)), 2, 0.125, rate, torch.float32, 11)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("t", [1, 89, 169, 393, 394, 400, 700])
def test_attention_fwd_wrapper_takes_any_sequence_length(t):
    """The forward wrapper chooses its kernel by compute dtype and head width:
    for heads up to 128 the tensor-core kernel of the compute dtype at every
    T ("mma" at bf16, the split-TF32 "tf32x3" at f32; head dims 64 and 80
    alike); for a head of 192 at f32 compute the SIMT kernel that holds K
    and V in shared memory, only where they fit (T <= 137), and no kernel
    at bf16. It refuses only operands that are not on a card, never a
    length."""
    for d in (64, 80):
        assert port_attn._fwd_route(t, d, torch.bfloat16) == "mma"
        assert port_attn._fwd_route(t, d, torch.float32) == "tf32x3"
    assert port_attn._fwd_route(t, 192, torch.float32) == ("resident" if t <= 137 else None)
    assert port_attn._fwd_route(t, 192, torch.bfloat16) is None
    q = torch.zeros((1, t, 128))
    for cd in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="CUDA tensors"):
            port_attn._fwd_kernel(q, q, q, 2, 0.125, 0.1, cd, 0)


def test_attention_fwd_wrapper_refuses_heads_its_kernels_do_not_take():
    """Heads wider than 128: the tensor-core kernels refuse them at every T;
    at f32 compute the SIMT kernel takes them where a head's K and V fit in
    shared memory."""
    q = torch.zeros((1, 89, 2 * 192))
    with pytest.raises(ValueError, match="head dim 192"):
        port_attn._fwd_kernel(q, q, q, 2, 0.125, 0.0, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_attn._fwd_kernel(q, q, q, 2, 0.125, 0.0, torch.float32, 0)
    q = torch.zeros((1, 400, 2 * 192))
    with pytest.raises(ValueError, match="head dim 192"):
        port_attn._fwd_kernel(q, q, q, 2, 0.125, 0.0, torch.float32, 0)


def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away
    from zero, as cvt.rna.tf32.f32 does and as the kernels do it
    (csrc/attention.cu::tf32_rna): on the int32 view of the f32 bits, add
    half the range of the 13 dropped bits, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b (batched) as the f32 attention kernels form it: x = big + small
    with big = tf32(x), small = tf32(x - big); three products of TF32 parts
    (each exact in f32), summed in f32, the small ones first."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return (a_big @ b_small + a_small @ b_big) + a_big @ b_big


def _mm1(a, b):
    """a @ b in one TF32 pass (operands rounded to TF32)."""
    return _tf32(a) @ _tf32(b)


def _attention_with(mm, q, k, v, g, heads, scale, rate, seed):
    """mha_dense_bth and mha_bwd_plain at f32 compute with every one of their
    seven products formed by mm: (o, dq, dk, dv)."""
    b, t, _ = q.shape
    qh, kh, vh, gh = (port_attn._heads(x, heads, torch.float32) for x in (q, k, v, g))
    p = torch.softmax(mm(qh, kh.transpose(1, 2)) * scale, dim=-1)
    masked = port_attn._scaled_mask(seed, b, heads, t, rate, q.device)
    mask = None if masked is None else masked[0] * masked[1]
    pd = p if mask is None else p * mask
    o = mm(pd, vh)
    dv = mm(pd.transpose(1, 2), gh)
    dp = mm(gh, vh.transpose(1, 2))
    if mask is not None:
        dp = dp * mask
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = mm(ds, kh) * scale
    dk = mm(ds.transpose(1, 2), qh) * scale
    return tuple(port_attn._unheads(x, b, heads, torch.float32) for x in (o, dq, dk, dv))


@pytest.mark.parametrize("t", [89, 400])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
def test_split_tf32_attention_holds_the_f32_tolerance(t, rate):
    """The split-TF32 scheme of the f32 attention kernels, emulated on the
    CPU (TF32 rounding on the int32 view), in the forward's two products and
    the backward's five, B 2, 4 heads of 64, scale 1/8: within the f32
    tolerances of the plain versions (chip_smoke's TOL_F32: 2e-5 abs for the
    forward, 2e-5 relative to the largest output for the backward). One
    TF32 pass misses them, which shows that the emulation rounds."""
    rng = np.random.default_rng(t + int(10 * rate))
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, t, 256)).astype(np.float32)) for _ in range(4))
    args = (4, 0.125, rate, torch.float32, 31)
    refs = (port_attn.mha_dense_bth(q, k, v, *args), *port_attn.mha_bwd_plain(q, k, v, g, *args))
    tols = [2e-5] + [2e-5 * max(1.0, r.abs().max().item()) for r in refs[1:]]

    def errors(mm):
        return [(x - r).abs().max().item() for x, r in zip(_attention_with(mm, q, k, v, g, 4, 0.125, rate, 31), refs)]

    split = errors(_mm3)
    assert all(e <= tol for e, tol in zip(split, tols)), (split, tols)
    assert any(e > tol for e, tol in zip(errors(_mm1), tols))


def _attention_f64(q, k, v, g, heads, scale, rate, seed):
    """(o, dq, dk, dv) of the attention function in f64 on f64 copies of the
    operands: the exact result that the f32 versions round."""
    b, t, width = q.shape
    qh, kh, vh, gh = (x.double().view(b, t, heads, width // heads).transpose(1, 2).reshape(b * heads, t, -1)
                      for x in (q, k, v, g))
    p = torch.softmax(torch.bmm(qh, kh.transpose(1, 2)) * scale, dim=-1)
    masked = port_attn._scaled_mask(seed, b, heads, t, rate, q.device)
    mask = None if masked is None else masked[0].double() * masked[1]
    pd = p if mask is None else p * mask
    dp = torch.bmm(gh, vh.transpose(1, 2))
    dp = dp if mask is None else dp * mask
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    outs = (torch.bmm(pd, vh), torch.bmm(ds, kh) * scale, torch.bmm(ds.transpose(1, 2), qh) * scale,
            torch.bmm(pd.transpose(1, 2), gh))
    return [port_attn._unheads(x, b, heads, torch.float64) for x in outs]


def _errors_vs_f64(outs, exact):
    return [(x.double() - e).abs().max().item() for x, e in zip(outs, exact)]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
def test_split_tf32_attention_at_large_logits_is_f32_class(rate):
    """Logits 8x those of the tests above (scale 1, q not pre-scaled: s over
    64 unit normals has std 8), B 4, 12 heads of 64, T' 89: the f32 rounding
    of s, amplified by the softmax, is then the larger part of any f32
    version's error. The emulated split-TF32 forward and backward, against
    the f64 result, are each within twice the plain f32 version's own error
    of it (chip_smoke's F32_CLASS_FACTOR), as are the kernels on the card."""
    rng = np.random.default_rng(8 + int(10 * rate))
    q, k, v, g = (torch.from_numpy(rng.standard_normal((4, 89, 768)).astype(np.float32)) for _ in range(4))
    args = (12, 1.0, rate, torch.float32, 77)
    exact = _attention_f64(q, k, v, g, 12, 1.0, rate, 77)
    plain = _errors_vs_f64((port_attn.mha_dense_bth(q, k, v, *args), *port_attn.mha_bwd_plain(q, k, v, g, *args)),
                           exact)
    split = _errors_vs_f64(_attention_with(_mm3, q, k, v, g, 12, 1.0, rate, 77), exact)
    assert all(s <= 2.0 * p for s, p in zip(split, plain)), (split, plain)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_conv_glu_matches_jax_pallas_interpret(cd):
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops.pallas_conv_glu import glu_dwconv as jax_glu_dwconv

    rng = np.random.default_rng(2)
    y = rng.standard_normal((B, T, 2 * C)).astype(np.float32)
    w = rng.uniform(-0.3, 0.3, (KS, C)).astype(np.float32)
    ref = np.asarray(jax_glu_dwconv(jnp.asarray(y), jnp.asarray(w), jnp.dtype(cd)))
    got = port_conv.glu_dwconv(torch.from_numpy(y), torch.from_numpy(w), getattr(torch, cd)).numpy()
    # bf16: the output is rounded through bf16 in both; one bf16 ulp of |z| <= 4
    np.testing.assert_allclose(got, ref, atol=1e-5 if cd == "float32" else 2.0**-6, rtol=0)


@pytest.mark.parametrize("t", [1, 89, 400, 700])
def test_conv_glu_bwd_wrapper_takes_any_sequence_length(t):
    """The backward kernel takes time in chunks, so its wrapper has no
    length rule: up to T = 700 it gets past every shape check and refuses
    only operands off the card."""
    y = torch.empty((2, t, 2048), device="meta")
    dz = torch.empty((2, t, 1024), device="meta")
    w = torch.empty((31, 1024), device="meta")
    for cd in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA tensors"):
            port_conv._bwd_kernel(y, w, dz, cd)


def test_depthwise_same_padding_is_15_15():
    g = torch.zeros(1, 40, 1)
    g[0, 20, 0] = 1.0
    w = torch.arange(1, 32, dtype=torch.float32)[:, None]
    z = port_conv.depthwise_conv_same(g, w)[0, :, 0]
    # z[t] = w[k] where t + k - 15 == 20
    for t in range(5, 36):
        assert z[t] == w[35 - t, 0]
    assert z[:5].abs().sum() == 0 and z[36:].abs().sum() == 0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sd,cd", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.bfloat16)], ids=["f32", "f32_bf16cd", "bf16"])
def test_cuda_attention_kernel_matches_plain(sd, cd):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((4, 89, 1024), generator=g, device=dev).to(sd) for _ in range(3))
    out = port_attn.mha_fused_bth(q, k, v, 16, 0.125, 0.0, cd)
    ref = port_attn.mha_dense_bth(q, k, v, 16, 0.125, 0.0, cd)
    atol = 2e-5 if cd == torch.float32 else 2.0**-6 * max(1.0, ref.float().abs().max().item())
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [400, 700])
@pytest.mark.parametrize("sd,cd", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.bfloat16)], ids=["f32", "f32_bf16cd", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
def test_cuda_attention_kernel_long_sequences_match_plain(t, sd, cd, rate):
    """The forward at T' 400 and 700, 16 heads of 64, key tiles streamed: at
    f32 compute the split-TF32 tensor-core kernel, at bf16 compute the bf16
    one."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(t)
    q, k, v = (torch.randn((2, t, 1024), generator=g, device=dev).to(sd) for _ in range(3))
    out = port_attn._fwd_kernel(q, k, v, 16, 0.125, rate, cd, 5)
    ref = port_attn.mha_dense_bth(q, k, v, 16, 0.125, rate, cd, 5)
    atol = 2e-5 if cd == torch.float32 else 2.0**-6 * max(1.0, ref.float().abs().max().item())
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


def _bf16_tol(ref):
    """chip_smoke's bf16 tolerance: two bf16 ulps of the largest output."""
    return 2.0**-6 * max(1.0, ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [89, 169, 400, 700])
@pytest.mark.parametrize("sd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
@pytest.mark.parametrize("d", [64, 80, 100])
def test_cuda_attention_mma_fwd_matches_plain(t, sd, rate, d):
    """The tensor-core forward (bf16 compute) against mha_dense_bth, B 2:
    T' 89 and 169 with the key tiles resident (at D 64), 400 and 700
    streamed; head dims 64 (16 heads), 80 (padded to 128 columns) and 100
    (not a multiple of 8: scalar loads and stores), 8 heads."""
    dev = _cuda()
    heads = 16 if d == 64 else 8
    g = torch.Generator(device=dev).manual_seed(t + d)
    q, k, v = (torch.randn((2, t, heads * d), generator=g, device=dev).to(sd) for _ in range(3))
    assert port_attn._fwd_route(t, d, torch.bfloat16) == "mma"
    out = port_attn._fwd_kernel(q, k, v, heads, d**-0.5, rate, torch.bfloat16, 9)
    ref = port_attn.mha_dense_bth(q, k, v, heads, d**-0.5, rate, torch.bfloat16, 9)
    assert out.dtype == sd
    torch.testing.assert_close(out.float(), ref.float(), atol=_bf16_tol(ref), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [89, 400])
def test_cuda_attention_mma_fwd_is_deterministic(t):
    """Two runs of the tensor-core forward on the same inputs are bitwise
    equal (no atomics; every sum in a fixed order)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((4, t, 1024), generator=g, device=dev) for _ in range(3))
    runs = [port_attn._fwd_kernel(q, k, v, 16, 0.125, 0.1, torch.bfloat16, 21) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 17, 89, 169, 400, 700])
@pytest.mark.parametrize("d", [24, 64, 80, 100, 128])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
def test_cuda_attention_tf32x3_fwd_matches_plain(t, d, rate):
    """The split-TF32 forward (f32 compute, f32 stream) against
    mha_dense_bth, B 2: from one row to 700, key tiles resident (T' <= 32 at
    D <= 64) and streamed; head dims padded to 64 (24, 64) or 128 (80, 100,
    128), 100 off the 16-byte grid (scalar loads and stores); 16 heads at D
    64, else 4. The f32 tolerance, 2e-5 abs."""
    dev = _cuda()
    heads = 16 if d == 64 else 4
    g = torch.Generator(device=dev).manual_seed(10 * t + d)
    q, k, v = (torch.randn((2, t, heads * d), generator=g, device=dev) for _ in range(3))
    assert port_attn._fwd_route(t, d, torch.float32) == "tf32x3"
    out = port_attn._fwd_kernel(q, k, v, heads, d**-0.5, rate, torch.float32, 13)
    ref = port_attn.mha_dense_bth(q, k, v, heads, d**-0.5, rate, torch.float32, 13)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [89, 400])
def test_cuda_attention_tf32x3_fwd_takes_a_bf16_stream(t):
    """f32 compute on a bf16 stream: the tiles widen bf16 exactly; the output
    is rounded to bf16 on both sides, so two bf16 ulps of the largest one."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(t)
    q, k, v = (torch.randn((2, t, 1024), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    out = port_attn._fwd_kernel(q, k, v, 16, 0.125, 0.1, torch.float32, 4)
    ref = port_attn.mha_dense_bth(q, k, v, 16, 0.125, 0.1, torch.float32, 4)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=_bf16_tol(ref), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [89, 400])
def test_cuda_attention_tf32x3_fwd_is_deterministic(t):
    """Two runs of the split-TF32 forward on the same inputs are bitwise equal."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn((4, t, 1024), generator=g, device=dev) for _ in range(3))
    runs = [port_attn._fwd_kernel(q, k, v, 16, 0.125, 0.1, torch.float32, 21) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
def test_cuda_attention_tf32x3_at_large_logits_is_f32_class(rate):
    """The split-TF32 forward and backward at the w2v shape (B 64, 12 heads
    of 64, T' 89) with logits 8x the other tests' (scale 1, q not
    pre-scaled): each output within twice the plain f32 version's own error
    of the f64 result (chip_smoke's F32_CLASS_FACTOR). Against the plain
    version these inputs can exceed the 2e-5 abs that holds at unit-scale
    logits: both sides carry f32 rounding of s amplified by the softmax."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(88)
    q, k, v, ga = (torch.randn((64, 89, 768), generator=g, device=dev) for _ in range(4))
    args = (12, 1.0, rate, torch.float32, 77)
    exact = _attention_f64(q, k, v, ga, 12, 1.0, rate, 77)
    got = _errors_vs_f64((port_attn._fwd_kernel(q, k, v, *args), *port_attn._bwd_kernel(q, k, v, ga, *args)), exact)
    plain = _errors_vs_f64((port_attn.mha_dense_bth(q, k, v, *args), *port_attn.mha_bwd_plain(q, k, v, ga, *args)),
                           exact)
    assert all(e <= 2.0 * p for e, p in zip(got, plain)), (got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
def test_cuda_attention_simt_fwd_takes_wide_heads(rate):
    """A head of 192 at f32 compute, T' 89: the SIMT kernel that holds K and V
    in shared memory, within 2e-5 of mha_dense_bth."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(192)
    q, k, v = (torch.randn((2, 89, 2 * 192), generator=g, device=dev) for _ in range(3))
    assert port_attn._fwd_route(89, 192, torch.float32) == "resident"
    out = port_attn._fwd_kernel(q, k, v, 2, 192**-0.5, rate, torch.float32, 6)
    ref = port_attn.mha_dense_bth(q, k, v, 2, 192**-0.5, rate, torch.float32, 6)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("sd,cd", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.bfloat16)], ids=["f32", "f32_bf16cd", "bf16"])
def test_cuda_conv_glu_kernel_matches_plain(sd, cd):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn((4, 89, 2048), generator=g, device=dev).to(sd)
    w = torch.rand((31, 1024), generator=g, device=dev) * 0.6 - 0.3
    out = port_conv.glu_dwconv(y, w, cd)
    ref = port_conv.glu_dwconv_plain(y, w, cd)
    atol = 1e-5 if sd == cd == torch.float32 else 2.0**-6 * max(1.0, ref.float().abs().max().item())
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
