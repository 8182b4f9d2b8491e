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
    """T' = 400 (past the 393 that the forward kernel holding a head's K and
    V in shared memory takes at D = 64): the port's dense version, which
    the streaming kernel is held to on the card, against the JAX dense
    path, B = 1, 2 heads of 64, f32, the same dropout hash. Tolerance 2e-5:
    64-term dots and a 400-term softmax sum in another order."""
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops.xla_attention import mha_dense_bth as jax_mha_dense

    rng = np.random.default_rng(400)
    q, k, v = (rng.standard_normal((1, 400, 128)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax_mha_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(11, jnp.int32),
                                   2, 0.125, rate, jnp.float32))
    got = port_attn.mha_dense_bth(*(torch.from_numpy(a) for a in (q, k, v)), 2, 0.125, rate, torch.float32, 11)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("t,streams", [(1, False), (89, False), (169, False), (393, False), (394, True),
                                       (400, True), (700, True)])
def test_attention_fwd_wrapper_takes_any_sequence_length(t, streams):
    """The forward wrapper chooses its kernel by compute dtype and shape: at
    bf16 compute the tensor-core kernel at every T (head dims 64 and 80
    alike), at f32 compute the SIMT one holding K and V in shared memory up
    to T = 393 at D = 64 and the streaming one beyond. It refuses only
    operands that are not on a card, never a length."""
    assert port_attn._fwd_streams(t, 64) is streams
    for d in (64, 80):
        assert port_attn._fwd_route(t, d, torch.bfloat16) == "mma"
    assert port_attn._fwd_route(t, 64, torch.float32) == ("stream" if streams else "resident")
    q = torch.zeros((1, t, 128))
    for cd in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="CUDA tensors"):
            port_attn._fwd_kernel(q, q, q, 2, 0.125, 0.1, cd, 0)


def test_attention_fwd_wrapper_refuses_heads_its_kernels_do_not_take():
    """Heads wider than 128: the tensor-core kernel (bf16 compute) refuses
    them at every T, the f32 kernels only where they stream (the resident
    SIMT kernel takes any D whose K and V fit)."""
    q = torch.zeros((1, 89, 2 * 192))
    with pytest.raises(ValueError, match="head dim 192"):
        port_attn._fwd_kernel(q, q, q, 2, 0.125, 0.0, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_attn._fwd_kernel(q, q, q, 2, 0.125, 0.0, torch.float32, 0)
    q = torch.zeros((1, 400, 2 * 192))
    with pytest.raises(ValueError, match="head dim 192"):
        port_attn._fwd_kernel(q, q, q, 2, 0.125, 0.0, torch.float32, 0)


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
    """The forward past T' = 393, 16 heads of 64: at f32 compute the
    streaming SIMT kernel, at bf16 compute the tensor-core one."""
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
