"""The GRU recurrence at per-direction widths: the port's ops/gru.py
entries against the JAX package's ops/pallas_gru.py::gru_recurrence_dir
(the per-direction Pallas kernels `_fwd_impl_dir` / `_bwd_impl_dir` in
interpret mode on the CPU, dW_hh by the einsum outside), forward and
jax.vjp, at H = 128 (the smallest width the JAX kernel takes); the port's
f32 dW_hh / db_hh product against that einsum on the same dgh and hprev;
the model's routing of each width to the entry whose kernels take it; the
wrappers' refusals; and the CUDA kernels against their plain versions at
H = 512, 1024 and a ragged 600, B = 64, T = 89 on a card.

Tolerances: f32 2e-5 (GRU states in (-1, 1); sums in another order carried
through the steps; the gradients scaled by max(1, |ref|)). bf16 compute:
two bf16 ulps of the largest output (both sides round the same values to
bf16, f32 sums in another order can cross a rounding boundary)."""

import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu_torch.models import gru as port_model_gru
from wav2vec2forbrain_tpu_torch.ops import gru as port_gru
from wav2vec2forbrain_tpu_torch.ops import kernels

torch.set_num_threads(1)
H, T, B = 128, 8, 3
BF16_ULPS = 2.0**-6


def _inputs(seed, h=H, t=T, b=B):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(h)
    return (
        rng.standard_normal((t, 2, b, 3 * h)).astype(np.float32),
        rng.uniform(-bound, bound, (2, h, 3 * h)).astype(np.float32),
        rng.uniform(-bound, bound, (2, 1, 3 * h)).astype(np.float32),
        (0.5 * rng.standard_normal((2, b, h))).astype(np.float32),
        rng.standard_normal((t, 2, b, h)).astype(np.float32),
    )


def _jax_dir(gi, w, b, h0, g, cd):
    import jax
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops.pallas_gru import gru_recurrence_dir as jax_gru_dir

    ys, vjp = jax.vjp(lambda *a: jax_gru_dir(*a, jnp.dtype(cd)), *(jnp.asarray(a) for a in (gi, w, b, h0)))
    return [np.asarray(ys)] + [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _port(fn, gi, w, b, h0, g, cd):
    args = [torch.from_numpy(a).requires_grad_(True) for a in (gi, w, b, h0)]
    ys = fn(*args, getattr(torch, cd))
    ys.backward(torch.from_numpy(g))
    return [ys.detach().numpy()] + [a.grad.numpy() for a in args]


def _tol(ref, f32_tol, cd):
    return (f32_tol if cd == "float32" else BF16_ULPS) * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("entry", ["gru_recurrence_dir", "gru_recurrence"])
def test_port_entries_match_jax_gru_recurrence_dir_f32(entry):
    """At f32 compute the per-direction function and the fused one are the
    same; both port entries are held to the JAX per-direction kernels."""
    args = _inputs(0)
    ref = _jax_dir(*args, "float32")
    got = _port(getattr(port_gru, entry), *args, "float32")
    for name, a, r in zip(("ys", "dgi", "dw_hh", "db_hh", "dh0"), got, ref):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a, r, atol=_tol(r, 2e-5, "float32"), rtol=0, err_msg=name)


def test_port_dir_matches_jax_dir_at_bf16_compute():
    args = _inputs(1)
    ref = _jax_dir(*args, "bfloat16")
    got = _port(port_gru.gru_recurrence_dir, *args, "bfloat16")
    for name, a, r in zip(("ys", "dgi", "dw_hh", "db_hh", "dh0"), got, ref):
        np.testing.assert_allclose(a, r, atol=_tol(r, 0.0, "bfloat16"), rtol=0, err_msg=name)


def test_dir_dw_takes_its_product_in_f32():
    """The per-direction dW_hh is hprev^T dgh in f32 (the JAX einsum outside
    _bwd_impl_dir); the fused entry rounds both to the compute dtype (the
    JAX _mm). At bf16 they differ by bf16 rounding, and the dir one equals
    the f32 product of the same dgh."""
    gi, w, b, h0, g = (torch.from_numpy(a) for a in _inputs(2))
    ys = port_gru.gru_recurrence_plain(gi, w, b, h0, torch.bfloat16)
    fused = port_gru.gru_recurrence_bwd_plain(gi, w, b, h0, ys, g, torch.bfloat16)
    per_dir = port_gru.gru_recurrence_bwd_plain(gi, w, b, h0, ys, g, torch.bfloat16, per_direction=True)
    for a, c in zip(fused[:1] + fused[2:], per_dir[:1] + per_dir[2:]):
        assert torch.equal(a, c)  # dgi, db_hh, dh0 do not depend on the dW product
    assert not torch.equal(fused[1], per_dir[1])
    torch.testing.assert_close(per_dir[1], fused[1], atol=BF16_ULPS * fused[1].abs().max().item(), rtol=0)


def test_dir_dw_db_matches_jax_vjp_bwd_dir_einsum(monkeypatch):
    """gru_dir_dw_db against the dW_hh / db_hh that the JAX _vjp_bwd_dir
    forms outside its kernel, fed the same dgi, r (so the same dgh) and ys."""
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops import pallas_gru

    gi, w, b, h0, ys = _inputs(4)
    rng = np.random.default_rng(5)
    dgi = rng.standard_normal(gi.shape).astype(np.float32)
    r = rng.uniform(0.0, 1.0, ys.shape).astype(np.float32)
    monkeypatch.setattr(pallas_gru, "_bwd_partitioned_dir", lambda cd: lambda *a: (dgi, r, h0))
    _, dw_ref, db_ref, _ = pallas_gru._vjp_bwd_dir(
        jnp.float32, tuple(jnp.asarray(a) for a in (gi, w, b, h0, ys)), jnp.asarray(ys))
    dgh = np.concatenate([dgi[..., : 2 * H], dgi[..., 2 * H:] * r], axis=-1)
    dw, db = port_gru.gru_dir_dw_db(torch.from_numpy(h0), torch.from_numpy(ys), torch.from_numpy(dgh))
    for name, a, ref in (("dw_hh", dw.numpy(), np.asarray(dw_ref)), ("db_hh", db.numpy(), np.asarray(db_ref))):
        assert a.shape == ref.shape, name
        np.testing.assert_allclose(a, ref, atol=_tol(ref, 2e-5, "float32"), rtol=0, err_msg=name)


@pytest.mark.parametrize("hidden,expect", [(128, "gru_recurrence"), (512, "gru_recurrence_dir"),
                                           (100, "gru_recurrence_plain"), (1000, "gru_recurrence_dir")])
def test_bigru_layer_routes_wide_layers_per_direction(monkeypatch, hidden, expect):
    seen = []
    for name in ("gru_recurrence", "gru_recurrence_dir", "gru_recurrence_plain"):
        fn = getattr(port_model_gru, name)
        monkeypatch.setattr(port_model_gru, name, lambda *a, _n=name, _f=fn: seen.append(_n) or _f(*a))
    params = port_model_gru.init_gru_params(torch.Generator().manual_seed(0), 8, hidden, 1)
    out = port_model_gru.bigru_layer(params["layers"][0]["directions"], torch.zeros(1, 2, 8),
                                     torch.zeros(2, 1, hidden), torch.float32, use_kernel=True)
    assert out.shape == (1, 2, 2 * hidden) and seen == [expect]


@pytest.mark.parametrize("hidden,use_kernel,expect", [
    (64, True, "gru_recurrence"), (480, True, "gru_recurrence"), (500, True, "gru_recurrence_plain"),
    (600, True, "gru_recurrence_dir"), (3584, True, "gru_recurrence_dir"), (3600, True, "gru_recurrence_plain"),
    (1024, False, "gru_recurrence_plain")])
def test_recurrence_for_takes_kernels_only_where_they_go(hidden, use_kernel, expect):
    assert port_model_gru.recurrence_for(hidden, use_kernel) is getattr(port_gru, expect)


def _meta(t, b, h):
    """Operands of the given shape that take no memory (the checks read shapes only)."""
    return [torch.empty(s, device="meta") for s in ((t, 2, b, 3 * h), (2, h, 3 * h), (2, 1, 3 * h), (2, b, h))]


@pytest.mark.parametrize("call,h,match", [
    (lambda a: port_gru._fwd_kernel(*a, torch.float32), 100, "multiple of 32"),
    (lambda a: port_gru._fwd_kernel(*a, torch.float32), 3616, "does not fit"),
    (lambda a: port_gru._bwd_kernel(*a, a[3][None], a[3][None], torch.float32), 2432, "does not fit"),
    (lambda a: port_gru._fwd_kernel(*a, torch.float16, per_direction=True), 512, "not supported"),
], ids=["fused_h100", "fused_fwd_h3616", "fused_bwd_h2432", "fp16"])
def test_wrappers_refuse_shapes_their_kernels_do_not_take(call, h, match):
    with pytest.raises(ValueError, match=match):
        call(_meta(2, 1, h))


@pytest.mark.parametrize("h", [100, 3600])
def test_dir_fwd_takes_any_hidden_size_but_only_cuda_tensors(h):
    """The per-direction forward has no hidden-size rule either: at a ragged
    H = 100 and at H = 3600 (past the fused kernel's 3584) it gets past
    every shape check and refuses only operands off the card."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_gru._fwd_kernel(*_meta(2, 2, h), torch.bfloat16, per_direction=True)


@pytest.mark.parametrize("h", [128, 100, 64])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dir_fwd_weight_layout_round_trips(h, cd):
    """dir_fwd_weight lays W_hh out as (D, 3 Hp, Hp), gate g's columns as
    K-contiguous rows at g Hp: undoing it returns W_hh in the compute dtype
    exactly, and every padded row and column is zero."""
    w = torch.from_numpy(_inputs(9, h=h, t=1, b=1)[1])
    hp = -(-h // 64) * 64
    wt = port_gru.dir_fwd_weight(w, cd)
    assert wt.shape == (2, 3 * hp, hp) and wt.dtype == cd and wt.is_contiguous()
    blocks = wt.reshape(2, 3, hp, hp)
    back = blocks[:, :, :h, :h].permute(0, 3, 1, 2).reshape(2, h, 3 * h)
    assert torch.equal(back, w.to(cd))
    pad = torch.ones((hp, hp), dtype=torch.bool)
    pad[:h, :h] = False
    assert not blocks[:, :, pad].any()


@pytest.mark.parametrize("h", [32, 480])
def test_fused_bwd_takes_the_routed_widths_but_only_cuda_tensors(h):
    """The fused backward takes every width models/gru.py routes to it (H
    32 .. 480, multiples of 32): at both ends it gets past every shape
    check and refuses only operands off the card."""
    a = _meta(3, 2, h)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_gru._bwd_kernel(*a, a[3][None], a[3][None], torch.bfloat16)


def test_dir_bwd_takes_any_hidden_size_but_only_cuda_tensors():
    """The per-direction backward has no hidden-size rule: at H = 100 it
    gets past every shape check and refuses only CPU operands."""
    gi, w, b, h0, g = (torch.from_numpy(a) for a in _inputs(6, h=100, t=3, b=2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_gru._bwd_kernel(gi, w, b, h0, g, g, torch.bfloat16, per_direction=True)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [512, 1024, 600])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_dir_kernels_match_plain(hidden, cd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    gi, w, b, h0, g = (torch.from_numpy(a).to(dev) for a in _inputs(3, hidden, 89, 64))
    before = dict(kernels.LAUNCHES)
    ys = port_gru._fwd_kernel(gi, w, b, h0, cd, per_direction=True)
    ref = port_gru.gru_recurrence_plain(gi, w, b, h0, cd)
    f32 = cd == torch.float32
    torch.testing.assert_close(ys, ref, atol=2e-5 if f32 else BF16_ULPS, rtol=0)
    got = port_gru._bwd_kernel(gi, w, b, h0, ref, g, cd, per_direction=True)
    want = port_gru.gru_recurrence_bwd_plain(gi, w, b, h0, ref, g, cd, per_direction=True)
    for a, r in zip(got, want):
        tol = (2e-5 if f32 else BF16_ULPS) * max(1.0, r.abs().max().item())
        torch.testing.assert_close(a.reshape(r.shape), r, atol=tol, rtol=0)
    assert kernels.LAUNCHES["gru_dir"] == before["gru_dir"] + 1
    assert kernels.LAUNCHES["gru_dir_bwd"] == before["gru_dir_bwd"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [512, 1024, 600])
@pytest.mark.parametrize("b,t", [(64, 89), (3, 89), (64, 1), (3, 1)], ids=["B64T89", "B3T89", "B64T1", "B3T1"])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_dir_fwd_matches_plain(hidden, b, t, cd):
    """The per-direction forward kernel alone, at the batch and length edges
    (B = 3: one ragged 32-row tile; T = 1: h0 is the only carry)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    gi, w, bias, h0, _ = (torch.from_numpy(a).cuda() for a in _inputs(10, hidden, t, b))
    ys = port_gru._fwd_kernel(gi, w, bias, h0, cd, per_direction=True)
    ref = port_gru.gru_recurrence_plain(gi, w, bias, h0, cd)
    torch.testing.assert_close(ys, ref, atol=2e-5 if cd == torch.float32 else BF16_ULPS, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [512, 1024, 600])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_dir_gradients_match_plain_autograd(hidden, cd):
    """Autograd through gru_recurrence_dir on the card (the forward kernel,
    then the backward kernels and the f32 dW) against the plain versions: at
    f32 the autograd of gru_recurrence_plain; at bf16 the plain twins (the
    plain loop's autograd rounds the carry's gradient after its product,
    where the JAX kernel rounds dgh before it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    arrays = [torch.from_numpy(a).cuda() for a in _inputs(11, hidden, 89, 64)]
    g = arrays.pop()
    leaves = [a.clone().requires_grad_(True) for a in arrays]
    ys = port_gru.gru_recurrence_dir(*leaves, cd)
    ys.backward(g)
    got = [ys.detach()] + [a.grad for a in leaves]
    if cd == torch.float32:
        ref_leaves = [a.clone().requires_grad_(True) for a in arrays]
        ref_ys = port_gru.gru_recurrence_plain(*ref_leaves, cd)
        ref_ys.backward(g)
        want = [ref_ys.detach()] + [a.grad for a in ref_leaves]
    else:
        ref_ys = port_gru.gru_recurrence_plain(*arrays, cd)
        dgi, dw, db, dh0 = port_gru.gru_recurrence_bwd_plain(*arrays, ref_ys, g, cd, per_direction=True)
        want = [ref_ys, dgi, dw, db.reshape(arrays[2].shape), dh0]
    for a, r in zip(got, want):
        tol = (2e-5 if cd == torch.float32 else BF16_ULPS) * max(1.0, r.abs().max().item())
        torch.testing.assert_close(a, r, atol=tol, rtol=0)


@pytest.mark.cuda
def test_cuda_dir_bwd_refuses_tf32_matmuls():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    gi, w, b, h0, g = (torch.from_numpy(a).cuda() for a in _inputs(7, 128, 4, 2))
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            port_gru._bwd_kernel(gi, w, b, h0, g, g, torch.float32, per_direction=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


@pytest.mark.cuda
def test_cuda_w2v_train_step_at_a_width_no_kernel_takes_runs_plain():
    """A tiny wav2vec2 model with a biGRU of H = 100 (valid, not a multiple
    of 32) takes a train step on the card under `auto` without raising:
    its recurrence runs the plain loop, the encoder's kernels still run."""
    from wav2vec2forbrain_tpu_torch.data.batch import to_device
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
    from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec, init_model_params, param_labels
    from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
    from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig
    from wav2vec2forbrain_tpu_torch.ops import select
    from wav2vec2forbrain_tpu_torch.train.optim import make_optimizer
    from wav2vec2forbrain_tpu_torch.train.steps import StepConfig, build_train_step

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    spec = ModelSpec(encoder_family="wav2vec2", w2v_cfg=Wav2Vec2EncoderConfig.tiny_test(), latent_size=96,
                     gru_hidden_size=100, gru_dropout=0.1, compute_dtype=torch.bfloat16)
    select.set_kernel_policy("auto")
    params, state = init_model_params(torch.Generator(device=dev).manual_seed(0), spec, dev)
    labels = param_labels(params, "brain_encoder+w2v")
    opt = make_optimizer(labels, "adam", 1e-4)
    step = build_train_step(spec, labels, opt, StepConfig(None, 0.02, 0.25))
    kernels.reset_launches()
    res = step(params, opt.init(params), state, to_device(make_requests(1, 4, 160, 0)[0], dev), StepRng(3, dev),
               1e-3, 1e-4)
    assert np.isfinite(float(res.loss))
    assert not any(kernels.LAUNCHES[k] for k in ("gru", "gru_bwd", "gru_dir", "gru_dir_bwd")), kernels.LAUNCHES
    assert kernels.LAUNCHES["attention_bwd"] > 0 and kernels.LAUNCHES["layernorm_bwd"] > 0, kernels.LAUNCHES
