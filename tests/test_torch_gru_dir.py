"""The GRU recurrence at per-direction widths: the port's ops/gru.py
entries against the JAX package's ops/pallas_gru.py::gru_recurrence_dir
(the per-direction Pallas kernels `_fwd_impl_dir` / `_bwd_impl_dir` in
interpret mode on the CPU, dW_hh by the einsum outside), forward and
jax.vjp, at H = 128 (the smallest width the JAX kernel takes); the model's
routing of wide GRUs to gru_recurrence_dir; and the CUDA kernels against
their plain versions at H = 512 and 1024, B = 64, T = 89 on a card.

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


@pytest.mark.parametrize("hidden,expect", [(128, "gru_recurrence"), (512, "gru_recurrence_dir")])
def test_bigru_layer_routes_wide_layers_per_direction(monkeypatch, hidden, expect):
    seen = []
    for name in ("gru_recurrence", "gru_recurrence_dir"):
        fn = getattr(port_model_gru, name)
        monkeypatch.setattr(port_model_gru, name, lambda *a, _n=name, _f=fn: seen.append(_n) or _f(*a))
    params = port_model_gru.init_gru_params(torch.Generator().manual_seed(0), 8, hidden, 1)
    out = port_model_gru.bigru_layer(params["layers"][0]["directions"], torch.zeros(1, 2, 8),
                                     torch.zeros(2, 1, hidden), torch.float32, use_kernel=True)
    assert out.shape == (1, 2, 2 * hidden) and seen == [expect]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [512, 1024])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_dir_kernels_match_plain(hidden, cd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    gi, w, b, h0, g = (torch.from_numpy(a).to(dev) for a in _inputs(3, hidden, 89, 64))
    before = dict(kernels.LAUNCHES)
    ys = port_gru._fwd_kernel(gi, w, b, h0, cd, "gru_dir")
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
