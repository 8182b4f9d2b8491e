"""Stacked biGRU: the port against the JAX package's Pallas recurrence
(interpret mode on CPU) and its lax.scan path, with and without the
learnable h0; the unidirectional path; and the CUDA kernel against the plain
recurrence on a card.

Tolerance at f32: atol 2e-5 — outputs are GRU states in (-1, 1); the
recurrent and input products sum in another order in each framework and
the difference is carried through 17 steps."""

import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu_torch.models.gru import apply_gru, bigru_inputs, init_gru_params
from wav2vec2forbrain_tpu_torch.ops import gru as port_gru
from wav2vec2forbrain_tpu_torch.ops import kernels
from wav2vec2forbrain_tpu_torch.ops import select as port_select

torch.set_num_threads(1)
ATOL = 2e-5
B, T, IN, H, LAYERS = 3, 17, 40, 128, 2


def _params(seed, bidirectional=True, learnable=False):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    nd = 2 if bidirectional else 1
    layers = []
    for layer in range(LAYERS):
        lin = IN if layer == 0 else H * nd
        dirs = []
        for _ in range(nd):
            dirs.append({
                "w_ih": rng.uniform(-bound, bound, (lin, 3 * H)).astype(np.float32),
                "w_hh": rng.uniform(-bound, bound, (H, 3 * H)).astype(np.float32),
                "b_ih": rng.uniform(-bound, bound, (3 * H,)).astype(np.float32),
                "b_hh": rng.uniform(-bound, bound, (3 * H,)).astype(np.float32),
            })
        layers.append({"directions": dirs})
    params = {"layers": layers}
    if learnable:
        params["hidden_start"] = rng.standard_normal((LAYERS * nd, H)).astype(np.float32)
    x = rng.uniform(-1, 1, (B, T, IN)).astype(np.float32)
    return params, x


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree)


def _port(params, x, bidirectional, learnable, cd=None, policy="auto"):
    tp = _to_torch(params)
    port_select.set_kernel_policy(policy)
    try:
        with torch.inference_mode():
            out = apply_gru(tp, torch.from_numpy(x), H, LAYERS, bidirectional, learnable,
                            compute_dtype=cd)
    finally:
        port_select.set_kernel_policy("auto")
    return out.float().numpy()


def _jax(params, x, bidirectional, learnable, use_pallas, cd=None):
    """The JAX package's apply_gru (imported here, so that the `cuda` tests
    also run where jax is not installed); cd is a dtype name."""
    import jax
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.models.gru import apply_gru as jax_apply_gru
    from wav2vec2forbrain_tpu.ops import select as jax_select

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    cd = None if cd is None else jnp.dtype(cd)
    jax_select.set_kernel_policy("all")
    try:
        out = jax_apply_gru(jp, jnp.asarray(x), H, LAYERS, bidirectional,
                            use_learnable_initial_state=learnable, compute_dtype=cd,
                            use_pallas=use_pallas)
    finally:
        jax_select.set_kernel_policy("auto")
    return np.asarray(out)


@pytest.mark.parametrize("learnable", [False, True], ids=["zero_h0", "learnable_h0"])
@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas_interpret", "scan"])
def test_bigru_matches_jax(learnable, use_pallas):
    params, x = _params(0, True, learnable)
    ref = _jax(params, x, True, learnable, use_pallas)
    got = _port(params, x, True, learnable)
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_unidirectional_matches_jax():
    params, x = _params(1, bidirectional=False, learnable=True)
    ref = _jax(params, x, False, True, use_pallas=False)
    got = _port(params, x, False, True)
    assert got.shape == (B, T, H)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_bf16_compute_matches_jax_loosely():
    """bf16 compute: h and W_hh rounded to bf16 before the product in both
    frameworks; the f32 sums may round a state to the other side of a bf16
    boundary, which the next steps carry on: atol 5e-3."""
    params, x = _params(2)
    ref = _jax(params, x, True, False, use_pallas=True, cd="bfloat16")
    got = _port(params, x, True, False, cd=torch.bfloat16)
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)


def test_policy_none_runs_the_same_plain_math():
    params, x = _params(3)
    np.testing.assert_array_equal(
        _port(params, x, True, False, policy="gru"),
        _port(params, x, True, False, policy="none"),
    )


def test_wrapper_checks_hidden_size_on_cuda_only():
    """On CPU tensors the wrapper runs the plain version for any H."""
    gi = torch.zeros(2, 2, 1, 3 * 20)
    ys = port_gru.gru_recurrence(gi, torch.zeros(2, 20, 60), torch.zeros(2, 1, 60), torch.zeros(2, 1, 20))
    assert ys.shape == (2, 2, 1, 20) and torch.all(ys == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [256, 512, 1024])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain(hidden, cd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_gru_params(g, 512, hidden, 1, True, True, False, dev)
    x = torch.rand((8, 89, 512), generator=g, device=dev) * 2 - 1
    gi, w_hh, b_hh = bigru_inputs(params["layers"][0]["directions"], x, cd)
    h0 = torch.zeros((2, 8, hidden), device=dev)
    out = port_gru.gru_recurrence(gi, w_hh, b_hh, h0, cd)
    ref = port_gru.gru_recurrence_plain(gi, w_hh, b_hh, h0, cd)
    atol = 2e-5 if cd == torch.float32 else 2.0**-6
    torch.testing.assert_close(out, ref, atol=atol, rtol=0)


def _cuda_fwd_inputs(seed, t, b, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    gi = torch.randn((t, 2, b, 3 * h), generator=gen, device=dev)
    w = (torch.rand((2, h, 3 * h), generator=gen, device=dev) * 2 - 1) / h**0.5
    bias = (torch.rand((2, 1, 3 * h), generator=gen, device=dev) * 2 - 1) / h**0.5
    h0 = torch.randn((2, b, h), generator=gen, device=dev) * 0.5
    return gi, w, bias, h0


@pytest.mark.cuda
@pytest.mark.parametrize("h", [32, 64, 128, 256, 320, 480])
@pytest.mark.parametrize("b", [1, 3, 17, 32, 64])
@pytest.mark.parametrize("t", [1, 89])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_gru_fused_fwd_matches_plain(h, b, t, cd):
    """The fused forward at every width the model routes to it, through the
    kernel its route names (the cluster kernel; the step kernel for f32 H
    480), at batches that fill one, part of one, and several 16-row groups."""
    gi, w, bias, h0 = _cuda_fwd_inputs(0, t, b, h)
    name = "gru" if port_gru._fwd_route(h, cd) == "cluster" else "gru_dir"
    before = kernels.LAUNCHES[name]
    out = port_gru._fwd_kernel(gi, w, bias, h0, cd)
    assert kernels.LAUNCHES[name] == before + 1
    ref = port_gru.gru_recurrence_plain(gi, w, bias, h0, cd)
    atol = 2e-5 if cd == torch.float32 else 2.0**-6
    torch.testing.assert_close(out, ref, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_gru_fused_fwd_is_deterministic(cd):
    """No atomics: two runs of the cluster forward on the same inputs give
    bitwise-equal ys (the conformer's H256 B32 T89)."""
    gi, w, bias, h0 = _cuda_fwd_inputs(1, 89, 32, 256)
    first = port_gru._fwd_kernel(gi, w, bias, h0, cd)
    second = port_gru._fwd_kernel(gi, w, bias, h0, cd)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_gru_fused_fwd_agrees_with_dir_fwd_at_f32():
    """At f32 compute the cluster forward and the per-direction step forward
    compute the same function, at H = 256, a width both take."""
    gi, w, bias, h0 = _cuda_fwd_inputs(2, 89, 32, 256)
    fused = port_gru._fwd_kernel(gi, w, bias, h0, torch.float32)
    per_dir = port_gru._fwd_kernel(gi, w, bias, h0, torch.float32, per_direction=True)
    torch.testing.assert_close(fused, per_dir, atol=2e-5, rtol=0)
