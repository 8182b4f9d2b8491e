"""Params bridge between the JAX package and the PyTorch port: round trips
are bit-exact for the per-layer and the scan-stacked conformer layouts, and
the port's own init builds the same tree (keys, shapes, fixed values) as the
JAX init. The bridge and the step RNG put their tensors on the card unless
the caller names another device."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu.models import assembly as jax_assembly
from wav2vec2forbrain_tpu.models.conformer import ConformerEncoderConfig as JaxConformerConfig
from wav2vec2forbrain_tpu_torch.bridge import opt_state_from_jax, params_from_jax, params_to_jax
from wav2vec2forbrain_tpu_torch.models import assembly as port_assembly
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
from torch_jax_prng import jax_threefry  # noqa: F401

torch.set_num_threads(1)


def _jax_tiny(scan_layers: bool, learnable_h0: bool = False):
    spec = jax_assembly.ModelSpec(
        gru_hidden_size=128,
        latent_size=96,
        encoder_family="conformer",
        conformer_cfg=JaxConformerConfig.tiny_test(hidden_act="swish"),
        scan_layers=scan_layers,
        gru_learnable_initial_state=learnable_h0,
    )
    params, state = jax_assembly.init_model_params(jax.random.PRNGKey(0), spec)
    return jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, state)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("stacked", [False, True], ids=["per_layer", "scan_stacked"])
def test_round_trip_is_bit_exact(stacked):
    params, state = _jax_tiny(stacked, learnable_h0=True)
    tp, ts = params_from_jax(params, state, device="cpu")
    assert len(tp["w2v"]["encoder"]["layers"]) == 2
    assert isinstance(tp["brain"]["gru"]["layers"][0]["directions"][0]["w_hh"], torch.Tensor)
    back_p, back_s = params_to_jax(tp, ts, stacked=stacked)
    for orig, back in ((params, back_p), (state, back_s)):
        fo, fb = _flat(orig), _flat(back)
        assert fo.keys() == fb.keys()
        for key in fo:
            assert fb[key].dtype == fo[key].dtype, key
            np.testing.assert_array_equal(fb[key], fo[key], err_msg=key)


def test_stacked_and_per_layer_give_the_same_port_params():
    pa, sa = params_from_jax(*_jax_tiny(False), device="cpu")
    pb, sb = params_from_jax(*_jax_tiny(True), device="cpu")
    fa, fb = _flat((pa, sa)), _flat((pb, sb))
    assert fa.keys() == fb.keys()
    for key in fa:
        assert torch.equal(fa[key], fb[key]), key


def test_port_init_matches_jax_tree_and_fixed_values():
    jp, js = _jax_tiny(False)
    spec = port_assembly.ModelSpec(
        gru_hidden_size=128,
        latent_size=96,
        conformer_cfg=ConformerEncoderConfig.tiny_test(hidden_act="swish"),
    )
    tp, ts = port_assembly.init_model_params(torch.Generator().manual_seed(0), spec, "cpu")
    fj, ft = _flat((jp, js)), _flat(params_to_jax(tp, ts))
    assert fj.keys() == ft.keys()
    for key in fj:
        assert ft[key].shape == fj[key].shape, key
        assert ft[key].dtype == fj[key].dtype, key
    # deterministic parts of the init are identical, random parts share bounds
    for key in ("/0/brain/preproc/day_weights", "/0/brain/preproc/day_bias",
                "/1/encoder/layers/0/batch_norm/var"):
        np.testing.assert_array_equal(ft[key], fj[key], err_msg=key)
    bound = 1.0 / np.sqrt(8192)
    w_ih = ft["/0/brain/gru/layers/0/directions/0/w_ih"]
    assert np.abs(w_ih).max() <= 1.0 / np.sqrt(128)
    fc = ft["/0/brain/fc/layers/0/kernel"]
    assert np.abs(fc).max() <= 1.0 / np.sqrt(256) and np.abs(fc).max() > 0.5 * bound


def test_params_and_step_rng_default_to_the_card():
    """Without a device argument params_from_jax and StepRng place their
    tensors on the card; where there is none they raise rather than hand
    back CPU tensors that predict() and train_batches() would then run on."""
    params, state = _jax_tiny(False)
    if torch.cuda.is_available():
        tp, ts = params_from_jax(params, state)
        assert all(t.is_cuda for t in _flat((tp, ts)).values())
        assert StepRng(0).normal((2,), "cuda").is_cuda
        return
    with pytest.raises((AssertionError, RuntimeError)):  # torch built without CUDA, or no card
        params_from_jax(params, state)
    with pytest.raises(RuntimeError):
        StepRng(0)
    with pytest.raises(RuntimeError):
        StepRng(replay=[])
    tp, _ = params_from_jax(params, state, device="cpu")
    assert not any(t.is_cuda for t in _flat(tp).values())
    assert StepRng(0, "cpu", replay=[]).normal((2,), "cpu").device.type == "cpu"


def test_opt_state_follows_the_device_of_its_params():
    """opt_state_from_jax puts the moments beside the params it is given
    unless the caller names a device (an optax-like Adam state: count, mu,
    nu)."""
    jax_state = SimpleNamespace(count=np.asarray(2, np.int32), mu={"w": np.full(3, 0.5, np.float32)},
                                nu={"w": np.full(3, 0.25, np.float32)})
    moments = opt_state_from_jax(jax_state, {"w": torch.zeros(3)})
    assert moments.count == 2 and moments.mu["w"].device.type == "cpu"
    np.testing.assert_array_equal(moments.nu["w"].numpy(), jax_state.nu["w"])
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            opt_state_from_jax(jax_state, {"w": torch.zeros(3)}, device="cuda")
