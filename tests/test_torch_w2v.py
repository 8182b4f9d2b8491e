"""The Wav2Vec2 encoder of the port (models/wav2vec2.py) against the JAX
package's apply_w2v_encoder on the same bridged weights, at
`Wav2Vec2EncoderConfig.tiny_test()` (2 layers, d=96, 4 heads, FFN 128,
pos-conv 16 taps in 4 groups), B=3, T=8, f32, in both LN forms (post-LN as
base-960h, stable pre-LN as large-960h): eval mode, and train mode with the
JAX key chain's dropout seeds and LayerDrop mask replayed through a
SeedStream. The JAX side runs its Pallas kernels (LayerNorm, attention) in
interpret mode under the `all` policy. Also: the w2v params bridge round
trip, per layer and scan-stacked, and the port's init against the JAX
init's tree.

Tolerance: atol 2e-5 (LN outputs O(1); two layers of f32 sums taken in
another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu.models import assembly as jax_assembly
from wav2vec2forbrain_tpu.models import wav2vec2 as jax_w2v
from wav2vec2forbrain_tpu.ops import select as jax_select
from wav2vec2forbrain_tpu_torch import bridge
from wav2vec2forbrain_tpu_torch.models import assembly as port_assembly
from wav2vec2forbrain_tpu_torch.models import wav2vec2 as port_w2v
from wav2vec2forbrain_tpu_torch.models.seeds import W2V_LAYER_SITES, SeedStream
from wav2vec2forbrain_tpu_torch.tree import tree_map
from torch_jax_prng import jax_threefry  # noqa: F401

torch.set_num_threads(1)
INT32_MAX = np.iinfo(np.int32).max
ATOL = 2e-5


def _cfgs(stable: bool, **kw):
    return (jax_w2v.Wav2Vec2EncoderConfig.tiny_test(do_stable_layer_norm=stable, **kw),
            port_w2v.Wav2Vec2EncoderConfig.tiny_test(do_stable_layer_norm=stable, **kw))


def _enc_stream(key, cfg) -> SeedStream:
    """Replay apply_w2v_encoder's key chain: the input dropout's seed, the
    LayerDrop uniforms, then each layer's sites (W2V_LAYER_SITES) in order."""

    def draw(key):
        key, sub = jax.random.split(key)
        return key, int(jax.random.randint(sub, (), 0, INT32_MAX, dtype=jnp.int32))

    seeds, layerdrop = [], []
    if cfg.hidden_dropout > 0:
        key, s = draw(key)
        seeds.append(s)
    if cfg.layerdrop > 0:
        key, sub = jax.random.split(key)
        layerdrop.append(np.asarray(jax.random.uniform(sub, (cfg.num_hidden_layers,)) < cfg.layerdrop).tolist())
    for _ in range(cfg.num_hidden_layers):
        for site in W2V_LAYER_SITES:
            if getattr(cfg, site) > 0:
                key, s = draw(key)
                seeds.append(s)
    return SeedStream(seeds=seeds, layerdrop=layerdrop)


def _run(stable: bool, train: bool, key_seed: int = 0, **kw):
    jcfg, tcfg = _cfgs(stable, **kw)
    params = jax_w2v.init_w2v_encoder_params(jax.random.PRNGKey(1), jcfg)
    x = np.random.default_rng(2).standard_normal((3, 8, jcfg.hidden_size)).astype(np.float32)
    key = jax.random.PRNGKey(key_seed) if train else None
    jax_select.set_kernel_policy("all")
    try:
        ref = np.asarray(jax_w2v.apply_w2v_encoder(params, jnp.asarray(x), jcfg, key, train, jnp.float32,
                                                   use_pallas=True))
    finally:
        jax_select.set_kernel_policy("auto")
    tparams = tree_map(lambda a: torch.from_numpy(np.array(a)), jax.device_get(params))
    stream = _enc_stream(key, jcfg) if train else None
    got = port_w2v.apply_w2v_encoder(tparams, torch.from_numpy(x), tcfg, train, torch.float32, stream)
    return ref, got.detach().numpy(), stream


@pytest.mark.parametrize("stable", [False, True], ids=["post_ln", "stable_pre_ln"])
def test_encoder_eval_matches_jax(stable):
    ref, got, _ = _run(stable, train=False)
    assert got.shape == (3, 8, 96)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("stable", [False, True], ids=["post_ln", "stable_pre_ln"])
def test_encoder_train_matches_jax_with_replayed_seeds(stable):
    """Dropout at every site (the JAX defaults, 0.1) and LayerDrop 0.5; key
    1 drops layer 1 and keeps layer 0, so a dropped layer's seeds are
    skipped and a kept layer's are used."""
    ref, got, stream = _run(stable, train=True, key_seed=1, layerdrop=0.5)
    assert stream.layerdrop_drawn == [[False, True]]
    assert stream.n_seeds == 1 + 2 * len(W2V_LAYER_SITES)  # every seed consumed
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("preset", ["base_960h", "large_960h", "tiny_test"])
def test_config_presets_match_jax(preset):
    assert dataclasses.asdict(getattr(port_w2v.Wav2Vec2EncoderConfig, preset)()) == dataclasses.asdict(
        getattr(jax_w2v.Wav2Vec2EncoderConfig, preset)())


def _jax_tiny(scan_layers: bool):
    spec = jax_assembly.ModelSpec(gru_hidden_size=128, latent_size=96, encoder_family="wav2vec2",
                                  w2v_cfg=jax_w2v.Wav2Vec2EncoderConfig.tiny_test(), scan_layers=scan_layers)
    # drawn under JAX's own default PRNG, whatever ran before in this process (torch_jax_prng.jax_threefry)
    params, state = jax_assembly.init_model_params(jax.random.PRNGKey(0), spec)
    return jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, state)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("stacked", [False, True], ids=["per_layer", "scan_stacked"])
def test_w2v_bridge_round_trip_is_bit_exact(stacked):
    params, state = _jax_tiny(stacked)
    assert state == {"encoder": {}}
    tp, ts = bridge.params_from_jax(params, state, device="cpu")
    enc = tp["w2v"]["encoder"]
    assert len(enc["layers"]) == 2 and ts == {"encoder": {}}
    assert tuple(enc["pos_conv"]["weight_g"].shape) == (1, 1, 16)
    assert tuple(enc["pos_conv"]["weight_v"].shape) == (96, 24, 16)
    back_p, back_s = bridge.params_to_jax(tp, ts, stacked=stacked)
    fo, fb = _flat((params, state)), _flat((back_p, back_s))
    assert fo.keys() == fb.keys()
    for k in fo:
        assert fb[k].dtype == fo[k].dtype, k
        np.testing.assert_array_equal(fb[k], fo[k], err_msg=k)


def test_port_w2v_init_matches_jax_tree():
    jp, js = _jax_tiny(False)
    spec = port_assembly.ModelSpec(gru_hidden_size=128, latent_size=96, encoder_family="wav2vec2",
                                   w2v_cfg=port_w2v.Wav2Vec2EncoderConfig.tiny_test())
    assert spec.conformer_cfg is None
    tp, ts = port_assembly.init_model_params(torch.Generator().manual_seed(0), spec, "cpu")
    fj, ft = _flat((jp, js)), _flat(bridge.params_to_jax(tp, ts))
    assert fj.keys() == ft.keys()
    for k in fj:
        assert ft[k].shape == fj[k].shape and ft[k].dtype == fj[k].dtype, k
    for k in ("/0/w2v/encoder/layer_norm/scale", "/0/w2v/encoder/layers/1/final_layer_norm/bias"):
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    # weight_g is the norm of weight_v over dims (0, 1) at init, on both sides
    for f in (fj, ft):
        v = f["/0/w2v/encoder/pos_conv/weight_v"]
        np.testing.assert_allclose(f["/0/w2v/encoder/pos_conv/weight_g"],
                                   np.sqrt((v * v).sum(axis=(0, 1), keepdims=True)), rtol=1e-6)
