"""The port's audio front end (models/audio_frontend.py) against the JAX
package's, on the CPU, and the audio stream at `auto` against `none` on a
card.

- The feature encoder and the whole front end (encoder + projection) of
  both packages on the same bridged params (a JAX init, the norms' scales
  and biases moved off 1 / 0), for both norm variants with and without a
  conv bias: within 1e-5 absolute (f32, outputs O(1)).
- feature_encoder_from_torch of a tiny transformers Wav2Vec2Model's state
  dict is bitwise the JAX converter's tree, and the port's front end on it
  is the HF modules' output within 2e-5 (the JAX golden test's bound).
- The port's init has the JAX init's shapes and bounds.
- `cuda`: a small embed_audio_representations (a tiny wav2vec2 encoder)
  under `auto` equals `none` within 1e-3 of the largest |x| (PERF.md §2's
  f32 rule), the attention and LayerNorm kernels launched.

jax and transformers are imported inside the CPU tests, so that the
`cuda` test runs where neither is installed.
"""

import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu_torch import bridge
from wav2vec2forbrain_tpu_torch.models import audio_frontend as port_fe
from wav2vec2forbrain_tpu_torch.tree import tree_leaves_with_path
from torch_jax_prng import jax_threefry  # noqa: F401

torch.set_num_threads(2)
TOL = 1e-5
VARIANTS = [("group", False), ("group", True), ("layer", False), ("layer", True)]


def _cfgs(norm, conv_bias):
    from wav2vec2forbrain_tpu.models.audio_frontend import FeatureEncoderConfig as JaxCfg

    fields = dict(conv_dim=(16, 24, 24), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 2), conv_bias=conv_bias,
                  feat_extract_norm=norm, hidden_size=32)
    return JaxCfg(**fields), port_fe.FeatureEncoderConfig(**fields)


def _jax_params(cfg, seed):
    """A JAX init with every norm's scale and bias moved off 1 / 0, as numpy."""
    import jax

    from wav2vec2forbrain_tpu.models.audio_frontend import init_feature_encoder_params

    tree = jax.tree_util.tree_map(np.asarray, init_feature_encoder_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias"}:
                return {k: (v + 0.2 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in node.items()}
            return {k: perturb(v) for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v) for v in node]
        return np.array(node, copy=True)

    return perturb(tree)


@pytest.mark.parametrize("norm,conv_bias", VARIANTS)
def test_frontend_matches_jax(norm, conv_bias):
    from wav2vec2forbrain_tpu.models import audio_frontend as jax_fe

    jcfg, pcfg = _cfgs(norm, conv_bias)
    tree = _jax_params(jcfg, seed=len(norm) + conv_bias)
    params = bridge.frontend_from_jax(tree, device="cpu")
    # two lengths: the longer row's zero-padded tail enters the statistics of the shorter
    audio = np.random.default_rng(3).standard_normal((3, 700)).astype(np.float32)
    audio[1, 500:] = 0.0
    feats = port_fe.apply_feature_encoder(params, torch.from_numpy(audio), pcfg).numpy()
    hidden = port_fe.apply_audio_frontend(params, torch.from_numpy(audio), pcfg).numpy()
    ref_feats = np.asarray(jax_fe.apply_feature_encoder(tree, audio, jcfg))
    ref_hidden = np.asarray(jax_fe.apply_audio_frontend(tree, audio, jcfg))
    assert feats.shape == ref_feats.shape == (3, 34, 24)
    assert hidden.shape == ref_hidden.shape == (3, 34, 32)
    np.testing.assert_allclose(feats, ref_feats, rtol=0, atol=TOL)
    np.testing.assert_allclose(hidden, ref_hidden, rtol=0, atol=TOL)
    # the bridge carries the tree back bit for bit
    back = bridge.frontend_to_jax(params)
    for (path, a), (_, b) in zip(tree_leaves_with_path(back), tree_leaves_with_path(tree)):
        assert np.array_equal(a, b), path


def _hf_model(norm, conv_bias):
    from transformers import Wav2Vec2Config, Wav2Vec2Model

    cfg = Wav2Vec2Config(conv_dim=[32, 32, 32], conv_stride=[5, 2, 2], conv_kernel=[10, 3, 3], conv_bias=conv_bias,
                         feat_extract_norm=norm, hidden_size=48, num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=32, num_conv_pos_embeddings=4, num_conv_pos_embedding_groups=2,
                         do_stable_layer_norm=norm == "layer")
    torch.manual_seed(0)
    model = Wav2Vec2Model(cfg).eval()
    with torch.no_grad():  # norms off their 1 / 0 init
        for name, p in model.named_parameters():
            if "feature" in name and "layer_norm" in name:
                p.add_(0.2 * torch.randn(p.shape))
    return cfg, model


@pytest.mark.parametrize("norm,conv_bias", [("group", False), ("layer", True)])
def test_converter_matches_jax_and_hf(norm, conv_bias):
    from wav2vec2forbrain_tpu.models.audio_frontend import feature_encoder_from_torch as jax_convert

    hf_cfg, model = _hf_model(norm, conv_bias)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tree = port_fe.feature_encoder_from_torch(sd, n_layers=3, conv_bias=conv_bias, norm=norm)
    ref = jax_convert(sd, n_layers=3, conv_bias=conv_bias, norm=norm)
    got, want = tree_leaves_with_path(tree), tree_leaves_with_path(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == torch.float32 and a.is_contiguous(), path
        assert np.array_equal(a.numpy(), np.asarray(b)), path
    # a prefixed whole-model state dict (the form read from a checkpoint file) gives the same tree
    prefixed = {f"wav2vec2.{k}": v for k, v in model.state_dict().items()}
    again = port_fe.feature_encoder_from_torch(prefixed, "wav2vec2.feature_extractor", "wav2vec2.feature_projection",
                                               3, conv_bias, norm)
    for (path, a), (_, b) in zip(tree_leaves_with_path(again), got):
        assert torch.equal(a, b), path

    cfg = port_fe.FeatureEncoderConfig(conv_dim=(32, 32, 32), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 3),
                                       conv_bias=conv_bias, feat_extract_norm=norm, hidden_size=48)
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 800)).astype(np.float32))
    with torch.no_grad():
        feats_hf = model.feature_extractor(audio).transpose(1, 2)
        hidden_hf, _ = model.feature_projection(feats_hf)
    torch.testing.assert_close(port_fe.apply_feature_encoder(tree, audio, cfg), feats_hf, atol=2e-5, rtol=0)
    torch.testing.assert_close(port_fe.apply_audio_frontend(tree, audio, cfg), hidden_hf, atol=2e-5, rtol=0)


@pytest.mark.parametrize("norm,conv_bias", VARIANTS)
def test_init_matches_the_jax_init(norm, conv_bias):
    jcfg, pcfg = _cfgs(norm, conv_bias)
    ref = tree_leaves_with_path(_jax_params(jcfg, 0))
    got = tree_leaves_with_path(port_fe.init_feature_encoder_params(torch.Generator().manual_seed(0), pcfg, "cpu"))
    assert sorted((p, tuple(a.shape)) for p, a in got) == sorted((p, a.shape) for p, a in ref)  # jax sorts keys
    in_dim = 1
    for i, (dim, k) in enumerate(zip(pcfg.conv_dim, pcfg.conv_kernel)):
        kernel = dict(got)[f"/conv_layers/{i}/conv/kernel"]
        assert kernel.abs().max() <= (3.0 / (in_dim * k)) ** 0.5
        assert kernel.std() > 0.3 * (1.0 / (in_dim * k)) ** 0.5
        in_dim = dim
    norms = [a for p, a in got if p.endswith("norm/scale")]
    assert norms and all(torch.equal(a, torch.ones_like(a)) for a in norms)


@pytest.mark.cuda
def test_cuda_audio_representations_auto_matches_none():
    """A tiny wav2vec2 encoder on the card: the audio stream through the
    attention and LayerNorm kernels (`auto`) against their plain versions
    (`none`), post hidden states within 1e-3 of their largest |x|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from wav2vec2forbrain_tpu_torch.analysis.latent_analysis import embed_audio_representations
    from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig, init_w2v_encoder_params
    from wav2vec2forbrain_tpu_torch.ops import kernels, select

    g = torch.Generator(device="cuda").manual_seed(0)
    enc_cfg = Wav2Vec2EncoderConfig.tiny_test()
    encoder = init_w2v_encoder_params(g, enc_cfg, "cuda")
    fe_cfg = port_fe.FeatureEncoderConfig(hidden_size=enc_cfg.hidden_size)
    frontend = port_fe.init_feature_encoder_params(g, fe_cfg, "cuda")
    audio = [np.random.default_rng(0).standard_normal((3, 32000)).astype(np.float32)]
    out = {}
    try:
        for policy in ("auto", "none"):
            select.set_kernel_policy(policy)
            kernels.reset_launches()
            out[policy] = embed_audio_representations(audio, frontend, fe_cfg, encoder, enc_cfg, device="cuda")
            launched = {k for k, v in kernels.LAUNCHES.items() if v > 0}
            assert launched == ({"attention", "layernorm"} if policy == "auto" else set()), launched
    finally:
        select.set_kernel_policy("auto")
    assert out["auto"]["post"].shape == (3 * 99, enc_cfg.hidden_size)
    np.testing.assert_allclose(out["auto"]["pre"], out["none"]["pre"], rtol=0, atol=1e-5)  # no kernel in the front end
    bound = 1e-3 * np.abs(out["none"]["post"]).max()
    assert np.abs(out["auto"]["post"] - out["none"]["post"]).max() <= bound
