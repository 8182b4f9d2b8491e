"""The port's state-dict converter (models/convert.py) against the JAX
package's (wav2vec2forbrain_tpu/models/convert.py): the same trees, leaf
for leaf and bit for bit, from tiny HF Wav2Vec2ForCTC (post-LN and stable)
and Wav2Vec2ConformerForCTC models, under both pos-conv spellings
(transformers' parametrizations.weight.original0/1 and the checkpoint
files' weight_g / weight_v), and from reference-layout brain_encoder.pt /
model.pt state dicts."""

import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu.models import convert as jax_convert
from wav2vec2forbrain_tpu_torch.models import convert

torch.set_num_threads(2)
N_DAYS, C, IN, H, LATENT = 24, 256, 64, 16, 24


def hf_config(family, stable=False):
    """tests/test_golden_w2v.py's and test_golden_conformer.py's tiny
    configs, with a one-layer audio front end (which the converters drop)."""
    common = dict(hidden_size=96, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
                  num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, vocab_size=32,
                  conv_dim=(8,), conv_kernel=(2,), conv_stride=(2,))
    if family == "conformer":
        from transformers import Wav2Vec2ConformerConfig

        return Wav2Vec2ConformerConfig(conv_depthwise_kernel_size=31, position_embeddings_type="rotary", **common)
    from transformers import Wav2Vec2Config

    return Wav2Vec2Config(do_stable_layer_norm=stable, **common)


def hf_model(family, stable=False, seed=0):
    from transformers import Wav2Vec2ConformerForCTC, Wav2Vec2ForCTC

    torch.manual_seed(seed)
    model = (Wav2Vec2ConformerForCTC if family == "conformer" else Wav2Vec2ForCTC)(hf_config(family, stable))
    if family == "conformer":  # BN statistics away from their init, so the state is checked
        for name, buf in model.named_buffers():
            if name.endswith("running_mean") or name.endswith("running_var"):
                buf.copy_(torch.rand_like(buf) + 0.5)
    return model.eval()


def legacy_spelling(sd):
    """The checkpoint files' pos-conv key names (weight_g / weight_v)."""
    rename = {"parametrizations.weight.original0": "weight_g", "parametrizations.weight.original1": "weight_v"}
    out = {}
    for k, v in sd.items():
        for new, old in rename.items():
            k = k.replace(new, old)
        out[k] = v
    return out


def assert_trees_equal(port, ref, where="/"):
    """The port's tensor tree equals the JAX package's numpy tree bitwise."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), (where, sorted(port), sorted(ref))
        for k in ref:
            assert_trees_equal(port[k], ref[k], f"{where}{k}/")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), where
        for i, (p, r) in enumerate(zip(port, ref)):
            assert_trees_equal(p, r, f"{where}{i}/")
    else:
        ref = np.asarray(ref)
        assert isinstance(port, torch.Tensor), where
        got = port.numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, (where, got.dtype, ref.dtype, got.shape, ref.shape)
        assert got.tobytes() == ref.tobytes(), where


def _convert_encoder(mod, sd, family):
    prefix = "wav2vec2_conformer.encoder" if family == "conformer" else "wav2vec2.encoder"
    if family == "conformer":
        enc = mod.conformer_encoder_from_torch(sd, prefix, 2)
        state = mod.conformer_batch_norm_state_from_torch(sd, prefix, 2)
    else:
        enc, state = mod.w2v_encoder_from_torch(sd, prefix, 2), {}
    return enc, mod.linear_from_torch(sd, "lm_head"), state


@pytest.mark.parametrize("family,stable", [("wav2vec2", False), ("wav2vec2", True), ("conformer", False)])
@pytest.mark.parametrize("spelling", ["parametrizations", "weight_g"])
def test_hf_encoder_trees_equal_jax(family, stable, spelling):
    sd = hf_model(family, stable).state_dict()
    assert any("parametrizations.weight.original0" in k for k in sd)
    if spelling == "weight_g":
        sd = legacy_spelling(sd)
    ref = _convert_encoder(jax_convert, jax_convert.state_dict_to_numpy(sd), family)
    got = _convert_encoder(convert, sd, family)
    for g, r in zip(got, ref):
        assert_trees_equal(g, r)
    # numpy input (the JAX converter's own) gives the same tree
    got_np = _convert_encoder(convert, jax_convert.state_dict_to_numpy(sd), family)
    for g, r in zip(got_np, ref):
        assert_trees_equal(g, r)


def test_converted_tree_does_not_alias_the_module():
    model = hf_model("conformer")
    enc, _, state = _convert_encoder(convert, model.state_dict(), "conformer")
    before = state["layers"][0]["batch_norm"]["mean"].clone()
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.add_(1.0)
    assert torch.equal(state["layers"][0]["batch_norm"]["mean"], before)


def reference_state_dict(learnable_initial_state=False):
    """tests/test_brain_converter.py's reference brain_encoder.pt layout,
    with a 2-layer FC and, optionally, the GRU's learnable initial state."""
    torch.manual_seed(0)
    sd = {"day_weights": torch.randn(N_DAYS, C, C), "day_bias": torch.randn(N_DAYS, 1, C)}
    for i in range(N_DAYS):
        lin = torch.nn.Linear(C, C)
        sd[f"inpLayer{i}.weight"], sd[f"inpLayer{i}.bias"] = lin.weight.data, lin.bias.data
    gru = torch.nn.GRU(IN, H, num_layers=2, bidirectional=True, batch_first=True)
    for k, v in gru.state_dict().items():
        sd[f"neural_decoder.encoder.gru.{k}"] = v
    fc = torch.nn.Sequential(torch.nn.Linear(2 * H, 32), torch.nn.GELU(), torch.nn.Linear(32, LATENT))
    for k, v in fc.state_dict().items():
        sd[f"neural_decoder.encoder.fc.{k}"] = v
    if learnable_initial_state:
        sd["neural_decoder.encoder.hidden_start"] = torch.randn(4, 1, H)
    sd["discriminator.0.weight"] = torch.randn(3, 3)
    sd["suc_for_ctc.head.weight"] = torch.randn(3, 3)
    return sd


@pytest.mark.parametrize("learnable_initial_state", [False, True])
def test_brain_encoder_tree_equals_jax(learnable_initial_state):
    sd = reference_state_dict(learnable_initial_state)
    ref = jax_convert.brain_encoder_from_torch(jax_convert.state_dict_to_numpy(sd))
    got = convert.brain_encoder_from_torch(sd)
    assert_trees_equal(got, ref)
    assert ("hidden_start" in got["gru"]) == learnable_initial_state
    assert len(got["fc"]["layers"]) == 2


@pytest.mark.parametrize("family", ["wav2vec2", "conformer"])
def test_full_model_tree_equals_jax(family):
    """The reference's model.pt: brain_encoder.* and w2v_encoder.*."""
    sd = {f"brain_encoder.{k}": v for k, v in reference_state_dict().items()}
    for k, v in legacy_spelling(hf_model(family).state_dict()).items():
        sd[f"w2v_encoder.{k}"] = v
    ref_params, ref_state = jax_convert.full_model_from_torch(jax_convert.state_dict_to_numpy(sd), family, 2)
    params, state = convert.full_model_from_torch(sd, family, 2)
    assert_trees_equal(params, ref_params)
    assert_trees_equal(state, ref_state)


def test_a_missing_key_is_named():
    sd = hf_model("wav2vec2").state_dict()
    del sd["wav2vec2.encoder.layers.1.attention.k_proj.weight"]
    with pytest.raises(KeyError, match=r"wav2vec2\.encoder\.layers\.1\.attention\.k_proj\.weight"):
        _convert_encoder(convert, sd, "wav2vec2")
    sd = reference_state_dict()
    del sd["inpLayer3.bias"]
    with pytest.raises(KeyError, match="inpLayer3.bias"):
        convert.brain_encoder_from_torch(sd)
