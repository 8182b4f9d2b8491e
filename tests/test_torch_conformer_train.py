"""Train mode of the port's conformer against the JAX package's: BatchNorm
on batch statistics (biased variance to normalise, unbiased into the
running variance, pad frames included) and the encoder with dropout on and
LayerDrop decisions injected from the JAX key chain, including a skipped
layer, whose BatchNorm state must stay as it was and whose dropout seeds
must still be consumed.

Tolerances: BatchNorm output and running stats atol 1e-5 (f32 means and
variances over B*T rows in another order); encoder hidden states and BN
state atol 1e-4 + rtol 1e-4 (three conformer layers of f32 sums in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu.models import conformer as jax_conf
from wav2vec2forbrain_tpu.ops import select as jax_select
from wav2vec2forbrain_tpu_torch.models import conformer as port_conf
from wav2vec2forbrain_tpu_torch.models.seeds import SeedStream
from wav2vec2forbrain_tpu_torch.tree import tree_map
from torch_jax_prng import jax_threefry  # noqa: F401

torch.set_num_threads(1)
INT32_MAX = np.iinfo(np.int32).max


@pytest.mark.parametrize("stream_dtype", ["float32", "bfloat16"])
def test_batch_norm_train_statistics_match_jax(stream_dtype):
    rng = np.random.default_rng(0)
    x = (2.0 + 3.0 * rng.standard_normal((4, 7, 16))).astype(np.float32)
    x[1, 5:] = 0.0  # pad frames take part in the statistics
    p = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32), "bias": rng.standard_normal(16).astype(np.float32)}
    s = {"mean": rng.standard_normal(16).astype(np.float32), "var": rng.uniform(0.5, 2, 16).astype(np.float32)}
    jcfg = jax_conf.ConformerEncoderConfig.tiny_test(batch_norm_momentum=0.2)
    xj = jnp.asarray(x).astype(jnp.dtype(stream_dtype))
    y_ref, s_ref = jax_conf._batch_norm(jax.tree_util.tree_map(jnp.asarray, p), jax.tree_util.tree_map(jnp.asarray, s),
                                        xj, jcfg, train=True)
    tcfg = port_conf.ConformerEncoderConfig.tiny_test(batch_norm_momentum=0.2)
    xt = torch.from_numpy(x).to(getattr(torch, stream_dtype))
    y, new = port_conf._batch_norm(tree_map(torch.from_numpy, p), tree_map(torch.from_numpy, s), xt, tcfg, train=True)
    assert y.dtype == xt.dtype
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_ref.astype(jnp.float32)),
                               atol=1e-5 if stream_dtype == "float32" else 2.0**-7 * 8)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(s_ref[k]), atol=1e-5, rtol=1e-6)
    # eval mode keeps the state object and uses the running stats
    _, same = port_conf._batch_norm(tree_map(torch.from_numpy, p), tree_map(torch.from_numpy, s), xt, tcfg, train=False)
    np.testing.assert_array_equal(same["var"].numpy(), s["var"])


def _encoder_replay(key, cfg):
    """The JAX apply_conformer_encoder's draws from `key`: the input
    dropout seed, the LayerDrop mask, then seven seeds per layer."""
    def draw(k):
        k, sub = jax.random.split(k)
        return k, int(jax.random.randint(sub, (), 0, INT32_MAX, dtype=jnp.int32))

    key, first = draw(key)
    key, sub = jax.random.split(key)
    mask = np.asarray(jax.random.uniform(sub, (cfg.num_hidden_layers,)) < cfg.layerdrop).tolist()
    seeds = [first]
    for _ in range(cfg.num_hidden_layers * 7):
        key, s = draw(key)
        seeds.append(s)
    return seeds, mask


def test_encoder_train_with_injected_layerdrop_matches_jax():
    kw = dict(hidden_act="swish", num_hidden_layers=3, layerdrop=0.5)
    jcfg = jax_conf.ConformerEncoderConfig.tiny_test(**kw)
    tcfg = port_conf.ConformerEncoderConfig.tiny_test(**kw)
    # a key whose LayerDrop mask skips some layer and keeps another
    key = next(k for k in (jax.random.PRNGKey(i) for i in range(100))
               if 0 < sum(_encoder_replay(k, jcfg)[1]) < jcfg.num_hidden_layers)
    seeds, mask = _encoder_replay(key, jcfg)
    params = jax_conf.init_conformer_encoder_params(jax.random.PRNGKey(1), jcfg)
    state = jax_conf.init_conformer_state(jcfg)
    state["layers"][0]["batch_norm"]["mean"] = jnp.full((96,), 0.25)
    x = np.random.default_rng(2).standard_normal((2, 13, 96)).astype(np.float32)
    jax_select.set_kernel_policy("all")
    try:
        h_ref, s_ref = jax_conf.apply_conformer_encoder(params, state, jnp.asarray(x), jcfg, key, train=True,
                                                        compute_dtype=jnp.float32, use_pallas=True)
    finally:
        jax_select.set_kernel_policy("auto")
    to_t = lambda tree: tree_map(lambda a: torch.from_numpy(np.array(a)), tree)  # noqa: E731
    stream = SeedStream(seeds=seeds, layerdrop=[mask])
    h, new_state = port_conf.apply_conformer_encoder(to_t(params), to_t(state), torch.from_numpy(x), tcfg,
                                                     train=True, compute_dtype=torch.float32, stream=stream)
    assert stream.n_seeds == len(seeds) and stream.layerdrop_drawn == [mask]
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_ref), atol=1e-4, rtol=1e-4)
    for i, dropped in enumerate(mask):
        got, ref = new_state["layers"][i]["batch_norm"], s_ref["layers"][i]["batch_norm"]
        before = state["layers"][i]["batch_norm"]
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=1e-4)
            assert np.array_equal(got[k].numpy(), np.asarray(before[k])) == dropped
