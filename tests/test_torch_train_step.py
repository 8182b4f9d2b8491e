"""One and two train steps of a tiny conformer (`tiny_test`, biGRU 2 x 128)
in the port against the JAX package's build_step_fns train step at f32 on
the same bridged weights and batch (Pallas kernels in interpret mode, the
`all` kernel policy, hash dropout), in four variants:

- dropout_off: every dropout and LayerDrop off;
- dropout_on: the JAX default dropouts (0.1), GRU dropout 0.1 and LayerDrop
  0.5, with the JAX key chain's seeds and LayerDrop masks replayed through
  the port's seed streams (models/seeds.py);
- clip: gradient clipping at 0.5, so the norm covers the frozen leaves too;
- brain_encoder: the whole w2v subtree frozen;
- aux_head_h0: the intermediate CTC head on the brain latents (squared,
  weight 0.5; its loss metrics compared too) and a learnable GRU h0.

Compared per step: the loss (rel 1e-5), every gradient leaf and the new
BatchNorm running stats (atol 1e-4 + rtol 1e-4: f32 sums in another order
through two GRU and two conformer layers), and the params after Adam (atol
2e-5: Adam divides by sqrt(v) + eps, eps = 1e-4 as in
tests/test_golden_full_model.py, so a gradient difference d moves a param by
at most lr * d / eps = 1e-3 * 1e-6 / 1e-4 = 1e-5; aux_head_h0's squared
aux loss makes every gradient ~15x larger, and its largest param difference
is 1.3e-5, in day_weights entries whose gradient is near eps). The optimizer
state crosses the bridge in both directions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu.models import assembly as jax_assembly
from wav2vec2forbrain_tpu.models.conformer import ConformerEncoderConfig as JaxConformerConfig
from wav2vec2forbrain_tpu.ops import select as jax_select
from wav2vec2forbrain_tpu.train import steps as jax_steps
from wav2vec2forbrain_tpu.train.optim import make_optimizer as jax_make_optimizer
from wav2vec2forbrain_tpu_torch import bridge
from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch, to_device
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer
from wav2vec2forbrain_tpu_torch.models import assembly as port_assembly
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.models.seeds import ForwardRng, SeedStream, StepRng
from wav2vec2forbrain_tpu_torch.train import optim as port_optim
from wav2vec2forbrain_tpu_torch.train import steps as port_steps
from wav2vec2forbrain_tpu_torch.tree import tree_map
from torch_jax_prng import jax_threefry  # noqa: F401

torch.set_num_threads(1)
BRAIN_LR, W2V_LR, EPS = 1e-3, 1e-4, 1e-4
INT32_MAX = np.iinfo(np.int32).max
DROPOUT_OFF = dict(hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
                   conformer_conv_dropout=0.0, final_dropout=0.0, layerdrop=0.0)
VARIANTS = {
    "dropout_off": dict(cfg=DROPOUT_OFF, gru_dropout=0.0, clip=None, strategy="brain_encoder+w2v"),
    "dropout_on": dict(cfg=dict(layerdrop=0.5), gru_dropout=0.1, clip=None, strategy="brain_encoder+w2v"),
    "clip": dict(cfg=DROPOUT_OFF, gru_dropout=0.0, clip=0.5, strategy="brain_encoder+w2v"),
    "brain_encoder": dict(cfg=DROPOUT_OFF, gru_dropout=0.0, clip=None, strategy="brain_encoder"),
    "aux_head_h0": dict(cfg=DROPOUT_OFF, gru_dropout=0.0, clip=None, strategy="brain_encoder+w2v", extra=dict(
        aux_head_vocab_size=32, additional_loss_weight=0.5, additional_loss_squared=True,
        gru_learnable_initial_state=True)),
}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    b, t = 3, 96
    lens = np.array([96, 80, 64], np.int32)
    x = rng.standard_normal((b, t, 256)).astype(np.float32)
    x[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    tok = Wav2Vec2CTCTokenizer()
    ids = [tok.encode(s) for s in ("HI", "A CAT", "GO")]
    target = np.zeros((b, max(len(i) for i in ids)), np.int32)
    for i, seq in enumerate(ids):
        target[i, : len(seq)] = seq
    return B2tBatch(input=x, target=target, day_idxs=rng.integers(0, 24, b).astype(np.int32),
                    input_lens=lens, target_lens=np.array([len(i) for i in ids], np.int32))


def jax_seed_streams(k_model, jspec) -> ForwardRng:
    """Replay the JAX forward's key chain (assembly.forward -> apply_gru,
    apply_conformer_encoder, the head) into the port's three seed streams."""
    cfg = jspec.conformer_cfg

    def draw(key):
        key, sub = jax.random.split(key)
        return key, int(jax.random.randint(sub, (), 0, INT32_MAX, dtype=jnp.int32))

    _, gru_key, enc_key, head_key = jax.random.split(k_model, 4)
    gru = []
    if jspec.gru_dropout > 0:
        for _ in range(jspec.gru_num_layers - 1):
            gru_key, s = draw(gru_key)
            gru.append(s)
    enc, layerdrop = [], []
    if cfg.hidden_dropout > 0:
        enc_key, s = draw(enc_key)
        enc.append(s)
    if cfg.layerdrop > 0:
        enc_key, sub = jax.random.split(enc_key)
        layerdrop.append(np.asarray(jax.random.uniform(sub, (cfg.num_hidden_layers,)) < cfg.layerdrop).tolist())
    rates = (cfg.activation_dropout, cfg.hidden_dropout, cfg.attention_dropout, cfg.attention_dropout,
             cfg.conformer_conv_dropout, cfg.activation_dropout, cfg.hidden_dropout)
    for _ in range(cfg.num_hidden_layers):
        for r in rates:
            if r > 0:
                enc_key, s = draw(enc_key)
                enc.append(s)
    head = []
    if cfg.final_dropout > 0:
        head_key, s = draw(head_key)
        head.append(s)
    return ForwardRng(SeedStream(seeds=gru), SeedStream(seeds=enc, layerdrop=layerdrop), SeedStream(seeds=head))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def _run(variant: str, n_steps: int = 2):
    """Both packages through n_steps train steps; per step the loss,
    gradient tree (port layout), new BN state and post-Adam params of each."""
    v = VARIANTS[variant]
    jspec = jax_assembly.ModelSpec(
        gru_hidden_size=128, latent_size=96, encoder_family="conformer", gru_dropout=v["gru_dropout"],
        conformer_cfg=JaxConformerConfig.tiny_test(hidden_act="swish", **v["cfg"]),
        compute_dtype=jnp.float32, use_pallas=True, **v.get("extra", {}),
    )
    tspec = port_assembly.ModelSpec(
        gru_hidden_size=128, latent_size=96, gru_dropout=v["gru_dropout"],
        conformer_cfg=ConformerEncoderConfig.tiny_test(hidden_act="swish", **v["cfg"]),
        **v.get("extra", {}),
    )
    params, state = jax_assembly.init_model_params(jax.random.PRNGKey(7), jspec)
    labels = jax_assembly.param_labels(params, v["strategy"])
    trainable, frozen = jax_steps.partition_params(params, labels)
    tlabels = jax_steps.prune_labels(labels, trainable)
    tx = jax_make_optimizer(tlabels, "adam", 0.0, EPS)
    opt_state = tx.init(trainable)
    step_cfg = jax_steps.StepConfig(v["clip"], 0.0, 0.0)
    jax_train_step = jax.jit(jax_steps.build_step_fns(jspec, tlabels, tx, step_cfg)[0])
    host = _batch()
    jbatch = B2tBatch(*(None if a is None else jnp.asarray(a) for a in host))

    tp, ts = bridge.params_from_jax(_np(params), _np(state), device="cpu")
    port_labels = port_assembly.param_labels(tp, v["strategy"])
    assert port_labels == bridge.labels_from_jax(labels)
    opt = port_optim.make_optimizer(port_labels, "adam", 0.0, EPS)
    port_opt_state = bridge.opt_state_from_jax(_np(opt_state), tp, device="cpu")
    pcfg = port_steps.StepConfig(v["clip"], 0.0, 0.0)
    grad_fn = port_steps.build_grad_fn(tspec, port_labels, pcfg)
    train_step = port_steps.build_train_step(tspec, port_labels, opt, pcfg)
    tbatch = to_device(host, "cpu")

    def jax_loss(t, f, model_state, k_model):
        out = jax_assembly.forward_with_loss(
            jax_steps.merge_params(t, f), model_state, jspec, jbatch.input, jbatch.day_idxs,
            jbatch.input_lens, jbatch.target, jbatch.target_lens, k_model, train=True,
        )
        return out["loss"], out["state"]

    argnums = (0, 1) if v["clip"] is not None else 0
    jax_grads = jax.jit(jax.value_and_grad(jax_loss, argnums=argnums, has_aux=True))
    rng = jax.random.PRNGKey(11)
    results = []
    jax_select.set_kernel_policy("all")
    try:
        for _ in range(n_steps):
            k_model = jax.random.split(rng, 4)[3]
            (jloss, jstate), jgrads = jax_grads(trainable, frozen, state, k_model)
            if v["clip"] is not None:
                jgrads = jax_steps.merge_params(*jax_steps.clip_by_global_norm_pair(*jgrads, v["clip"]))
            else:
                jgrads = jax_steps.merge_params(jgrads, jax.tree_util.tree_map(lambda a: None, frozen))
            out = jax_train_step(trainable, frozen, opt_state, state, jbatch, rng,
                                 jnp.float32(BRAIN_LR), jnp.float32(W2V_LR))
            np.testing.assert_allclose(float(out.loss), float(jloss), rtol=1e-6)
            trainable, opt_state, state, rng = out.params, out.opt_state, out.model_state, out.rng

            fwd = jax_seed_streams(k_model, jspec)
            replay = [fwd, ForwardRng(*(SeedStream(seeds=s._seeds, layerdrop=s._layerdrop) for s in fwd))]
            pout, pgrads, _ = grad_fn(tp, ts, tbatch, StepRng(device="cpu", replay=replay[:1]))
            tout = train_step(tp, port_opt_state, ts, tbatch, StepRng(device="cpu", replay=replay[1:]),
                              BRAIN_LR, W2V_LR)
            port_opt_state, ts = tout.opt_state, tout.model_state
            results.append(dict(
                jax=dict(loss=float(jloss), grads=_np(jgrads), state=_np(jstate),
                         metrics={k: float(x) for k, x in out.metrics.items()},
                         params=_np(jax_steps.merge_params(trainable, frozen)), layerdrop=fwd.enc._layerdrop),
                port=dict(loss=float(pout["loss"].detach()), step_loss=float(tout.loss), grads=pgrads,
                          metrics={k: float(x) for k, x in tout.metrics.items()},
                          state=ts, params=tree_map(lambda t: t.detach().clone(), tp)),
            ))
    finally:
        jax_select.set_kernel_policy("auto")
    return results, opt_state, port_opt_state


def _pairs(jax_tree, port_tree, path=""):
    if isinstance(port_tree, dict):
        for k in port_tree:
            yield from _pairs(jax_tree[k] if jax_tree is not None else None, port_tree[k], f"{path}/{k}")
    elif isinstance(port_tree, list):
        for i, v in enumerate(port_tree):
            yield from _pairs(jax_tree[i] if jax_tree is not None else None, v, f"{path}/{i}")
    else:
        yield path, jax_tree, port_tree


@pytest.mark.parametrize("step", [1, 2], ids=["one_step", "two_steps"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_matches_jax(variant, step):
    results, _, _ = _run(variant)
    r = results[step - 1]
    jx, pt = r["jax"], r["port"]
    np.testing.assert_allclose(pt["loss"], jx["loss"], rtol=1e-5)
    np.testing.assert_allclose(pt["step_loss"], jx["loss"], rtol=1e-5)
    assert pt["metrics"].keys() == jx["metrics"].keys()
    for k in jx["metrics"]:
        np.testing.assert_allclose(pt["metrics"][k], jx["metrics"][k], rtol=1e-5, err_msg=k)
    if variant == "aux_head_h0":
        assert set(jx["metrics"]) == {"ctc_loss", "intermediate_loss", "intermediate_loss_squared", "combined_loss"}
        assert torch.any(pt["grads"]["brain"]["gru"]["hidden_start"] != 0)
        assert pt["grads"]["aux_head"]["kernel"] is not None
    n_grads = 0
    for path, jg, pg in _pairs(jx["grads"], pt["grads"]):
        if jg is None:
            assert pg is None or not torch.any(pg), path
            continue
        got = np.zeros_like(jg) if pg is None else pg.numpy()  # not reached: a zero gradient
        np.testing.assert_allclose(got, jg, atol=1e-4, rtol=1e-4, err_msg=path)
        n_grads += 1
    assert n_grads >= 20
    for path, js, ps in _pairs(jx["state"], pt["state"]):
        np.testing.assert_allclose(ps.numpy(), js, atol=1e-4, rtol=1e-4, err_msg=path)
    for path, jp, pp in _pairs(jx["params"], pt["params"]):
        np.testing.assert_allclose(pp.numpy(), jp, atol=2e-5, rtol=0, err_msg=path)


def test_dropout_on_replays_a_dropped_layer_and_freezes_its_batch_norm():
    """The dropout_on variant's LayerDrop masks (from the JAX chain) drop a
    layer in some step, whose BN state then stays as it was."""
    results, _, _ = _run("dropout_on")
    masks = [r["jax"]["layerdrop"][0] for r in results]
    assert any(any(m) for m in masks) and not all(all(m) for m in masks)
    for r, mask in zip(results, masks):
        for i, dropped in enumerate(mask):
            assert (r["port"]["grads"]["w2v"]["encoder"]["layers"][i]["ffn1"]["output_dense"]["kernel"] is None) == dropped


def test_opt_state_crosses_the_bridge_both_ways():
    _, jax_state, port_state = _run("dropout_off")
    assert port_state.count == 2
    back = bridge.opt_state_to_jax(port_state, _np(jax_state))
    jl = jax.tree_util.tree_leaves(_np(jax_state))
    bl = jax.tree_util.tree_leaves(back)
    assert len(jl) == len(bl) > 10
    for a, b in zip(jl, bl):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-4)
