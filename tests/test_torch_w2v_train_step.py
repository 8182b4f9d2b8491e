"""One and two train steps of the wav2vec2-base family (`b2p2t_gru+w2v`)
at a tiny size, the port against the JAX package's build_step_fns train
step at f32 on the same bridged weights and batch (its Pallas kernels in
interpret mode, the `all` policy, hash dropout). The model and batch are
tests/test_torch_w2v_slice.py's: the fft sweep's shape of model (a 3-layer
biGRU, no FC hidden layer, gaussian_smooth_width 1.5) with GRU H=128 and
`Wav2Vec2EncoderConfig.tiny_test()`, B=3, 60 frames (T'=8), trained with
unfreeze_strategy brain_encoder+w2v and Adam at the sweep's weight decay
1e-4, in two variants: dropout off, and dropout on (the JAX defaults 0.1,
the sweep's GRU dropout 0.45, LayerDrop 0.5) with the JAX key chain's seeds
and LayerDrop masks replayed through the port's seed streams.

Compared per step: the loss (rel 1e-5), every gradient leaf (atol 1e-4 +
rtol 1e-4: f32 sums in another order through three GRU and two encoder
layers), and the params after Adam (atol 2e-5: Adam's eps is 1e-4, as in
tests/test_torch_train_step.py, so a gradient difference d moves a param by
at most lr * d / eps). The optimizer state enters through the bridge."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_w2v_slice import SENTENCES, VARIANTS, _batch, _np, _specs
from wav2vec2forbrain_tpu.models import assembly as jax_assembly
from wav2vec2forbrain_tpu.ops import select as jax_select
from wav2vec2forbrain_tpu.train import steps as jax_steps
from wav2vec2forbrain_tpu.train.optim import make_optimizer as jax_make_optimizer
from wav2vec2forbrain_tpu_torch import bridge
from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch, to_device
from wav2vec2forbrain_tpu_torch.models import assembly as port_assembly
from wav2vec2forbrain_tpu_torch.models.seeds import W2V_LAYER_SITES, ForwardRng, SeedStream, StepRng
from wav2vec2forbrain_tpu_torch.train import optim as port_optim
from wav2vec2forbrain_tpu_torch.train import steps as port_steps
from wav2vec2forbrain_tpu_torch.tree import tree_map
from torch_jax_prng import jax_threefry  # noqa: F401

torch.set_num_threads(1)
BRAIN_LR, W2V_LR, EPS, WEIGHT_DECAY = 1e-3, 1e-4, 1e-4, 1e-4
INT32_MAX = np.iinfo(np.int32).max


def jax_w2v_seed_streams(k_model, jspec) -> ForwardRng:
    """Replay the JAX forward's key chain (assembly.forward -> apply_gru,
    apply_w2v_encoder, apply_lm_head) into the port's three seed streams."""
    cfg = jspec.w2v_cfg

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
    for _ in range(cfg.num_hidden_layers):
        for site in W2V_LAYER_SITES:
            if getattr(cfg, site) > 0:
                enc_key, s = draw(enc_key)
                enc.append(s)
    head = []
    if cfg.final_dropout > 0:
        head_key, s = draw(head_key)
        head.append(s)
    return ForwardRng(SeedStream(seeds=gru), SeedStream(seeds=enc, layerdrop=layerdrop), SeedStream(seeds=head))


@functools.lru_cache(maxsize=None)
def _train(variant: str, n_steps: int = 2):
    """Both packages through n_steps train steps; per step the loss,
    gradients (port layout) and post-Adam params of each."""
    jspec, tspec = _specs(variant)
    params, state = jax_assembly.init_model_params(jax.random.PRNGKey(7), jspec)
    labels = jax_assembly.param_labels(params, "brain_encoder+w2v")
    trainable, frozen = jax_steps.partition_params(params, labels)
    tlabels = jax_steps.prune_labels(labels, trainable)
    tx = jax_make_optimizer(tlabels, "adam", WEIGHT_DECAY, EPS)
    opt_state = tx.init(trainable)
    step_cfg = jax_steps.StepConfig(None, 0.0, 0.0)
    jax_train_step = jax.jit(jax_steps.build_step_fns(jspec, tlabels, tx, step_cfg)[0])
    host = _batch(0, SENTENCES[:3])
    jbatch = B2tBatch(*(None if a is None else jnp.asarray(a) for a in host))

    tp, ts = bridge.params_from_jax(_np(params), _np(state), device="cpu")
    port_labels = port_assembly.param_labels(tp, "brain_encoder+w2v")
    assert port_labels == bridge.labels_from_jax(labels)
    opt = port_optim.make_optimizer(port_labels, "adam", WEIGHT_DECAY, EPS)
    port_opt_state = bridge.opt_state_from_jax(_np(opt_state), tp, device="cpu")
    pcfg = port_steps.StepConfig(None, 0.0, 0.0)
    grad_fn = port_steps.build_grad_fn(tspec, port_labels, pcfg)
    train_step = port_steps.build_train_step(tspec, port_labels, opt, pcfg)
    tbatch = to_device(host, "cpu")

    def jax_loss(t, f, k_model):
        out = jax_assembly.forward_with_loss(
            jax_steps.merge_params(t, f), state, jspec, jbatch.input, jbatch.day_idxs,
            jbatch.input_lens, jbatch.target, jbatch.target_lens, k_model, train=True,
        )
        return out["loss"]

    jax_grads = jax.jit(jax.value_and_grad(jax_loss))
    rng = jax.random.PRNGKey(11)
    results = []
    jax_select.set_kernel_policy("all")
    try:
        for _ in range(n_steps):
            k_model = jax.random.split(rng, 4)[3]
            jloss, jgrads = jax_grads(trainable, frozen, k_model)
            jgrads = jax_steps.merge_params(jgrads, jax.tree_util.tree_map(lambda a: None, frozen))
            out = jax_train_step(trainable, frozen, opt_state, state, jbatch, rng,
                                 jnp.float32(BRAIN_LR), jnp.float32(W2V_LR))
            np.testing.assert_allclose(float(out.loss), float(jloss), rtol=1e-6)
            trainable, opt_state, rng = out.params, out.opt_state, out.rng

            fwd = jax_w2v_seed_streams(k_model, jspec)
            replay = [fwd, ForwardRng(*(SeedStream(seeds=s._seeds, layerdrop=s._layerdrop) for s in fwd))]
            pout, pgrads, _ = grad_fn(tp, ts, tbatch, StepRng(device="cpu", replay=replay[:1]))
            tout = train_step(tp, port_opt_state, ts, tbatch, StepRng(device="cpu", replay=replay[1:]),
                              BRAIN_LR, W2V_LR)
            port_opt_state = tout.opt_state
            results.append(dict(
                jax=dict(loss=float(jloss), grads=_np(jgrads), layerdrop=fwd.enc._layerdrop,
                         params=_np(jax_steps.merge_params(trainable, frozen))),
                port=dict(loss=float(pout["loss"].detach()), step_loss=float(tout.loss), grads=pgrads,
                          state=tout.model_state, params=tree_map(lambda t: t.detach().clone(), tp)),
            ))
    finally:
        jax_select.set_kernel_policy("auto")
    return results


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
    r = _train(variant)[step - 1]
    jx, pt = r["jax"], r["port"]
    np.testing.assert_allclose(pt["loss"], jx["loss"], rtol=1e-5)
    np.testing.assert_allclose(pt["step_loss"], jx["loss"], rtol=1e-5)
    assert pt["state"] == {"encoder": {}}
    if variant == "dropout_on":
        assert jx["layerdrop"] and len(jx["layerdrop"][0]) == 2
    n_grads = 0
    for path, jg, pg in _pairs(jx["grads"], pt["grads"]):
        if jg is None:
            assert pg is None or not torch.any(pg), path
            continue
        got = np.zeros_like(jg) if pg is None else pg.numpy()  # a layer LayerDrop skipped
        np.testing.assert_allclose(got, jg, atol=1e-4, rtol=1e-4, err_msg=path)
        n_grads += 1
    assert n_grads >= 40
    for path, jp, pp in _pairs(jx["params"], pt["params"]):
        np.testing.assert_allclose(pp.numpy(), jp, atol=2e-5, rtol=0, err_msg=path)
