"""The port's torch-semantics Adam against the JAX package's make_optimizer
+ scale_updates_by_lr + optax.apply_updates over three steps, on a small
tree with a brain group, a w2v group (its own LR) and a frozen leaf; with
and without weight decay, and with bf16 storage of mu and/or nu; plus
clip_by_global_norm and the per-epoch LR schedules.

Tolerance: params rtol 2e-6 / atol 1e-7 (the f32 bias corrections
1 - b ** count come from two pow implementations and may differ by an
ulp); moments stored in bf16 may round to the neighbouring bf16 value
(rtol 2^-7), in f32 rtol 2e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wav2vec2forbrain_tpu.train import optim as jax_optim
from wav2vec2forbrain_tpu.train import steps as jax_steps
from wav2vec2forbrain_tpu_torch import bridge
from wav2vec2forbrain_tpu_torch.train import optim as port_optim
from wav2vec2forbrain_tpu_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

BRAIN_LR, W2V_LR = 3e-3, 5e-4


def _tree(rng):
    return {
        "brain": {"gru": {"w": rng.standard_normal((5, 4)).astype(np.float32),
                          "b": rng.standard_normal((4,)).astype(np.float32)},
                  "preproc": {"day": rng.standard_normal((3, 3)).astype(np.float32),
                              "inp_layers": rng.standard_normal((3,)).astype(np.float32)}},
        "w2v": {"layers": [{"k": rng.standard_normal((2, 6)).astype(np.float32)},
                           {"k": rng.standard_normal((2, 6)).astype(np.float32)}]},
    }


def _labels(tree):
    def lab(path_label, sub):
        return jax.tree_util.tree_map(lambda _: path_label, sub)

    labels = {"brain": lab("brain", tree["brain"]), "w2v": lab("w2v", tree["w2v"])}
    labels["brain"]["preproc"]["inp_layers"] = "frozen"
    return labels


@pytest.mark.parametrize(
    "wd,mu_dtype,nu_dtype",
    [(0.0, None, None), (1e-2, None, None), (0.0, "bfloat16", None), (1e-2, "bfloat16", "bfloat16"),
     (0.0, None, "bfloat16")],
    ids=["plain", "weight_decay", "mu_bf16", "wd_mu_nu_bf16", "nu_bf16"],
)
def test_adam_matches_jax_for_three_steps(wd, mu_dtype, nu_dtype):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    labels = _labels(params)
    trainable, frozen = jax_steps.partition_params(jax.tree_util.tree_map(jnp.asarray, params), labels)
    tlabels = jax_steps.prune_labels(labels, trainable)
    jd = lambda n: None if n is None else jnp.dtype(n)  # noqa: E731
    tx = jax_optim.make_optimizer(tlabels, "adam", wd, 1e-8, jd(mu_dtype), jd(nu_dtype))
    jstate = tx.init(trainable)

    tparams = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    td = lambda n: None if n is None else getattr(torch, n)  # noqa: E731
    opt = port_optim.make_optimizer(labels, "adam", wd, 1e-8, td(mu_dtype), td(nu_dtype))
    pstate = opt.init(tparams)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        g_t, _ = jax_steps.partition_params(jax.tree_util.tree_map(jnp.asarray, grads), labels)
        updates, jstate = tx.update(g_t, jstate, trainable)
        updates = jax_optim.scale_updates_by_lr(updates, tlabels, jnp.float32(BRAIN_LR), jnp.float32(W2V_LR))
        trainable = optax.apply_updates(trainable, updates)
        tgrads = tree_map(
            lambda g, lab: None if lab == "frozen" else torch.from_numpy(g), grads, labels)
        pstate = opt.step(tparams, tgrads, pstate, BRAIN_LR, W2V_LR)
    assert pstate.count == 3
    ref = jax_steps.merge_params(trainable, frozen)
    for r, p in _walk(ref, tparams):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(tparams["brain"]["preproc"]["inp_layers"].numpy(),
                                  params["brain"]["preproc"]["inp_layers"])
    # the JAX state's two groups (one Adam state each), merged through the bridge
    jmoments = bridge.opt_state_from_jax(jax.device_get(jstate), tparams, device="cpu")
    assert jmoments.count == 3
    for name, dt in (("mu", mu_dtype), ("nu", nu_dtype)):
        pairs = list(_walk(getattr(jmoments, name), getattr(pstate, name)))
        assert len(pairs) == 6 and sum(r is None for r, _ in pairs) == 1  # inp_layers: no state
        for r, m in pairs:
            if r is None:
                assert m is None
                continue
            assert m.dtype == r.dtype == (torch.bfloat16 if dt else torch.float32)
            np.testing.assert_allclose(m.float().numpy(), r.float().numpy(),
                                       rtol=2.0**-7 if dt else 2e-6, atol=1e-8)


def _walk(ref, ours):
    """(ref leaf, our leaf) pairs by key path (JAX orders dict keys sorted)."""
    if isinstance(ours, dict):
        for k in ours:
            yield from _walk(ref[k], ours[k])
    elif isinstance(ours, list):
        for i, v in enumerate(ours):
            yield from _walk(ref[i], v)
    else:
        yield ref, ours


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    grads = _tree(rng)
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    tg = tree_map(torch.from_numpy, grads)
    for max_norm in (0.5, 1e3):
        ref = jax_optim.clip_by_global_norm(jg, max_norm)
        got, norm = port_optim.clip_by_global_norm(tg, max_norm)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)), rtol=1e-6)
        for r, g in _walk(ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


def test_tree_leaves_with_path_matches_jax_paths():
    """The port's (path, leaf) walk names the same leaves as JAX's key paths;
    JAX sorts dict keys, the port keeps insertion order."""
    tree = _tree(np.random.default_rng(2))
    tree["w2v"]["layers"][1]["skip"] = None
    ours = tree_leaves_with_path(tree)
    flat = tree_leaves(tree)
    assert len(flat) == len(ours) == 6 and all(a is b for (_, a), b in zip(ours, flat))
    assert [p for p, _ in ours][:2] == ["/brain/gru/w", "/brain/gru/b"]
    ref = {"".join(f"/{getattr(k, 'key', getattr(k, 'idx', None))}" for k in kp): leaf
           for kp, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    assert sorted(p for p, _ in ours) == sorted(ref)
    assert all(leaf is ref[p] for p, leaf in ours)


def test_make_optimizer_ports_adam_only():
    """Adam and SGD are the two optimizers the flags allow (--optimizer);
    SGD has the JAX semantics (momentum 0, weight decay added to the
    gradient, no moments), held to the JAX make_optimizer over three steps;
    any other name raises."""
    with pytest.raises(ValueError, match="rmsprop"):
        port_optim.make_optimizer(_labels(_tree(np.random.default_rng(3))), "rmsprop")
    rng = np.random.default_rng(3)
    params = _tree(rng)
    labels = _labels(params)
    trainable, frozen = jax_steps.partition_params(jax.tree_util.tree_map(jnp.asarray, params), labels)
    tlabels = jax_steps.prune_labels(labels, trainable)
    tx = jax_optim.make_optimizer(tlabels, "sgd", 1e-2)
    jstate = tx.init(trainable)
    tparams = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    opt = port_optim.make_optimizer(labels, "sgd", 1e-2)
    pstate = opt.init(tparams)
    assert pstate.mu is None and pstate.nu is None
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        g_t, _ = jax_steps.partition_params(jax.tree_util.tree_map(jnp.asarray, grads), labels)
        updates, jstate = tx.update(g_t, jstate, trainable)
        updates = jax_optim.scale_updates_by_lr(updates, tlabels, jnp.float32(BRAIN_LR), jnp.float32(W2V_LR))
        trainable = optax.apply_updates(trainable, updates)
        tgrads = tree_map(lambda g, lab: None if lab == "frozen" else torch.from_numpy(g), grads, labels)
        pstate = opt.step(tparams, tgrads, pstate, BRAIN_LR, W2V_LR)
    assert pstate.count == 3
    for r, p in _walk(jax_steps.merge_params(trainable, frozen), tparams):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=2e-6, atol=1e-7)


def test_lr_schedules_match_jax():
    for epoch in range(12):
        assert port_optim.step_lr(1e-3, 4, 0.5)(epoch) == jax_optim.step_lr(1e-3, 4, 0.5)(epoch)
    for adjust in (False, True):
        ref = jax_optim.two_module_warmup_schedules(1e-3, 3, 4, 2e-4, adjust)
        got = port_optim.two_module_warmup_schedules(1e-3, 3, 4, 2e-4, adjust)
        for step in range(10):
            assert got.brain(step) == ref.brain(step) and got.w2v(step) == ref.w2v(step)
