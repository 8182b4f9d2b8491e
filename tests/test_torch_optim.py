"""The port's torch-semantics Adam against the JAX package's make_optimizer
+ scale_updates_by_lr + optax.apply_updates over three steps, on a small
tree with a brain group, a w2v group (its own LR) and a frozen leaf; with
and without weight decay, and with bf16 storage of mu and/or nu; plus
clip_by_global_norm and the per-epoch LR schedules.

Tolerance: params rtol 2e-6 / atol 1e-7 (the f32 bias corrections
1 - b ** count come from two pow implementations and may differ by an
ulp); moments stored in bf16 may round to the neighbouring bf16 value
(rtol 2^-7), in f32 rtol 2e-6.

The Adam kernel's table (ops/adam.py, csrc/adam.cu): on the CPU, its
entries walked with the kernel's arithmetic through torch.as_strided on
each entry's rows, bit for bit against Optimizer.step's loop over three
steps (weight decay, the moments' dtypes, ZeRO-1 off and on; every tree
has a leaf without a gradient, a frozen leaf and both LR groups); the rows
of pieces narrowed on each dim; what the table refuses. `cuda` (skipped
without a card): the kernel against the loop on the card over three steps,
bitwise, at those cases and at both families' full leaf sets, one launch
a step.

jax is imported only inside the `jx` fixture: the `cuda` tests run where
jax is not installed.
"""

import types

import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu_torch import bridge
from wav2vec2forbrain_tpu_torch.ops import adam, kernels, select
from wav2vec2forbrain_tpu_torch.parallel.mesh import DataShard
from wav2vec2forbrain_tpu_torch.parallel.zero import Zero1
from wav2vec2forbrain_tpu_torch.train import optim as port_optim
from wav2vec2forbrain_tpu_torch.tree import tree_leaves, tree_leaves_with_path, tree_map, tree_map_with_path


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax, jnp, optax and the JAX package's optim and steps."""
    import jax
    import jax.numpy as jnp
    import optax

    from wav2vec2forbrain_tpu.train import optim as jax_optim
    from wav2vec2forbrain_tpu.train import steps as jax_steps

    return types.SimpleNamespace(jax=jax, jnp=jnp, optax=optax, optim=jax_optim, steps=jax_steps)


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
        return tree_map(lambda _: path_label, sub)

    labels = {"brain": lab("brain", tree["brain"]), "w2v": lab("w2v", tree["w2v"])}
    labels["brain"]["preproc"]["inp_layers"] = "frozen"
    return labels


@pytest.mark.parametrize(
    "wd,mu_dtype,nu_dtype",
    [(0.0, None, None), (1e-2, None, None), (0.0, "bfloat16", None), (1e-2, "bfloat16", "bfloat16"),
     (0.0, None, "bfloat16")],
    ids=["plain", "weight_decay", "mu_bf16", "wd_mu_nu_bf16", "nu_bf16"],
)
def test_adam_matches_jax_for_three_steps(wd, mu_dtype, nu_dtype, jx):
    jax, jnp, optax, jax_optim, jax_steps = jx.jax, jx.jnp, jx.optax, jx.optim, jx.steps
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


def test_clip_by_global_norm_matches_jax(jx):
    jax, jnp, optax, jax_optim = jx.jax, jx.jnp, jx.optax, jx.optim
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


def test_tree_leaves_with_path_matches_jax_paths(jx):
    """The port's (path, leaf) walk names the same leaves as JAX's key paths;
    JAX sorts dict keys, the port keeps insertion order."""
    jax = jx.jax
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


def test_make_optimizer_ports_adam_only(jx):
    """Adam and SGD are the two optimizers the flags allow (--optimizer);
    SGD has the JAX semantics (momentum 0, weight decay added to the
    gradient, no moments), held to the JAX make_optimizer over three steps;
    any other name raises."""
    jax, jnp, optax, jax_optim, jax_steps = jx.jax, jx.jnp, jx.optax, jx.optim, jx.steps
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


def test_lr_schedules_match_jax(jx):
    jax_optim = jx.optim
    for epoch in range(12):
        assert port_optim.step_lr(1e-3, 4, 0.5)(epoch) == jax_optim.step_lr(1e-3, 4, 0.5)(epoch)
    for adjust in (False, True):
        ref = jax_optim.two_module_warmup_schedules(1e-3, 3, 4, 2e-4, adjust)
        got = port_optim.two_module_warmup_schedules(1e-3, 3, 4, 2e-4, adjust)
        for step in range(10):
            assert got.brain(step) == ref.brain(step) and got.w2v(step) == ref.w2v(step)


# --- the Adam kernel's table (ops/adam.py) -----------------------------------------------------

MOMENTS = {"f32_f32": (None, None), "bf16_none": (torch.bfloat16, None), "f32_bf16": (None, torch.bfloat16)}


def _adam_case(device):
    """(params, labels, gradient trees of three steps): both LR groups; a
    frozen leaf (no gradient, no state); `skip`, a leaf without a gradient
    in every step (as LayerDrop's skipped layers); `w` (5, 8), which ZeRO-1
    at dp 2 splits on dim 1; (6,) and (16, 12), split on dim 0; (3, 3) and
    the 7-element `k`, whole (7: the kernel's one-element path)."""
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen).to(device)

    params = {"brain": {"w": r(5, 8), "b": r(6), "frozen": r(4), "day": r(3, 3)},
              "w2v": {"k": r(7), "skip": r(2, 4), "q": r(16, 12)}}
    labels = {"brain": {"w": "brain", "b": "brain", "frozen": "frozen", "day": "brain"},
              "w2v": {"k": "w2v", "skip": "w2v", "q": "w2v"}}
    grads = [tree_map_with_path(lambda path, p, lab: None if lab == "frozen" or path.endswith("skip") else r(*p.shape),
                                params, labels) for _ in range(3)]
    return params, labels, grads


def _zero1(on):
    """Rank 1 of a data axis of 2 (no group: the tests leave the params' all-gather out)."""
    return Zero1(DataShard(rank=1, size=2, group=None)) if on else None


def _clone(tree):
    return tree_map(lambda t: None if t is None else t.clone(), tree)


def _kernel_walk(entries, s: adam.AdamScalars) -> None:
    """csrc/adam.cu's arithmetic over the table: each entry's p and g read
    through torch.as_strided on its row descriptor (n / inner rows of
    inner, p_stride / g_stride apart), m and v dense, its -lr from the
    row; each product, sum, quotient and root an f32 op of its own."""
    for e in entries:
        p, g, m, v, _ = e.leaf
        _, _, _, _, p_stride, g_stride, n, inner, _, _, neg_lr, _ = e.row
        shape = (n // inner, inner)
        p2 = torch.as_strided(p, shape, (p_stride, 1))
        gf = torch.zeros(shape) if g is None else torch.as_strided(g, shape, (g_stride, 1)).clone()
        m2, v2 = m.view(shape), v.view(shape)
        pf, mf, vf = p2.clone(), m2.float(), v2.float()
        if s.weight_decay != 0.0:
            gf = gf + pf * s.weight_decay
        g2 = gf * gf
        if s.stock:  # the decays rounded to the moments' dtypes, the products rounded to them too
            b1m, b2v = float(torch.tensor(s.b1, dtype=m.dtype)), float(torch.tensor(s.b2, dtype=v.dtype))
            mn = gf * (1 - s.b1) + (mf * b1m).to(m.dtype).float()
            vn = g2 * (1 - s.b2) + (vf * b2v).to(v.dtype).float()
        else:
            mn = mf * s.b1 + gf * (1 - s.b1)
            vn = vf * s.b2 + g2 * (1 - s.b2)
        u = (mn * s.inv_bc1) / (torch.sqrt(vn * s.inv_bc2) + s.eps)
        p2.copy_(pf + u * neg_lr)
        m2.copy_(mn)
        v2.copy_(vn)


def _loop_steps(opt, params, state, grads, monkeypatch):
    """Three Optimizer.step calls (the loop on the CPU; the params' all-gather of ZeRO-1 left out)."""
    if opt.zero is not None:
        monkeypatch.setattr(opt.zero, "gather_params", lambda params, labels: None)
    for g in grads:
        state = opt.step(params, g, state, BRAIN_LR, W2V_LR)
    return state


def _assert_bitwise(a, b):
    pairs = list(zip(tree_leaves(a), tree_leaves(b)))
    assert pairs and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs)


@pytest.mark.parametrize("zero1", [False, True], ids=["whole", "zero1"])
@pytest.mark.parametrize("moments", sorted(MOMENTS))
@pytest.mark.parametrize("wd", [0.0, 1e-4], ids=["wd0", "wd1e-4"])
def test_adam_table_walk_matches_the_loop_bitwise(wd, moments, zero1, monkeypatch):
    """The table's entries, walked with the kernel's arithmetic, update p,
    m and v bit for bit as Optimizer.step's loop does, over three steps."""
    params, labels, grads = _adam_case("cpu")
    mu, nu = MOMENTS[moments]
    opt = port_optim.make_optimizer(labels, "adam", wd, 1e-8, mu, nu, zero=_zero1(zero1))
    loop_params = _clone(params)
    loop_state = _loop_steps(opt, loop_params, opt.init(loop_params), grads, monkeypatch)

    walk_params = _clone(params)
    state = opt.init(walk_params)
    for count, g in enumerate(grads, start=1):
        entries = adam.adam_table(opt.trained_leaves(walk_params, g, state, BRAIN_LR, W2V_LR))
        table, chunks = adam.pack(entries)
        # the frozen leaf keeps no entry; `skip` has no gradient; each entry's row holds its tensors' pointers
        assert len(entries) == len(table) == 6 and chunks == 6
        assert not any(e.leaf.p.data_ptr() == walk_params["brain"]["frozen"].data_ptr() for e in entries)
        assert [e.leaf.g is None for e in entries] == [False] * 4 + [True, False]
        assert sorted({float(x) for x in table["neg_lr"]}) == [float(np.float32(-BRAIN_LR)), float(np.float32(-W2V_LR))]
        for e, row in zip(entries, table):
            assert row["p"] == e.leaf.p.data_ptr() and row["m"] == e.leaf.m.data_ptr()
            assert row["g"] == (0 if e.leaf.g is None else e.leaf.g.data_ptr())
        p_stride, g_stride, n, inner = entries[0].row[4:8]  # (5, 8): under ZeRO-1 columns 4-7, rows of 4, 8 apart
        assert (n, inner, p_stride, g_stride) == ((20, 4, 8, 8) if zero1 else (40, 40, 40, 40))
        _kernel_walk(entries, opt.scalars(count))
        state = port_optim.AdamState(count, state.mu, state.nu)
    _assert_bitwise(walk_params, loop_params)
    _assert_bitwise(state.mu, loop_state.mu)
    _assert_bitwise(state.nu, loop_state.nu)


@pytest.mark.parametrize("shape,dim", [((5, 8), 1), ((5, 8), 0), ((2, 6, 4), 1), ((2, 6, 4), 2), ((3, 1, 8), 2),
                                       ((4, 2, 6), 0), ((2, 3, 4, 6), 2)])
def test_adam_rows_of_narrowed_pieces(shape, dim):
    """A ZeRO-1 piece narrowed on any dim is rows of one length, at a
    stride; as_strided on them reads the piece's elements in order."""
    whole = torch.arange(float(np.prod(shape))).reshape(shape)
    piece = whole.narrow(dim, shape[dim] // 2, shape[dim] // 2)
    outer, inner, stride = adam.rows(piece, piece.numel())
    assert outer * inner == piece.numel()
    assert torch.equal(torch.as_strided(piece, (outer, inner), (stride, 1)).reshape(-1), piece.reshape(-1))
    assert adam.rows(whole.transpose(0, -1), whole.numel()) is None  # no run of rows holds a transpose


def test_adam_table_refuses_what_the_kernel_does_not_take():
    p, m = torch.zeros(4, 6), torch.zeros(4, 6)
    leaf = adam.AdamLeaf(p, torch.ones(4, 6), m, torch.zeros(4, 6), 1e-3)
    assert len(adam.adam_table([leaf, leaf._replace(g=None)])) == 2
    for bad in (leaf._replace(p=p.double()), leaf._replace(g=torch.ones(4, 6, dtype=torch.bfloat16)),
                leaf._replace(m=m.half()), leaf._replace(v=torch.zeros(6, 4).t()), leaf._replace(m=torch.zeros(25)),
                leaf._replace(g=torch.ones(6, 4).t()), leaf._replace(g=torch.ones(24))):
        with pytest.raises(ValueError, match="adam"):
            adam.adam_table([bad])
    with pytest.raises(ValueError, match="CUDA tensor"):  # the kernel's launch takes tensors on one card only
        adam.adam_update([leaf], port_optim.make_optimizer({"w": "brain"}).scalars(1))


# --- the kernel on the card (`cuda`) ---------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    select.f32_products()
    return torch.device("cuda")


def _kernel_vs_loop(params, labels, grads, monkeypatch, **kw):
    """Three steps through the kernel (`auto`) and through the loop
    (`none`) from one state: p, m and v bitwise; one launch a step."""
    opt = port_optim.make_optimizer(labels, "adam", **kw)
    sides = {}
    try:
        for policy in ("auto", "none"):
            select.set_kernel_policy(policy)
            p = _clone(params)
            state = opt.init(p)
            if opt.zero is not None:
                monkeypatch.setattr(opt.zero, "gather_params", lambda params, labels: None)
            for g in grads:
                before = kernels.LAUNCHES["adam"]
                state = opt.step(p, g, state, BRAIN_LR, W2V_LR)
                assert kernels.LAUNCHES["adam"] - before == (policy == "auto")
            torch.cuda.synchronize()
            sides[policy] = (p, state)
    finally:
        select.set_kernel_policy("auto")
    (kp, ks), (lp, ls) = sides["auto"], sides["none"]
    _assert_bitwise(kp, lp)
    _assert_bitwise(ks.mu, ls.mu)
    _assert_bitwise(ks.nu, ls.nu)


@pytest.mark.cuda
@pytest.mark.parametrize("zero1", [False, True], ids=["whole", "zero1"])
@pytest.mark.parametrize("moments", sorted(MOMENTS) + ["bf16_bf16"])
@pytest.mark.parametrize("wd", [0.0, 1e-4], ids=["wd0", "wd1e-4"])
def test_cuda_adam_kernel_matches_the_loop_bitwise(wd, moments, zero1, monkeypatch):
    dev = _cuda()
    params, labels, grads = _adam_case(dev)
    mu, nu = MOMENTS.get(moments, (torch.bfloat16, torch.bfloat16))
    _kernel_vs_loop(params, labels, grads, monkeypatch, weight_decay=wd, mu_dtype=mu, nu_dtype=nu, zero=_zero1(zero1))


@pytest.mark.cuda
@pytest.mark.parametrize("family,moments", [("conformer", "f32_f32"), ("w2v", "f32_f32"), ("conformer", "bf16_none"),
                                            ("conformer", "f32_bf16")])
def test_cuda_adam_kernel_matches_the_loop_at_full_leaf_sets(family, moments, monkeypatch):
    """Both families' full leaf sets at the published widths (the train
    cells'), a dropped encoder layer's leaves without gradients."""
    from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec, init_model_params, param_labels
    from wav2vec2forbrain_tpu_torch.profile_train import FAMILIES

    dev = _cuda()
    fields, weight_decay, _ = FAMILIES[family]
    spec = ModelSpec(compute_dtype=torch.float32, activation_dtype=torch.float32, **fields)
    params, _ = init_model_params(torch.Generator(device=dev).manual_seed(0), spec, dev)
    labels = param_labels(params, "brain_encoder+w2v")
    gen = torch.Generator(device=dev).manual_seed(1)
    dropped = "/w2v/encoder/layers/1/"
    grads = [tree_map_with_path(lambda path, p, lab: None if lab == "frozen" or path.startswith(dropped) else
                                torch.randn(p.shape, generator=gen, device=dev) * 1e-2, params, labels)
             for _ in range(3)]
    assert any(path.startswith(dropped) for path, lab in tree_leaves_with_path(labels) if lab != "frozen")
    mu, nu = MOMENTS[moments]
    _kernel_vs_loop(params, labels, grads, monkeypatch, weight_decay=weight_decay, mu_dtype=mu, nu_dtype=nu)
