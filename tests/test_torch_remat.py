"""--remat_policy in the port (models/remat.py: each train-mode encoder layer
checkpointed under a policy), on the CPU at tiny sizes:

- (a) under every policy a train step of a tiny conformer and of tiny w2v
  encoders (post-LN and stable-LN; 3 layers, every dropout on at 0.1 with
  replayed seeds, a LayerDrop mask that drops layer 1) gives `none`'s loss,
  new BN state and gradients, bitwise;
- (b) the port's encoder under each policy against the JAX package's
  scanned encoder under the same policy (`scan_layers`: the layers stacked
  by the JAX stacking helpers, remat_layer_fn around the scan body; train
  mode, dropout 0, the plain XLA path): the loss of its output (sum of
  out^2 x w, rel 1e-5) and every gradient leaf (atol 1e-4 + rtol 1e-4, as
  tests/test_torch_train_step.py), and the conformer's new BN stats;
- (c) a checkpointed step draws its dropout seeds and LayerDrop decisions
  from the generators as an unchecked step does: the streams' n_seeds and
  every generator's state after the step are equal;
- (d) the bytes a forward keeps for its backward (remat.counting): every
  policy keeps less than none, min <= dots, dots_nowide <= dots;
- (e) --remat_policy=auto resolves to none on the CPU; on made-up
  footprints (train/steps.py::RematAuto) the steps settle on the first of
  none, blocks, dots_nowide, min whose step fits the budget (min when none
  fits), a step that runs out of memory runs again under the next policy
  and gives none's step, the StepRng drawing once a step, and one that
  does so under min raises;
- (f) two gloo ranks, data parallel (2, 1) and tensor parallel (1, 2), each
  a step of both families under min and all_but_wide, equal to the same
  step under none on that rank, bitwise; and auto moves both ranks on when
  one finds none over the budget;
- (g) a tiny CLI experiment (tests/test_torch_trainer.py's fixture) at
  --remat_policy=blocks and at the default auto write history.json bitwise
  that of --remat_policy=none, and the "parsed and ignored" line no longer
  names the flag.
"""

import functools
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_trainer import env, history, port_run  # noqa: E402,F401

from torch_remat_fixtures import DROPPED, N_LAYERS, FootprintAuto, replayed_rng, tiny_batch, tiny_spec  # noqa: E402

from wav2vec2forbrain_tpu_torch.experiments import impl  # noqa: E402
from wav2vec2forbrain_tpu_torch.models import assembly, remat  # noqa: E402
from wav2vec2forbrain_tpu_torch.models import conformer as port_conformer  # noqa: E402
from wav2vec2forbrain_tpu_torch.models import wav2vec2 as port_w2v  # noqa: E402
from wav2vec2forbrain_tpu_torch.models.seeds import SeedStream, StepRng  # noqa: E402
from wav2vec2forbrain_tpu_torch.train import optim, steps  # noqa: E402
from wav2vec2forbrain_tpu_torch.tree import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402
from torch_jax_prng import jax_threefry  # noqa: E402,F401

torch.set_num_threads(2)
POLICIES = [p for p in remat.POLICIES if p != "none"]
FAMILIES = ("conformer", "w2v", "w2v_stable")


def _step(family, policy, rng):
    """One train step's grad_fn from seeded params: (out, grads)."""
    spec = tiny_spec(family, policy)
    params, state = assembly.init_model_params(torch.Generator().manual_seed(0), spec, "cpu")
    labels = assembly.param_labels(params, "brain_encoder+w2v")
    grad_fn = steps.build_grad_fn(spec, labels, steps.StepConfig(None, 0.0, 0.0))
    out, grads, _ = grad_fn(params, state, tiny_batch(), rng)
    return out, grads


@functools.lru_cache(maxsize=None)
def _none_step(family):
    return _step(family, "none", replayed_rng())


def _assert_bitwise(a_leaves, b_leaves):
    assert len(a_leaves) == len(b_leaves) > 10
    for (path, a), (_, b) in zip(a_leaves, b_leaves):
        assert (a is None) == (b is None), path
        if a is not None:
            assert torch.equal(a, b), path


# --- (a) every policy's step is none's --------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", FAMILIES)
def test_policy_step_is_bitwise_the_none_step(family, policy):
    out, grads = _step(family, policy, replayed_rng())
    ref_out, ref_grads = _none_step(family)
    assert torch.equal(out["loss"], ref_out["loss"])
    _assert_bitwise(tree_leaves_with_path(grads), tree_leaves_with_path(ref_grads))
    assert tree_leaves(out["state"]) or family != "conformer"
    for a, b in zip(tree_leaves(out["state"]), tree_leaves(ref_out["state"])):
        assert torch.equal(a, b)
    # the dropped layer has no gradient and keeps its BN state; the others have both
    layers = grads["w2v"]["encoder"]["layers"]
    assert [layers[i]["final_layer_norm"]["scale"] is None for i in range(N_LAYERS)] == \
        [i == DROPPED for i in range(N_LAYERS)]


# --- (b) against the JAX scanned encoder under the same policy ----------------------------------------------------


ENC_OFF = dict(hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0, final_dropout=0.0, layerdrop=0.0)


def _port_encoder(family):
    """The port's tiny encoder config (dropout 0) and seeded params and state."""
    if family == "conformer":
        cfg = port_conformer.ConformerEncoderConfig.tiny_test(hidden_act="swish", conformer_conv_dropout=0.0,
                                                              **ENC_OFF)
        gen = torch.Generator().manual_seed(0)
        return cfg, port_conformer.init_conformer_encoder_params(gen, cfg, "cpu"), \
            port_conformer.init_conformer_state(cfg, "cpu")
    cfg = port_w2v.Wav2Vec2EncoderConfig.tiny_test(**ENC_OFF)
    return cfg, port_w2v.init_w2v_encoder_params(torch.Generator().manual_seed(0), cfg, "cpu"), {}


def _jax_encoder_case(family, policy, params, state):
    """The JAX scanned encoder under `policy` on (numpy) params and state
    stacked by the JAX helpers: (x, w, loss, per-layer gradients, new state)."""
    import jax
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.models import conformer as jc
    from wav2vec2forbrain_tpu.models import wav2vec2 as jw

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 96)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
    if family == "conformer":
        jcfg = jc.ConformerEncoderConfig.tiny_test(hidden_act="swish", conformer_conv_dropout=0.0, **ENC_OFF)
        stacked, stacked_state = jc.stack_conformer_layers(params, state)

        def loss(p):
            out, new_state = jc.apply_conformer_encoder_scanned(p, stacked_state, jnp.asarray(x), jcfg, None, True,
                                                                jnp.float32, False, policy)
            return jnp.sum(out * out * w), new_state

        (value, new_state), grads = jax.value_and_grad(loss, has_aux=True)(stacked)
        grads, new_state = jc.unstack_conformer_layers(grads, new_state, jcfg.num_hidden_layers)
    else:
        jcfg = jw.Wav2Vec2EncoderConfig.tiny_test(**ENC_OFF)

        def loss(p):
            out = jw.apply_w2v_encoder_scanned(p, jnp.asarray(x), jcfg, None, True, jnp.float32, False, policy)
            return jnp.sum(out * out * w)

        value, grads = jax.value_and_grad(loss)(jw.stack_w2v_layers(params))
        grads, new_state = jw.unstack_w2v_layers(grads, jcfg.num_hidden_layers), {}
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return x, w, float(value), as_np(grads), as_np(new_state)


def _pairs(jax_tree, port_tree, path=""):
    if isinstance(port_tree, dict):
        for k in port_tree:
            yield from _pairs(jax_tree[k], port_tree[k], f"{path}/{k}")
    elif isinstance(port_tree, list):
        for i, v in enumerate(port_tree):
            yield from _pairs(jax_tree[i], v, f"{path}/{i}")
    else:
        yield path, jax_tree, port_tree


@pytest.mark.parametrize("policy", remat.POLICIES)
@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_encoder_matches_the_jax_scanned_encoder_under_the_policy(family, policy):
    cfg, p, s = _port_encoder(family)
    x, w, jax_loss, jax_grads, jax_state = _jax_encoder_case(
        family, policy, *(tree_map(lambda t: t.numpy().copy(), t) for t in (p, s)))
    leaves = [t.requires_grad_() for t in tree_leaves(p)]
    stream = SeedStream(seeds=[])
    if family == "conformer":
        out, new_state = port_conformer.apply_conformer_encoder(p, s, torch.from_numpy(x), cfg, train=True,
                                                                stream=stream, remat_policy=policy)
    else:
        out, new_state = port_w2v.apply_w2v_encoder(p, torch.from_numpy(x), cfg, train=True, stream=stream,
                                                    remat_policy=policy), {}
    loss = (out * out * torch.from_numpy(w)).sum()
    np.testing.assert_allclose(float(loss.detach()), jax_loss, rtol=1e-5)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves, allow_unused=True)))
    n = 0
    for path, jg, pg in _pairs(jax_grads, tree_map(lambda t: grads[id(t)], p)):
        if "pos_conv" in path and family == "conformer":
            continue  # a dead parity param: neither side's forward reaches it
        np.testing.assert_allclose(pg.numpy(), jg, atol=1e-4, rtol=1e-4, err_msg=path)
        n += 1
    assert n >= 20
    for path, js, ps in _pairs(jax_state, new_state):
        np.testing.assert_allclose(ps.numpy(), js, atol=1e-4, rtol=1e-4, err_msg=path)


# --- (c) the streams advance as without remat --------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_streams_advance_as_without_remat(family, policy):
    runs = {}
    for p in ("none", policy):
        rng = StepRng(seed=4, device="cpu")
        _step(family, p, rng)
        fwd = rng.forwards[0]
        runs[p] = ([s.n_seeds for s in fwd], [s.layerdrop_drawn for s in fwd],
                   [s._gen.get_state() for s in fwd], rng._host.get_state(), rng._device.get_state())
    (n_ref, ld_ref, gens_ref, host_ref, dev_ref), (n, ld, gens, host, dev) = runs["none"], runs[policy]
    assert n == n_ref and n_ref[1] > N_LAYERS and ld == ld_ref
    assert all(torch.equal(a, b) for a, b in zip(gens, gens_ref))
    assert torch.equal(host, host_ref) and torch.equal(dev, dev_ref)


# --- (d) what a forward keeps -------------------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_saved_bytes_by_policy(family):
    kept = {}
    for policy in remat.POLICIES:
        with remat.counting() as counter:
            out, grads = _step(family, policy, replayed_rng())
        kept[policy] = counter.total
        assert (counter.inputs > 0 and counter.kept > 0) == (policy != "none")
        del out, grads
    assert all(kept[p] < kept["none"] for p in POLICIES), kept
    assert kept["min"] <= kept["dots"] and kept["dots_nowide"] <= kept["dots"], kept


def test_keeps_follows_the_names():
    mm, bmm, add = torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.add
    assert remat.keeps("min", mm) and not remat.keeps("min", bmm) and remat.keeps("dots", bmm)
    assert not any(remat.keeps(p, add) or remat.keeps(p, torch.ops.aten.empty) for p in remat.POLICIES)
    with remat.named("ffn_wide"):
        assert remat.keeps("dots", mm) and not remat.keeps("dots_nowide", mm) and not remat.keeps("blocks", mm)
    with remat.named("blk"):
        assert remat.keeps("blocks", mm) and remat.keeps("dots_nowide", mm)
    assert not remat.keeps("blocks", mm)
    with pytest.raises(ValueError, match="remat policy"):
        remat.checkpoint_layer(lambda s, x: x, "auto", None, 0, torch.zeros(1))


# --- (e) auto ---------------------------------------------------------------------------------------------------


def test_auto_resolves_to_none_on_the_cpu(capsys):
    exp = SimpleNamespace(device=torch.device("cpu"))
    assert impl.B2TGruW2VExperimentBase._remat_auto(exp) is None
    assert "remat_policy=auto: none" in capsys.readouterr().out


NEEDS = {"none": 100, "blocks": 80, "dots_nowide": 70, "min": 60}


@pytest.mark.parametrize("budget,want", [(100, "none"), (99, "blocks"), (70, "dots_nowide"), (60, "min"),
                                         (59, "min")])
def test_chooser_takes_the_first_policy_that_fits(budget, want):
    auto, batch = FootprintAuto(budget, NEEDS), tiny_batch()
    watched = []
    for _ in range(len(NEEDS) + 1):  # steps at one shape: watched until one fits
        if auto.key(batch) not in auto.fitted:
            watched.append(auto.policy)
            assert auto.settle(batch, True) is False  # a step that ran is never run again
    assert auto.policy == want and auto.key(batch) in auto.fitted and auto.frees == 0
    assert watched == list(remat.AUTO_CANDIDATES[: remat.AUTO_CANDIDATES.index(want) + 1])
    # a wider batch is watched again
    assert auto.key(tiny_batch(rows=4)) not in auto.fitted


def _auto_steps(monkeypatch, auto, n_oom, replay):
    """Two train steps of the tiny conformer through build_train_step with
    `auto`; the first n_oom steps run run out of memory at the encoder's
    second layer (the StepRng has drawn the step's forward streams, its
    noise, the GRU's seeds, the LayerDrop mask and layer 0's seeds).
    (losses, params, the StepRng, the policies the steps ran)."""
    layer = remat.checkpoint_layer
    runs, calls = [], []

    def failing_layer(fn, policy, *args):
        calls.append(policy)
        if len(runs) <= n_oom and calls.count(policy) == 2:
            raise torch.OutOfMemoryError("made up")
        return layer(fn, policy, *args)

    monkeypatch.setattr(remat, "checkpoint_layer", failing_layer)
    build = steps.build_grad_fn

    def counting_build(spec, *args, **kwargs):
        fn = build(spec, *args, **kwargs)

        def grad_fn(*a, **k):
            runs.append(spec.remat_policy)
            calls.clear()
            return fn(*a, **k)

        return grad_fn

    monkeypatch.setattr(steps, "build_grad_fn", counting_build)
    spec = tiny_spec("conformer")
    params, state = assembly.init_model_params(torch.Generator().manual_seed(0), spec, "cpu")
    labels = assembly.param_labels(params, "brain_encoder+w2v")
    optimizer = optim.make_optimizer(labels, "adam", 0.0)
    opt_state = optimizer.init(params)
    step = steps.build_train_step(spec, labels, optimizer, steps.StepConfig(None, 0.02, 0.25), auto=auto)
    rng = replayed_rng(steps=2) if replay else StepRng(5, "cpu")
    losses = []
    for _ in range(2):
        out = step(params, opt_state, state, tiny_batch(), rng, 1e-3, 1e-4)
        opt_state, state = out.opt_state, out.model_state
        losses.append(out.loss)
    return losses, params, rng, runs


@pytest.mark.parametrize("replay", [False, True], ids=["generators", "replay"])
def test_auto_runs_a_step_that_ran_out_of_memory_again(monkeypatch, replay):
    ref_losses, ref_params, ref_rng, _ = _auto_steps(monkeypatch, None, 0, replay)
    auto = FootprintAuto(100, NEEDS)
    losses, params, rng, runs = _auto_steps(monkeypatch, auto, 2, replay)
    # none and blocks ran out of memory; dots_nowide ran the first step again and the second
    assert runs == ["none", "blocks", "dots_nowide", "dots_nowide"] and auto.policy == "dots_nowide"
    assert auto.frees == 2
    assert all(torch.equal(a, b) for a, b in zip(losses, ref_losses))
    _assert_bitwise(tree_leaves_with_path(params), tree_leaves_with_path(ref_params))
    # the rewound source drew what one step draws, a step
    assert len(rng.forwards) == len(ref_rng.forwards) == 2
    assert torch.equal(rng._host.get_state(), ref_rng._host.get_state())
    assert torch.equal(rng._device.get_state(), ref_rng._device.get_state())
    for fr, ref_fr in zip(rng.forwards, ref_rng.forwards):
        for s, ref_s in zip(fr, ref_fr):
            assert s.n_seeds == ref_s.n_seeds > 0 and s.layerdrop_drawn == ref_s.layerdrop_drawn
            if s._gen is not None:
                assert torch.equal(s._gen.get_state(), ref_s._gen.get_state())


def test_auto_raises_when_the_last_policy_runs_out_of_memory(monkeypatch):
    with pytest.raises(torch.OutOfMemoryError, match="the last candidate"):
        _auto_steps(monkeypatch, FootprintAuto(100, NEEDS), len(remat.AUTO_CANDIDATES), False)


# --- (f) data and tensor parallel ranks --------------------------------------------------------------------------

CHILD = r"""
import sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, port, mesh, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
sys.path.insert(0, sys.argv[5])
from torch_remat_fixtures import FootprintAuto, replayed_rng, tiny_batch, tiny_spec
from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch
from wav2vec2forbrain_tpu_torch.models import assembly
from wav2vec2forbrain_tpu_torch.parallel.mesh import make_mesh
from wav2vec2forbrain_tpu_torch.parallel.tensor import gather_tree, split_tree
from wav2vec2forbrain_tpu_torch.train import steps
from wav2vec2forbrain_tpu_torch.tree import tree_leaves

shard = make_mesh(*(2, 1) if mesh == "dp" else (1, 2))
tp = shard.model
batch = tiny_batch(rows=4)  # 3 trials and a padding row: 2 rows a data-parallel rank
local = B2tBatch(*(None if a is None else a[shard.rows(4)] for a in batch))
res = {}
for family in ("conformer", "w2v"):
    for policy in ("none", "min", "all_but_wide"):
        spec = tiny_spec(family, policy)
        params, state = assembly.init_model_params(torch.Generator().manual_seed(0), spec, "cpu")
        labels = assembly.param_labels(params, "brain_encoder+w2v")
        grad_fn = steps.build_grad_fn(spec, labels, steps.StepConfig(None, 0.0, 0.0), shard)
        o, grads, norm = grad_fn(split_tree(params, tp), state, local, replayed_rng(), 4.0)
        res[(family, policy)] = [o["loss"].detach(), *tree_leaves(o["state"]),
                                 *[g for g in tree_leaves(gather_tree(grads, tp)) if g is not None]]
same = {k: all(torch.equal(a, b) for a, b in zip(v, res[(k[0], "none")])) for k, v in res.items()}
# --remat_policy=auto: rank 1 alone finds none over the budget, and both ranks move on
auto = FootprintAuto(90, {"none": 100 if rank == 1 else 50, "blocks": 60, "dots_nowide": 60, "min": 60})
auto.settle(local, True)
torch.save(dict(same=same, n=len(res[("conformer", "none")]), auto=auto.policy), out.format(rank))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def parallel_steps(tmp_path_factory):
    """{mesh: [each rank's results]}: the (2, 1) and (1, 2) groups run at once."""
    from test_torch_parallel import start_ranks, wait_ranks

    groups = {}
    for mesh in ("dp", "tp"):
        tmp = tmp_path_factory.mktemp(mesh)
        groups[mesh] = (tmp, start_ranks(CHILD, [mesh, tmp / "rank{}.pt", os.path.dirname(__file__)], tmp_path=tmp))
    for tmp, ranks in groups.values():
        wait_ranks(ranks, timeout=240)
    return {mesh: [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
            for mesh, (tmp, _) in groups.items()}


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_parallel_steps_under_a_policy_equal_none(parallel_steps, mesh):
    for got in parallel_steps[mesh]:
        assert got["n"] > 20 and len(got["same"]) == 6 and all(got["same"].values()), got["same"]
        assert got["auto"] == "blocks"


# --- (g) the CLI ------------------------------------------------------------------------------------------------


def test_cli_history_under_a_policy_is_none_s(env, capsys):  # noqa: F811
    runs = {}
    for policy in ("none", "blocks", "auto"):
        capsys.readouterr()
        exp = port_run(env, "conformer", results_subdir_name=f"remat_{policy}", epochs=1, remat_policy=policy)
        out = capsys.readouterr().out
        ignored = [line for line in out.splitlines() if "parsed and ignored" in line]
        assert len(ignored) == 1 and "remat_policy" not in ignored[0] and "--scan_layers" in ignored[0]
        assert exp.spec.remat_policy == ("none" if policy == "auto" else policy) and exp.remat_auto is None
        assert ("remat_policy=auto: none" in out) == (policy == "auto")
        runs[policy] = history(exp)
    assert runs["blocks"] == runs["none"] == runs["auto"]
    assert len(runs["none"]["epochs"]) == 1
