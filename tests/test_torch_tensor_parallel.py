"""The port's tensor parallelism (parallel/tensor.py, --mesh_model_parallel)
against the JAX package's Megatron split on a ('data', 'model') mesh, on the
CPU:

- masks, bit for bit, at no ranks: `hash_uniform` / `hash_dropout` at a
  last-dim offset are that slice of the JAX `hash_dropout._uniform` over
  the whole shape (and of the port's own whole mask); `hash_keep_mask` at
  `head0` is those heads of the JAX `xla_attention.hash_keep_mask`; the
  plain attention forward and backward at `head0` are those heads of the
  whole computation;
- the layout: the split dim of every leaf of both families' params, per
  layer and scan-stacked, equals the JAX `param_pspec`'s 'model' dim on a
  (1, 2) mesh, and the ZeRO-1 dim under a model axis equals `zero1_pspec`'s
  'data' dim on a (2, 2) mesh;
- one train step on (1, 2) and (2, 2) ranks (gloo subprocesses with a time
  limit, as tests/test_torch_parallel.py runs them) for both families (one
  tiny_test layer, biGRU 1 x 32, every dropout on at 0.1, the seeds replayed
  from the JAX key chain), against the
  JAX step on the same mesh of conftest's virtual devices from bridged
  weights (use_pallas=False): the loss (rel 1e-5), every gradient gathered
  over the model group and the new BN stats (atol 1e-4 + rtol 1e-4), the
  params after Adam (atol 2e-5; eps 1e-4), gradient clipping on in the
  (1, 2) w2v case; the (2, 2) cases under ZeRO-1, each rank holding
  its data index's half of its model piece of every split moment leaf;
- a `cuda` test (skips without a card): each attention kernel at head0
  against its plain version and the whole call's heads.

jax is imported inside the CPU tests, so the `cuda` test runs on a card
with --noconftest.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu_torch.ops import attention as port_attn
from wav2vec2forbrain_tpu_torch.ops.hash_dropout import hash_dropout, hash_keep_mask, hash_uniform
from wav2vec2forbrain_tpu_torch.parallel import tensor
from wav2vec2forbrain_tpu_torch.parallel.zero import zero1_dim
from wav2vec2forbrain_tpu_torch.tree import tree_map_with_path
from torch_jax_prng import jax_threefry  # noqa: F401

torch.set_num_threads(2)
BRAIN_LR, W2V_LR, EPS = 1e-3, 1e-4, 1e-4
CHILD_TIMEOUT = 240
W2V_ENC = dict(num_hidden_layers=1, layerdrop=0.0)  # every dropout of tiny_test on (0.1)
ENC = dict(W2V_ENC, hidden_act="swish")

# one rank of a gloo group of `world` ranks at (world // 2, 2): for each case
# the port's train step on its pieces and its rows, the gathered results
CHILD = r"""
import sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, port, world, inputs, out = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)

from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch, to_device
from wav2vec2forbrain_tpu_torch.models import assembly
from wav2vec2forbrain_tpu_torch.models.seeds import ForwardRng, SeedStream, StepRng
from wav2vec2forbrain_tpu_torch.parallel.mesh import make_mesh
from wav2vec2forbrain_tpu_torch.parallel.tensor import gather_tree, split_tree
from wav2vec2forbrain_tpu_torch.parallel.zero import Zero1
from wav2vec2forbrain_tpu_torch.train import optim, steps
from wav2vec2forbrain_tpu_torch.tree import tree_map

shard = make_mesh(0, 2)
assert shard.model.size == 2 and shard.size == world // 2
assert (shard.rank, shard.model.rank) == divmod(rank, 2)
res = {}
for name, case in torch.load(inputs, weights_only=False).items():
    if case["world"] != world:
        continue
    spec, labels = case["spec"], assembly.param_labels(case["params"], "brain_encoder+w2v")
    tp = shard.model
    params = split_tree(tree_map(lambda t: t.clone(), case["params"]), tp)
    state = tree_map(lambda t: t.clone(), case["state"])
    zero = Zero1(shard) if case["zero1"] else None
    opt = optim.make_optimizer(labels, "adam", 0.0, case["eps"], zero=zero)
    opt_state = opt.init(params)
    cfg = steps.StepConfig(case["clip"], 0.0, 0.0)
    replay = ForwardRng(*(SeedStream(seeds=seeds, layerdrop=ld) for seeds, ld in case["replay"]))
    rows = shard.rows(case["batch"].input.shape[0])
    batch = to_device(B2tBatch(*(None if a is None else a[rows] for a in case["batch"])), "cpu")
    grad_fn = steps.build_grad_fn(spec, labels, cfg, shard)
    o, grads, norm = grad_fn(params, state, batch, StepRng(device="cpu", replay=[replay]),
                             float(case["batch"].input.shape[0]))
    opt.step(params, grads, opt_state, *case["lrs"])
    res[name] = dict(loss=float(o["loss"].detach()), norm=float(norm), state=o["state"],
                     grads=gather_tree(grads, tp), params=gather_tree(tree_map(lambda t: t.detach(), params), tp),
                     local_q=tuple(params["w2v"]["encoder"]["layers"][0][case["q"][0]][case["q"][1]]["kernel"].shape),
                     mu=opt_state.mu, row0=replay.enc.row0)
torch.save(res, out.format(rank))
dist.destroy_process_group()
"""

# (family, world): the (1, 2) w2v case clips its gradients, the (2, 2) cases keep ZeRO-1 moments
CASES = {
    "conformer_1x2": dict(family="conformer", world=2, clip=None, zero1=False),
    "w2v_1x2": dict(family="w2v", world=2, clip=0.5, zero1=False),
    "conformer_2x2": dict(family="conformer", world=4, clip=None, zero1=True),
    "w2v_2x2": dict(family="w2v", world=4, clip=None, zero1=True),
}


# --- masks at a column offset and at head0 ---------------------------------------------


@pytest.mark.parametrize("shape,row0,col0,n", [((4, 5, 12), 1, 6, 6), ((2, 3, 16), 0, 4, 4), ((3, 8), 1, 2, 4)])
def test_hash_masks_at_a_column_offset_are_slices_of_the_jax_mask(shape, row0, col0, n):
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops.hash_dropout import _uniform as jax_uniform

    rows = shape[0] - row0
    part = hash_uniform((rows, *shape[1:-1], n), 4321, row0=row0, col0=col0)
    whole = np.asarray(jax_uniform(shape, jnp.int32(4321)))
    np.testing.assert_array_equal(part.numpy(), whole[row0:, ..., col0:col0 + n])
    np.testing.assert_array_equal(hash_uniform(shape, 4321, row0=0, col0=0).numpy(), whole)
    x = torch.randn(shape)
    sl = (slice(row0, None), *([slice(None)] * (len(shape) - 2)), slice(col0, col0 + n))
    assert torch.equal(hash_dropout(x[sl], 99, 0.3, row0, col0), hash_dropout(x, 99, 0.3)[sl])
    assert not torch.equal(hash_dropout(x[sl], 99, 0.3, row0), hash_dropout(x, 99, 0.3)[sl])  # the offset counts


@pytest.mark.parametrize("heads,head0,row0", [(2, 2, 0), (1, 3, 2), (4, 0, 1)])
def test_attention_masks_and_plain_versions_at_head0(heads, head0, row0):
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops.xla_attention import hash_keep_mask as jax_keep_mask

    b, h, t, d = 4, 4, 5, 8
    rows = b - row0
    part = hash_keep_mask(77, (rows, heads, t, t), 0.9, row0=row0, head0=head0)
    whole = np.asarray(jax_keep_mask(jnp.int32(77), (b, h, t, t), 0.9))
    np.testing.assert_array_equal(part.numpy(), whole[row0:, head0:head0 + heads])
    np.testing.assert_array_equal(hash_keep_mask(77, (b, h, t, t), 0.9, row0=0, head0=0).numpy(), whole)
    g = torch.Generator().manual_seed(heads + head0)
    q, k, v, go = (torch.randn((b, t, h * d), generator=g) for _ in range(4))
    args = (0.3, 0.1, torch.float32, 77)
    cols = slice(head0 * d, (head0 + heads) * d)
    sl = (slice(row0, None), slice(None), cols)
    full = [port_attn.mha_dense_bth(q, k, v, h, *args), *port_attn.mha_bwd_plain(q, k, v, go, h, *args)]
    mine = [port_attn.mha_dense_bth(q[sl], k[sl], v[sl], heads, *args, row0=row0, head0=head0),
            *port_attn.mha_bwd_plain(q[sl], k[sl], v[sl], go[sl], heads, *args, row0=row0, head0=head0)]
    for a, m in zip(full, mine):
        np.testing.assert_allclose(m.numpy(), a[sl].numpy(), rtol=1e-6, atol=1e-7)
    if head0:  # the offset changes the mask
        assert not torch.equal(port_attn.mha_dense_bth(q[sl], k[sl], v[sl], heads, *args, row0=row0), mine[0])


# --- the layout against param_pspec and zero1_pspec -------------------------------------------


def _jax_spec(family):
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.models import assembly as jax_assembly
    from wav2vec2forbrain_tpu.models.conformer import ConformerEncoderConfig as JaxConformerConfig
    from wav2vec2forbrain_tpu.models.wav2vec2 import Wav2Vec2EncoderConfig as JaxW2VConfig

    if family == "conformer":
        return jax_assembly.ModelSpec(gru_hidden_size=32, latent_size=96, encoder_family="conformer", gru_num_layers=1,
                                      conformer_cfg=JaxConformerConfig.tiny_test(**ENC),
                                      compute_dtype=jnp.float32, use_pallas=False)
    return jax_assembly.ModelSpec(gru_hidden_size=32, latent_size=96, encoder_family="wav2vec2", gru_num_layers=1,
                                  w2v_cfg=JaxW2VConfig.tiny_test(**W2V_ENC), compute_dtype=jnp.float32,
                                  use_pallas=False)


def _port_spec(family):
    from wav2vec2forbrain_tpu_torch.models import assembly as port_assembly
    from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
    from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig

    if family == "conformer":
        return port_assembly.ModelSpec(gru_hidden_size=32, latent_size=96, gru_num_layers=1,
                                       conformer_cfg=ConformerEncoderConfig.tiny_test(**ENC))
    return port_assembly.ModelSpec(gru_hidden_size=32, latent_size=96, gru_num_layers=1, encoder_family="wav2vec2",
                                   w2v_cfg=Wav2Vec2EncoderConfig.tiny_test(**W2V_ENC))


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def _jax_setup(family):
    """The JAX model (numpy), its trainable / frozen split and Adam."""
    import jax

    from wav2vec2forbrain_tpu.models import assembly as jax_assembly
    from wav2vec2forbrain_tpu.train import steps as jax_steps
    from wav2vec2forbrain_tpu.train.optim import make_optimizer as jax_make_optimizer

    jspec = _jax_spec(family)
    params, state = jax_assembly.init_model_params(jax.random.PRNGKey(7), jspec)
    labels = jax_assembly.param_labels(params, "brain_encoder+w2v")
    trainable, frozen = jax_steps.partition_params(params, labels)
    tlabels = jax_steps.prune_labels(labels, trainable)
    tx = jax_make_optimizer(tlabels, "adam", 0.0, EPS)
    return dict(jspec=jspec, params=_np(params), state=_np(state), trainable=trainable, frozen=frozen,
                tlabels=tlabels, tx=tx, opt_state=tx.init(trainable))


def _port_path(jax_path) -> str:
    from wav2vec2forbrain_tpu.parallel.mesh import _path_str

    return "/" + _path_str(jax_path).replace(".", "/")


def _model_dim(spec):
    spec = tuple(spec)
    return spec.index("model") if "model" in spec else None


@pytest.mark.parametrize("layout", ["per_layer", "stacked"])
@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_layout_matches_jax_param_pspec(family, layout):
    import jax

    from wav2vec2forbrain_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from wav2vec2forbrain_tpu.parallel.mesh import param_shardings
    from wav2vec2forbrain_tpu_torch import bridge

    env = _jax_setup(family)
    params = env["params"]
    if layout == "stacked":
        params = bridge.stack_encoder(params, env["state"])[0]
        assert "layers_stacked" in params["w2v"]["encoder"]
    mesh = jax_make_mesh(1, 2)
    shardings = param_shardings(params, mesh)
    n_split = 0
    for (path, leaf), sh in zip(jax.tree_util.tree_leaves_with_path(params), jax.tree_util.tree_leaves(shardings)):
        want = _model_dim(sh.spec)
        assert tensor.split_dim(_port_path(path), leaf.ndim) == want, (jax.tree_util.keystr(path), sh.spec)
        n_split += want is not None
    # one layer (stacked: a leading layer dim of 1): q, k, v kernels and biases, out; each FFN's three
    assert n_split == (13 if family == "conformer" else 10)
    # the port's own trees: the same dims through tree.py's paths, and pieces that tile the whole
    tp_params = bridge.params_from_jax(env["params"], env["state"], device="cpu")[0]
    pieces = [tensor.split_tree(tp_params, tensor.TensorShard(m, 2, None)) for m in range(2)]

    def tiles(path, whole, d, p0, p1):
        if d is None:
            assert p0 is whole and p1 is whole, path
        else:
            assert torch.equal(torch.cat([p0, p1], d), whole), path

    tree_map_with_path(tiles, tp_params, tensor.split_dims(tp_params), *pieces)


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_zero1_dim_under_a_model_axis_matches_jax_zero1_pspec(family):
    import jax

    from wav2vec2forbrain_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from wav2vec2forbrain_tpu.parallel.zero import zero1_pspec

    env = _jax_setup(family)
    mesh = jax_make_mesh(2, 2)
    n_model = n_both = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(env["opt_state"]):
        spec = tuple(zero1_pspec(path, leaf, mesh))
        want = spec.index("data") if "data" in spec else None
        model_dim = tensor.split_dim(_port_path(path), leaf.ndim)
        assert model_dim == _model_dim(spec), (jax.tree_util.keystr(path), spec)
        assert zero1_dim(leaf.shape, 2, model_dim) == want, (jax.tree_util.keystr(path), leaf.shape, spec)
        n_model += model_dim is not None
        n_both += model_dim is not None and want is not None
    # mu and nu of one layer's split leaves; a column-split bias has no dim left for 'data', a kernel has
    assert (n_model, n_both) == ((26, 16) if family == "conformer" else (20, 12))


def test_layout_refuses_a_model_axis_that_does_not_divide_the_heads():
    tensor.check_divides(2, 4, 128)
    tensor.check_divides(1, 3, 7)
    with pytest.raises(ValueError, match="--mesh_model_parallel=3 .* 4 attention heads"):
        tensor.check_divides(3, 4, 128)
    with pytest.raises(ValueError, match="intermediate size 129"):
        tensor.check_divides(2, 4, 129)


# --- one train step on (1, 2) and (2, 2) ranks against the JAX step on that mesh ---------------------


def _host_batch():
    from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch
    from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer

    rng = np.random.default_rng(1)
    b, t = 4, 60
    lens = np.array([60, 56, 52, 48], np.int32)
    x = rng.standard_normal((b, t, 256)).astype(np.float32)
    x[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    tok = Wav2Vec2CTCTokenizer()
    ids = [tok.encode(s) for s in ("HI", "A", "GO", "OK")]
    target = np.zeros((b, max(len(i) for i in ids)), np.int32)
    for i, seq in enumerate(ids):
        target[i, : len(seq)] = seq
    return B2tBatch(x, target, np.array([0, 5, 5, 2], np.int32), lens, np.array([len(i) for i in ids], np.int32),
                    np.ones((b,), np.float32))


def _k_model():
    import jax

    return jax.random.split(jax.random.PRNGKey(11), 4)[3]


def _replay(family):
    if family == "conformer":
        from test_torch_train_step import jax_seed_streams as streams
    else:
        from test_torch_w2v_train_step import jax_w2v_seed_streams as streams
    return streams(_k_model(), _jax_setup(family)["jspec"])


def _jax_tp_step(name):
    """The JAX step on the case's (dp, 2) mesh: the trainable and frozen
    params by param_shardings, the batch over 'data'; with the loss,
    gradients (clipped where the case clips) and BN stats of the step's
    forward."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from wav2vec2forbrain_tpu.models import assembly as jax_assembly
    from wav2vec2forbrain_tpu.parallel.mesh import batch_sharding, make_mesh as jax_make_mesh
    from wav2vec2forbrain_tpu.parallel.mesh import param_shardings
    from wav2vec2forbrain_tpu.train import steps as jax_steps

    case = CASES[name]
    env = _jax_setup(case["family"])
    jspec, tlabels, tx, clip = env["jspec"], env["tlabels"], env["tx"], case["clip"]
    mesh = jax_make_mesh(case["world"] // 2, 2)
    rep = NamedSharding(mesh, PartitionSpec())
    trainable = jax.device_put(env["trainable"], param_shardings(env["trainable"], mesh))
    frozen = jax.device_put(env["frozen"], param_shardings(env["frozen"], mesh))
    state, opt_state = (jax.device_put(t, rep) for t in (env["state"], env["opt_state"]))
    jbatch = jax.tree_util.tree_map(lambda a: jax.device_put(jnp.asarray(a), batch_sharding(mesh)), _host_batch())
    k_model = _k_model()

    def loss_fn(t, f, model_state):  # the step's forward: its model key
        out = jax_assembly.forward_with_loss(
            jax_steps.merge_params(t, f), model_state, jspec, jbatch.input, jbatch.day_idxs, jbatch.input_lens,
            jbatch.target, jbatch.target_lens, k_model, train=True, sample_mask=jbatch.sample_mask,
        )
        return out["loss"], out["state"]

    argnums = (0, 1) if clip is not None else 0
    step = jax_steps.build_step_fns(jspec, tlabels, tx, jax_steps.StepConfig(clip, 0.0, 0.0))[0]

    def both(t, f, o, s, rng):  # the step's gradients and the step, in one program
        return jax.value_and_grad(loss_fn, argnums=argnums, has_aux=True)(t, f, s), step(
            t, f, o, s, jbatch, rng, jnp.float32(BRAIN_LR), jnp.float32(W2V_LR))

    ((loss, new_state), grads), out = jax.jit(both)(trainable, frozen, opt_state, state,
                                                    jax.device_put(jax.random.PRNGKey(11), rep))
    if clip is not None:
        grads = jax_steps.merge_params(*jax_steps.clip_by_global_norm_pair(*grads, clip))
    else:
        grads = jax_steps.merge_params(grads, jax.tree_util.tree_map(lambda a: None, frozen))
    np.testing.assert_allclose(float(out.loss), float(loss), rtol=1e-6)
    return dict(loss=float(loss), grads=_np(grads), state=_np(new_state),
                params=_np(jax_steps.merge_params(out.params, frozen)))


@pytest.fixture(scope="module")
def tp_steps(tmp_path_factory):
    """Every case's ranks (a 2-rank and a 4-rank group, run while the JAX
    steps compile) and the JAX steps."""
    from test_torch_parallel import start_ranks, wait_ranks
    from wav2vec2forbrain_tpu_torch import bridge

    tmp = tmp_path_factory.mktemp("tp_step")
    inputs = {}
    for name, case in CASES.items():
        env = _jax_setup(case["family"])
        tp, ts = bridge.params_from_jax(env["params"], env["state"], device="cpu")
        fwd = _replay(case["family"])
        q = ("self_attn", "linear_q") if case["family"] == "conformer" else ("attention", "q_proj")
        inputs[name] = dict(case, spec=_port_spec(case["family"]), params=tp, state=ts, batch=_host_batch(),
                            eps=EPS, lrs=(BRAIN_LR, W2V_LR), replay=[(s._seeds, s._layerdrop) for s in fwd], q=q)
    torch.save(inputs, tmp / "inputs.pt")
    procs = []
    for world in (2, 4):
        sub = tmp / f"w{world}"
        sub.mkdir()
        procs.append(start_ranks(CHILD, [world, tmp / "inputs.pt", sub / "rank{}.pt"], tmp_path=sub, n=world))
    try:
        with ThreadPoolExecutor(len(CASES)) as pool:  # XLA compiles the four programs side by side
            ref = dict(zip(CASES, pool.map(_jax_tp_step, list(CASES))))
    finally:
        for p in procs:
            wait_ranks(p, timeout=CHILD_TIMEOUT)
    got = {}
    for world in (2, 4):
        ranks = [torch.load(str(tmp / f"w{world}" / f"rank{r}.pt"), weights_only=False) for r in range(world)]
        for name in ranks[0]:
            got[name] = [rk[name] for rk in ranks]
    return dict(got=got, jax=ref, inputs=inputs)


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_parallel_step_matches_the_jax_step_on_its_mesh(tp_steps, name):
    from test_torch_train_step import _pairs

    case, jx, ranks = CASES[name], tp_steps["jax"][name], tp_steps["got"][name]
    for r, pt in enumerate(ranks):
        assert pt["row0"] == (r // 2) * (4 // (case["world"] // 2))  # the data index's rows of 4
        assert pt["local_q"] == (96, 48)  # 2 of the 4 heads of 24
        np.testing.assert_allclose(pt["loss"], jx["loss"], rtol=1e-5)
        n_grads = n_split = 0
        for path, jg, pg in _pairs(jx["grads"], pt["grads"]):
            if jg is None:
                assert pg is None or not torch.any(pg), path
                continue
            got = np.zeros_like(jg) if pg is None else pg.numpy()
            np.testing.assert_allclose(got, jg, atol=1e-4, rtol=1e-4, err_msg=path)
            n_grads += 1
            n_split += tensor.split_dim(path, jg.ndim) is not None and pg is not None
        assert n_grads >= 20 and n_split >= 7
        for path, js, ps in _pairs(jx["state"], pt["state"]):
            np.testing.assert_allclose(ps.numpy(), js, atol=1e-4, rtol=1e-4, err_msg=path)
        for path, jp, pp in _pairs(jx["params"], pt["params"]):
            np.testing.assert_allclose(pp.numpy(), jp, atol=2e-5, rtol=0, err_msg=path)


@pytest.mark.parametrize("name", ["conformer_2x2", "w2v_2x2"])
def test_zero1_under_a_model_axis_keeps_a_quarter_of_every_leaf_split_twice(tp_steps, name):
    from test_torch_train_step import _pairs

    whole = tp_steps["inputs"][name]["params"]
    for r, pt in enumerate(tp_steps["got"][name]):
        d, m = divmod(r, 2)
        n_twice = 0
        for path, w, mu in _pairs(whole, pt["mu"]):
            if mu is None:
                continue
            md = tensor.split_dim(path, w.dim())
            local = list(w.shape)
            if md is not None:
                local[md] //= 2
            zd = zero1_dim(local, 2, md)
            want = list(local)
            if zd is not None:
                want[zd] //= 2
            assert list(mu.shape) == want, path
            n_twice += md is not None and zd is not None
            if md is not None and zd is not None:
                assert mu.numel() * 4 == w.numel(), path
        assert n_twice == (8 if name.startswith("conformer") else 6)  # the layer's kernels


def test_ranks_of_a_model_group_agree(tp_steps):
    """Every rank holds the same gathered params and the same loss."""
    from test_torch_train_step import _pairs

    for name, ranks in tp_steps["got"].items():
        for pt in ranks[1:]:
            assert pt["loss"] == ranks[0]["loss"], name
            for (path, _, a), (_, _, b) in zip(_pairs(None, ranks[0]["params"]), _pairs(None, pt["params"])):
                assert torch.equal(a, b), (name, path)


# --- the kernels at head0, on a card -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("sd,cd", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.bfloat16)], ids=["f32", "f32_bf16cd", "bf16"])
@pytest.mark.parametrize("head0", [0, 8])
def test_cuda_attention_at_head0_matches_plain(sd, cd, head0):
    """A tensor-parallel rank's call: heads [head0, head0 + 8) of 16 (64
    wide), B 16, T' 89, dropout 0.1, forward and backward (both tensor-core
    routes), against the plain versions at the same head0 (the f32
    tolerances, 2 bf16 ulps at bf16), and bitwise the whole call's heads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(head0 + 1)
    q, k, v, go = (torch.randn((16, 89, 1024), generator=g, device=dev).to(sd) for _ in range(4))
    cols = slice(head0 * 64, (head0 + 8) * 64)
    ql, kl, vl, gl = (t[:, :, cols].contiguous() for t in (q, k, v, go))
    args = (0.125, 0.1, cd, 13)
    mine = [port_attn._fwd_kernel(ql, kl, vl, 8, *args, head0=head0),
            *port_attn._bwd_kernel(ql, kl, vl, gl, 8, *args, head0=head0)]
    plain = [port_attn.mha_dense_bth(ql, kl, vl, 8, *args, head0=head0),
             *port_attn.mha_bwd_plain(ql, kl, vl, gl, 8, *args, head0=head0)]
    whole = [port_attn._fwd_kernel(q, k, v, 16, *args), *port_attn._bwd_kernel(q, k, v, go, 16, *args)]
    for i, (m, p, w) in enumerate(zip(mine, plain, whole)):
        if cd == torch.float32 and sd == torch.float32:
            atol = 2e-5 * (1.0 if i == 0 else max(1.0, p.float().abs().max().item()))
        else:
            atol = 2.0**-6 * max(1.0, p.float().abs().max().item())
        torch.testing.assert_close(m.float(), p.float(), atol=atol, rtol=0)
        assert torch.equal(m, w[:, :, cols]), i
    if head0:
        assert not torch.equal(port_attn._fwd_kernel(ql, kl, vl, 8, *args), mine[0])  # head0 0: other masks
