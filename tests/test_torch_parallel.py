"""The port's data-parallel pieces against the JAX package, on the CPU over
two gloo ranks (subprocesses with a time limit, as tests/test_multihost.py
runs its children):

- row-offset masks: hash dropout and the attention mask at rows [row0,
  row0 + B) equal those rows of the whole batch's mask, bit for bit, and
  the JAX package's global masks; the plain attention forward and backward
  at row0 equal the whole batch's rows;
- BatchNorm over the global batch: two ranks' `_batch_norm` (output, new
  running stats, gradients of x, scale and bias) against the JAX
  `_batch_norm` over the whole batch, pad rows included;
- the ZeRO-1 layout (`zero1_dim`) against JAX `zero1_pspec` on the same
  Adam-moment leaves;
- one 2-rank conformer train step (tiny_test, biGRU 2 x 64, dropout 0.1,
  LayerDrop 0.5 replayed from the JAX key chain, a ragged batch of 3 padded
  to 4 by `Trainer._place`) against the JAX step on a ('data', 'model') =
  (2, 1) mesh of conftest's virtual devices from bridged weights, the Adam
  moments replicated and ZeRO-1 (each side its own layout): loss (rel 1e-5),
  every gradient leaf and the new BN stats (atol 1e-4 + rtol 1e-4: f32
  sums in another order), the params after Adam (atol 2e-5; eps 1e-4 as in
  tests/test_torch_train_step.py); under ZeRO-1 each rank holds 1/2 of every
  split moment leaf;
- the same step with the augmentation noise on, 2 ranks against one process
  of the port (loss rel 1e-5, gradients and BN stats 1e-5 + 1e-5);
- a model axis that does not divide the world size still raises (a
  ValueError; tensor parallelism itself is tests/test_torch_tensor_parallel.py's).

The JAX side runs its plain XLA versions of the kernels (use_pallas=False),
as its CPU tests may.
"""

import functools
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import _pairs, jax_seed_streams
from wav2vec2forbrain_tpu.models import assembly as jax_assembly
from wav2vec2forbrain_tpu.models.conformer import ConformerEncoderConfig as JaxConformerConfig
from wav2vec2forbrain_tpu.models.conformer import _batch_norm as jax_batch_norm
from wav2vec2forbrain_tpu.ops.hash_dropout import _uniform as jax_uniform
from wav2vec2forbrain_tpu.ops.xla_attention import hash_keep_mask as jax_keep_mask
from wav2vec2forbrain_tpu.parallel.mesh import batch_sharding, make_mesh as jax_make_mesh
from wav2vec2forbrain_tpu.parallel.zero import opt_state_shardings, zero1_pspec
from wav2vec2forbrain_tpu.train import steps as jax_steps
from wav2vec2forbrain_tpu.train.optim import make_optimizer as jax_make_optimizer
from wav2vec2forbrain_tpu.train.train_loop import _pad_batch
from wav2vec2forbrain_tpu_torch import bridge
from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer
from wav2vec2forbrain_tpu_torch.models import assembly as port_assembly
from wav2vec2forbrain_tpu_torch.ops import attention as port_attn
from wav2vec2forbrain_tpu_torch.ops.hash_dropout import hash_dropout, hash_keep_mask, hash_uniform
from wav2vec2forbrain_tpu_torch.parallel.mesh import make_mesh
from wav2vec2forbrain_tpu_torch.parallel.zero import zero1_dim
from torch_jax_prng import jax_threefry  # noqa: F401

torch.set_num_threads(2)
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(TESTS_DIR)
BRAIN_LR, W2V_LR, EPS = 1e-3, 1e-4, 1e-4
CHILD_TIMEOUT = 240
BN_SHAPE = (4, 8, 6)  # B, T, C of the BatchNorm check

# one rank of the gloo group: the BatchNorm check, then the train step
# replicated, under ZeRO-1 and with the noise on; writes its results
CHILD = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, port, inputs, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4].format(int(sys.argv[1]))
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)

from types import SimpleNamespace
from wav2vec2forbrain_tpu_torch.args.flags import B2TGruAndW2VConformerArgsModel, validate
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer
from wav2vec2forbrain_tpu_torch.models import assembly
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig, _batch_norm
from wav2vec2forbrain_tpu_torch.models.seeds import ForwardRng, SeedStream, StepRng
from wav2vec2forbrain_tpu_torch.parallel import distributed
from wav2vec2forbrain_tpu_torch.parallel.mesh import make_mesh
from wav2vec2forbrain_tpu_torch.parallel.zero import Zero1
from wav2vec2forbrain_tpu_torch.train import optim, steps
from wav2vec2forbrain_tpu_torch.train.train_loop import Trainer
from wav2vec2forbrain_tpu_torch.tree import tree_map

shard = make_mesh(0, 1)
assert shard.rank == rank and shard.size == 2
inp = torch.load(inputs, weights_only=False)
res = {}

# BatchNorm over the global batch
bn = inp["bn"]
mine = shard.rows(bn["x"].shape[0])
x = bn["x"][mine].clone().requires_grad_(True)
p = {k: v.clone().requires_grad_(True) for k, v in bn["p"].items()}
y, st = _batch_norm(p, bn["state"], x, ConformerEncoderConfig(), True, shard.group)
gx, gs, gb = torch.autograd.grad((y * bn["w"][mine]).sum(), [x, p["scale"], p["bias"]])
distributed.all_reduce_tensors([gs, gb])
res["bn"] = dict(y=y.detach(), state=st, gx=gx, gscale=gs, gbias=gb)

# the train step on this rank's rows of the ragged batch, placed by the Trainer
spec = inp["spec"]
trainer = Trainer.__new__(Trainer)
trainer.config = validate(B2TGruAndW2VConformerArgsModel, {"batch_size": 3})
trainer.device = torch.device("cpu")
trainer.shard = shard
trainer.experiment = SimpleNamespace(batch_widths={}, t_buckets={}, time_axis=0, tokenizer=Wav2Vec2CTCTokenizer())
batch, true_b, mask_total = trainer._place(inp["batch"], "train")
res["placed"] = dict(rows=batch.input.shape[0], true_b=true_b, mask_total=mask_total,
                     mask=batch.sample_mask.clone())
labels = assembly.param_labels(inp["params"], "brain_encoder+w2v")
for name, zero1, noise in (("replicated", False, False), ("zero1", True, False), ("noise", False, True)):
    params = tree_map(lambda t: t.clone(), inp["params"])
    state = tree_map(lambda t: t.clone(), inp["state"])
    opt = optim.make_optimizer(labels, "adam", 0.0, inp["eps"], zero=Zero1(shard) if zero1 else None)
    opt_state = opt.init(params)
    cfg = steps.StepConfig(None, 0.5, 0.2) if noise else steps.StepConfig(None, 0.0, 0.0)
    replay = ForwardRng(*(SeedStream(seeds=seeds, layerdrop=ld) for seeds, ld in inp["replay"]))
    rng = StepRng(3, "cpu") if noise else StepRng(device="cpu", replay=[replay])
    grad_fn = steps.build_grad_fn(spec, labels, cfg, shard)
    o, grads, norm = grad_fn(params, state, batch, rng, mask_total)
    opt.step(params, grads, opt_state, *inp["lrs"])
    fwd = rng.forwards[0]
    res[name] = dict(loss=float(o["loss"].detach()), grads=grads, state=o["state"],
                     params=tree_map(lambda t: t.detach(), params),
                     mu=opt_state.mu, row0=[s.row0 for s in fwd], groups=[s.group is shard.group for s in fwd])
torch.save(res, out)
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_ranks(script: str, args, tmp_path, n=2, cwd=None):
    """Start `script` as n ranks (argv: rank, port, *args), each one's
    output to rank<r>.log in tmp_path. Returns [(process, log path)]."""
    path = tmp_path / "rank_child.py"
    path.write_text(script)
    port = str(_free_port())
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_DIR + os.pathsep + env.get("PYTHONPATH", "")
    ranks = []
    for r in range(n):
        log = tmp_path / f"rank{r}.log"
        with open(log, "w") as out:
            ranks.append((subprocess.Popen([sys.executable, str(path), str(r), port, *map(str, args)], cwd=cwd,
                                           env=env, stdout=out, stderr=subprocess.STDOUT), log))
    return ranks


def wait_ranks(ranks, timeout=CHILD_TIMEOUT):
    """Wait for every rank; as soon as one fails (the others then wait in a
    collective) or the time runs out, kill them all and fail."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p, _ in ranks):
            failed = [p for p, _ in ranks if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p, _ in ranks:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(ranks):
        assert p.returncode == 0, f"rank {r} exited with {p.returncode}:\n{log.read_text()[-4000:]}"


# --- masks at a row offset ----------------------------------------------------------


@pytest.mark.parametrize("shape,row0", [((6, 5, 7), 2), ((8, 3), 4), ((5, 4, 3, 2), 1)])
def test_hash_masks_at_a_row_offset_are_slices_of_the_whole_batch(shape, row0):
    full = hash_uniform(shape, 1234)
    rows = 3
    part = hash_uniform((rows, *shape[1:]), 1234, row0=row0)
    assert torch.equal(part, full[row0:row0 + rows])
    np.testing.assert_array_equal(part.numpy(), np.asarray(jax_uniform(shape, jnp.int32(1234)))[row0:row0 + rows])
    x = torch.randn(shape)
    assert torch.equal(hash_dropout(x[row0:row0 + rows], 99, 0.3, row0), hash_dropout(x, 99, 0.3)[row0:row0 + rows])


@pytest.mark.parametrize("row0", [1, 3])
def test_attention_masks_and_plain_versions_at_a_row_offset(row0):
    b, h, t, rows = 6, 2, 5, 2
    full = hash_keep_mask(77, (b, h, t, t), 0.9)
    part = hash_keep_mask(77, (rows, h, t, t), 0.9, row0=row0)
    sl = slice(row0, row0 + rows)
    assert torch.equal(part, full[sl])
    np.testing.assert_array_equal(part.numpy(), np.asarray(jax_keep_mask(jnp.int32(77), (b, h, t, t), 0.9))[sl])
    g = torch.Generator().manual_seed(row0)
    q, k, v, go = (torch.randn((b, t, 2 * 8), generator=g) for _ in range(4))
    args = (h, 0.25, 0.1, torch.float32, 77)
    whole = [port_attn.mha_dense_bth(q, k, v, *args), *port_attn.mha_bwd_plain(q, k, v, go, *args)]
    mine = [port_attn.mha_dense_bth(q[sl], k[sl], v[sl], *args, row0=row0),
            *port_attn.mha_bwd_plain(q[sl], k[sl], v[sl], go[sl], *args, row0=row0)]
    for a, m in zip(whole, mine):
        np.testing.assert_allclose(m.numpy(), a[sl].numpy(), rtol=1e-6, atol=1e-7)
    unshifted = port_attn.mha_dense_bth(q[sl], k[sl], v[sl], *args)
    assert not torch.equal(unshifted, mine[0])  # the offset changes the mask


# --- ZeRO-1 layout --------------------------------------------------------------------


@pytest.mark.parametrize("dp", [2, 4])
def test_zero1_layout_matches_jax_zero1_pspec(dp):
    opt_state = _jax_setup()["opt_state"]
    mesh = jax_make_mesh(dp, 1)
    leaves = jax.tree_util.tree_leaves_with_path(opt_state)
    n_split = 0
    for path, leaf in leaves:
        spec = tuple(zero1_pspec(path, leaf, mesh))
        want = spec.index("data") if "data" in spec else None
        assert zero1_dim(leaf.shape, dp) == want, (jax.tree_util.keystr(path), leaf.shape, spec)
        n_split += want is not None
    assert n_split > 20 and n_split < len(leaves)  # the step counts and some odd-sized leaves stay whole


# --- a 2-rank train step against the JAX step on a dp-2 mesh ---------------------------


def _jax_spec():
    return jax_assembly.ModelSpec(
        gru_hidden_size=64, latent_size=96, encoder_family="conformer", gru_dropout=0.1,
        conformer_cfg=JaxConformerConfig.tiny_test(hidden_act="swish", layerdrop=0.5),
        compute_dtype=jnp.float32, use_pallas=False,
    )


def _port_spec():
    from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig

    return port_assembly.ModelSpec(gru_hidden_size=64, latent_size=96, gru_dropout=0.1,
                                   conformer_cfg=ConformerEncoderConfig.tiny_test(hidden_act="swish", layerdrop=0.5))


def _host_batch():
    """3 rows (the Trainer pads them to 4 at dp 2)."""
    rng = np.random.default_rng(1)
    b, t = 3, 64
    lens = np.array([64, 56, 48], np.int32)
    x = rng.standard_normal((b, t, 256)).astype(np.float32)
    x[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    tok = Wav2Vec2CTCTokenizer()
    ids = [tok.encode(s) for s in ("HI", "A CAT", "GO")]
    target = np.zeros((b, max(len(i) for i in ids)), np.int32)
    for i, seq in enumerate(ids):
        target[i, : len(seq)] = seq
    return B2tBatch(x, target, np.array([0, 5, 5], np.int32), lens, np.array([len(i) for i in ids], np.int32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """The JAX model, its trainable / frozen split and Adam state."""
    jspec = _jax_spec()
    params, state = jax_assembly.init_model_params(jax.random.PRNGKey(7), jspec)
    labels = jax_assembly.param_labels(params, "brain_encoder+w2v")
    trainable, frozen = jax_steps.partition_params(params, labels)
    tlabels = jax_steps.prune_labels(labels, trainable)
    tx = jax_make_optimizer(tlabels, "adam", 0.0, EPS)
    return dict(jspec=jspec, params=params, state=state, trainable=trainable, frozen=frozen, tlabels=tlabels,
                tx=tx, opt_state=tx.init(trainable))


@functools.lru_cache(maxsize=None)
def _jax_dp_step(zero1: bool):
    """The JAX train step on the (2, 1) mesh: params replicated, the padded
    batch sharded over 'data', the Adam state replicated or in the ZeRO-1
    layout; with the replicated state also the step's loss, gradients and
    BN stats (which the optimizer's layout does not enter)."""
    env = _jax_setup()
    jspec, state, trainable, frozen, tlabels, tx, opt_state = (
        env[k] for k in ("jspec", "state", "trainable", "frozen", "tlabels", "tx", "opt_state"))
    init = (_np(env["params"]), _np(state))
    mesh = jax_make_mesh(2, 1)
    from jax.sharding import NamedSharding, PartitionSpec

    rep = NamedSharding(mesh, PartitionSpec())
    trainable, frozen, state = (jax.device_put(t, rep) for t in (trainable, frozen, state))
    opt_state = jax.device_put(opt_state, opt_state_shardings(opt_state, mesh) if zero1 else rep)
    batch = _pad_batch(_host_batch(), 4)
    jbatch = jax.tree_util.tree_map(lambda a: jax.device_put(jnp.asarray(a), batch_sharding(mesh)), batch)
    rng = jax.device_put(jax.random.PRNGKey(11), rep)
    k_model = _k_model()

    def loss_fn(t, model_state):
        out = jax_assembly.forward_with_loss(
            jax_steps.merge_params(t, frozen), model_state, jspec, jbatch.input, jbatch.day_idxs,
            jbatch.input_lens, jbatch.target, jbatch.target_lens, k_model, train=True,
            sample_mask=jbatch.sample_mask,
        )
        return out["loss"], out["state"]

    step = jax.jit(jax_steps.build_step_fns(jspec, tlabels, tx, jax_steps.StepConfig(None, 0.0, 0.0))[0])
    out = step(trainable, frozen, opt_state, state, jbatch, rng, jnp.float32(BRAIN_LR), jnp.float32(W2V_LR))
    if zero1:
        return dict(_jax_dp_step(False), params=_np(jax_steps.merge_params(out.params, frozen)))
    (loss, new_state), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable, state)
    np.testing.assert_allclose(float(out.loss), float(loss), rtol=1e-6)
    return dict(
        init=init, loss=float(loss), state=_np(new_state),
        grads=_np(jax_steps.merge_params(grads, jax.tree_util.tree_map(lambda a: None, frozen))),
        params=_np(jax_steps.merge_params(out.params, frozen)),
        layerdrop=jax_seed_streams(k_model, jspec).enc._layerdrop[0],
    )


def _k_model():
    """The JAX step's model key (train/steps.py splits the step's rng in 4)."""
    return jax.random.split(jax.random.PRNGKey(11), 4)[3]


def _bn_case():
    rng = np.random.default_rng(5)
    b, t, c = BN_SHAPE
    x = rng.standard_normal((b, t, c)).astype(np.float32) * 2 + 0.5
    x[-1] = x[-2]  # a pad row: a duplicate of the last real row, counted in the statistics
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32), "bias": rng.standard_normal(c).astype(np.float32)}
    state = {"mean": rng.standard_normal(c).astype(np.float32), "var": rng.uniform(0.5, 2, c).astype(np.float32)}
    w = rng.standard_normal((b, t, c)).astype(np.float32)
    return x, p, state, w


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results and the references: the JAX dp-2 steps, one
    process of the port with the noise on, the JAX BatchNorm."""
    from wav2vec2forbrain_tpu_torch.data.batch import to_device
    from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
    from wav2vec2forbrain_tpu_torch.train import steps
    from wav2vec2forbrain_tpu_torch.train.train_loop import pad_rows

    tmp = tmp_path_factory.mktemp("dp_step")
    env = _jax_setup()
    init = (_np(env["params"]), _np(env["state"]))
    tp, ts = bridge.params_from_jax(*init, device="cpu")
    fwd = jax_seed_streams(_k_model(), env["jspec"])
    x, p, state, w = _bn_case()
    inputs = dict(
        spec=_port_spec(), params=tp, state=ts, batch=_host_batch(), eps=EPS, lrs=(BRAIN_LR, W2V_LR),
        replay=[(s._seeds, s._layerdrop) for s in fwd],
        bn=dict(x=torch.from_numpy(x), p={k: torch.from_numpy(v) for k, v in p.items()},
                state={k: torch.from_numpy(v) for k, v in state.items()}, w=torch.from_numpy(w)),
    )
    torch.save(inputs, tmp / "inputs.pt")
    # the ranks run while the JAX steps compile
    procs = start_ranks(CHILD, [tmp / "inputs.pt", tmp / "rank{}.pt"], tmp_path=tmp)
    try:
        ref = {False: _jax_dp_step(False), True: _jax_dp_step(True)}
    finally:
        wait_ranks(procs)
    got = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False) for r in range(2)]

    # one process of the port, the noise on, the whole padded batch
    labels = port_assembly.param_labels(tp, "brain_encoder+w2v")
    params = bridge.params_from_jax(*init, device="cpu")[0]
    grad_fn = steps.build_grad_fn(_port_spec(), labels, steps.StepConfig(None, 0.5, 0.2))
    o, grads, _ = grad_fn(params, ts, to_device(pad_rows(_host_batch(), 4), "cpu"), StepRng(3, "cpu"))
    single = dict(loss=float(o["loss"].detach()), grads=grads, state=o["state"])

    def jax_bn(xx, pp, ss):
        y, st = jax_batch_norm(pp, ss, xx, JaxConformerConfig(), True)
        return jnp.sum(y * w), (y, st)

    (_, (y, st)), g = jax.value_and_grad(jax_bn, argnums=(0, 1), has_aux=True)(x, p, state)
    jbn = dict(y=np.asarray(y), state=_np(st), gx=np.asarray(g[0]), gscale=np.asarray(g[1]["scale"]),
               gbias=np.asarray(g[1]["bias"]))
    return dict(got=got, jax=ref, single=single, bn=jbn)


def test_global_batch_norm_matches_jax_over_the_whole_batch(ranks):
    got, ref = ranks["got"], ranks["bn"]
    y = torch.cat([g["bn"]["y"] for g in got]).numpy()
    gx = torch.cat([g["bn"]["gx"] for g in got]).numpy()
    np.testing.assert_allclose(y, ref["y"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gx, ref["gx"], atol=1e-5, rtol=1e-5)
    for g in got:
        for k in ("mean", "var"):  # the running stats take the global n
            np.testing.assert_allclose(g["bn"]["state"][k].numpy(), ref["state"][k], atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(g["bn"]["gscale"].numpy(), ref["gscale"], atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(g["bn"]["gbias"].numpy(), ref["gbias"], atol=1e-4, rtol=1e-5)


def test_trainer_places_the_ragged_batch_over_two_ranks(ranks):
    """3 rows padded to 4 (a masked duplicate), 2 a rank, the JAX mask count."""
    a, b = (g["placed"] for g in ranks["got"])
    assert a["rows"] == b["rows"] == 2 and a["true_b"] == b["true_b"] == 3
    assert a["mask_total"] == b["mask_total"] == 3.0
    assert a["mask"].tolist() == [1.0, 1.0] and b["mask"].tolist() == [1.0, 0.0]


@pytest.mark.parametrize("variant", ["replicated", "zero1"])
def test_two_rank_step_matches_the_jax_dp2_step(ranks, variant):
    jx = ranks["jax"][variant == "zero1"]
    assert any(jx["layerdrop"]) and not all(jx["layerdrop"])  # a layer dropped, the other ran
    for r, res in enumerate(ranks["got"]):
        pt = res[variant]
        assert pt["row0"] == [2 * r] * 3 and all(pt["groups"])
        np.testing.assert_allclose(pt["loss"], jx["loss"], rtol=1e-5)
        n_grads = 0
        for path, jg, pg in _pairs(jx["grads"], pt["grads"]):
            if jg is None:
                assert pg is None or not torch.any(pg), path
                continue
            got = np.zeros_like(jg) if pg is None else pg.numpy()
            np.testing.assert_allclose(got, jg, atol=1e-4, rtol=1e-4, err_msg=path)
            n_grads += 1
        assert n_grads >= 20
        for path, js, ps in _pairs(jx["state"], pt["state"]):
            np.testing.assert_allclose(ps.numpy(), js, atol=1e-4, rtol=1e-4, err_msg=path)
        for path, jp, pp in _pairs(jx["params"], pt["params"]):
            np.testing.assert_allclose(pp.numpy(), jp, atol=2e-5, rtol=0, err_msg=path)


def test_zero1_keeps_half_of_every_split_moment_leaf_and_the_same_params(ranks):
    for r, res in enumerate(ranks["got"]):
        n_split = 0
        for (path, _, full), (_, _, piece) in zip(_pairs(None, res["replicated"]["mu"]),
                                                  _pairs(None, res["zero1"]["mu"])):
            if full is None:  # a frozen leaf keeps no moments
                assert piece is None, path
                continue
            d = zero1_dim(full.shape, 2)
            if d is None:
                assert piece.shape == full.shape, path
                continue
            n_split += 1
            n = full.shape[d] // 2
            assert piece.shape[d] == n and piece.numel() * 2 == full.numel(), path
            assert torch.equal(piece, full.narrow(d, r * n, n)), path
        assert n_split > 20
        for (path, _, a), (_, _, b) in zip(_pairs(None, res["replicated"]["params"]),
                                           _pairs(None, res["zero1"]["params"])):
            assert torch.equal(a, b), path  # the same arithmetic on each element
    for (path, _, a), (_, _, b) in zip(_pairs(None, ranks["got"][0]["zero1"]["params"]),
                                       _pairs(None, ranks["got"][1]["zero1"]["params"])):
        assert torch.equal(a, b), path  # every rank holds the whole, gathered params


def test_two_rank_step_with_noise_equals_one_process(ranks):
    single = ranks["single"]
    for res in ranks["got"]:
        pt = res["noise"]
        np.testing.assert_allclose(pt["loss"], single["loss"], rtol=1e-5)
        for (path, _, a), (_, _, b) in zip(_pairs(None, single["grads"]), _pairs(None, pt["grads"])):
            if a is None:
                assert b is None, path
                continue
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=1e-5, err_msg=path)
        for (path, _, a), (_, _, b) in zip(_pairs(None, single["state"]), _pairs(None, pt["state"])):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=1e-5, err_msg=path)


def test_tensor_parallelism_still_raises():
    """In one process (world size 1) a model axis of 2 cannot be laid out."""
    with pytest.raises(ValueError, match="--mesh_model_parallel=2 does not divide the world size 1"):
        make_mesh(0, 2)
    with pytest.raises(ValueError, match="--mesh_model_parallel=2 does not divide the world size 1"):
        make_mesh(1, 2)
    with pytest.raises(ValueError, match="mesh_data_parallel=2"):
        make_mesh(2, 1)  # one process is a data axis of 1
    assert make_mesh(0, 1) is None and make_mesh(1, 1) is None
