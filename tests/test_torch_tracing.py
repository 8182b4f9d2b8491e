"""The port's span recorder (util/profiling.py) and the spans the train and
eval steps, the input path and the evaluator record.

- off (the default), nothing is recorded and `span()` hands back one
  shared no-op context; train and eval steps of both tiny families give
  bitwise the same loss, gradients (Adam's first moment after one step),
  params and eval outputs with the recorder on and off;
- on, a `Trainer._train_epoch` under --host_prefetch and an inline
  `_predict` pass record the spans of the module's table, with their
  parents, threads and batch ids; the worker's `collate` / `place` spans
  carry the ids of the steps that consume them;
- the cap counts what it drops; the summary's self time; the run's
  WAV2VEC2FORBRAIN_TPU_TRACE_DIR file;
- `cuda`: on the card, under torch.profiler (CUDA activity only), every
  kernel launch the CUDA runtime records in a traced step falls inside that
  step's `train_step` span, its kernel starts after the launch, and its
  resource id is a recording thread's id cut to 32 bits.

jax is imported only inside the CPU tests' fixture: the `cuda` test runs
where jax is not installed.
"""

import json
import os
import sys
import threading

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from torch_remat_fixtures import tiny_batch, tiny_spec  # noqa: E402

from wav2vec2forbrain_tpu_torch import run  # noqa: E402
from wav2vec2forbrain_tpu_torch.args.flags import PRETRAINED_LATENT_SIZES  # noqa: E402
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel  # noqa: E402
from wav2vec2forbrain_tpu_torch.experiments import impl  # noqa: E402
from wav2vec2forbrain_tpu_torch.models import assembly, pretrained  # noqa: E402
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig  # noqa: E402
from wav2vec2forbrain_tpu_torch.models.seeds import StepRng  # noqa: E402
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig  # noqa: E402
from wav2vec2forbrain_tpu_torch.ops import kernels  # noqa: E402
from wav2vec2forbrain_tpu_torch.train import optim, steps, train_loop  # noqa: E402
from wav2vec2forbrain_tpu_torch.tree import tree_leaves  # noqa: E402
from wav2vec2forbrain_tpu_torch.util import profiling  # noqa: E402

STEP_CHILDREN = ["forward", "backward", "optimizer"]
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


@pytest.fixture
def recorder():
    """Start the recorder; the test reads it with profiling.stop(). Off again
    however the test ends."""
    profiling.start()
    try:
        yield
    finally:
        profiling.stop()
        profiling.serve(None)


def _by_name(rec, name):
    return [(i, s) for i, s in enumerate(rec["spans"]) if s[0] == name]


def _children(rec, i):
    return [s for s in rec["spans"] if s[3] == i]


def _ancestors(rec, i):
    names = []
    while rec["spans"][i][3] >= 0:
        i = rec["spans"][i][3]
        names.append(rec["spans"][i][0])
    return names


def _check_nesting(rec):
    """Every span closed, inside its parent, on its parent's thread."""
    for name, t0, t1, parent, tid, _ in rec["spans"]:
        assert t1 is not None and t0 <= t1, name
        if parent >= 0:
            p = rec["spans"][parent]
            assert p[1] <= t0 and t1 <= p[2] and p[4] == tid, (name, p[0])


def _steps(family):
    spec = tiny_spec(family)
    params, state = assembly.init_model_params(torch.Generator().manual_seed(0), spec, "cpu")
    labels = assembly.param_labels(params, "brain_encoder+w2v")
    optimizer = optim.make_optimizer(labels, "adam", 1e-3)
    train = steps.build_train_step(spec, labels, optimizer, steps.StepConfig(1.0, 0.02, 0.25))
    return params, state, optimizer.init(params), train, steps.build_eval_step(spec)


def test_off_records_nothing():
    assert not profiling._on
    assert profiling.span("forward") is profiling.span("train_step", 3)  # the shared no-op context
    params, state, opt_state, train, evaluate = _steps("conformer")
    rng = StepRng(5, "cpu")
    train(params, opt_state, state, tiny_batch(), rng, 1e-3, 1e-4)
    evaluate(params, state, tiny_batch())
    assert profiling._spans == []
    profiling.start()
    rec = profiling.stop()
    assert rec["spans"] == [] and rec["dropped"] == 0 and rec["threads"] == {}


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_steps_are_bitwise_the_same_with_the_recorder_on(family):
    runs = {}
    for on in (False, True):
        params, state, opt_state, train, evaluate = _steps(family)
        rng = StepRng(5, "cpu")
        if on:
            profiling.start()
        try:
            losses, mus = [], []
            for k in range(2):
                profiling.serve(k)
                out = train(params, opt_state, state, tiny_batch(), rng, 1e-3, 1e-4)
                opt_state, state = out.opt_state, out.model_state
                losses.append(out.loss)
                mus.append([m.clone() for m in tree_leaves(opt_state.mu)])  # the first: (1 - b1) x the gradient
            evals = evaluate(params, state, tiny_batch())
        finally:
            rec = profiling.stop() if on else None
            profiling.serve(None)
        runs[on] = (losses, mus, tree_leaves(params), [evals[0], evals[1], evals[3]])
        if on:
            roots = _by_name(rec, "train_step")
            assert [s[5] for _, s in roots] == [0, 1] and len(_by_name(rec, "eval_step")) == 1
            assert len(_by_name(rec, "hash_mask")) > 0
    for got, want in zip(runs[True], runs[False]):
        flat_got = [t for x in got for t in (x if isinstance(x, list) else [x])]
        flat_want = [t for x in want for t in (x if isinstance(x, list) else [x])]
        assert len(flat_got) == len(flat_want) > 0
        assert all(torch.equal(a, b) for a, b in zip(flat_got, flat_want))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """(tmp dir, tests/test_torch_trainer.py) with the port's checkpoints
    resolved to tiny encoders whose dropouts are on (tiny_test's 0.1)."""
    import test_torch_trainer as tt  # imports jax: the CPU tests only

    tmp = tmp_path_factory.mktemp("tracing")
    tt.make_splits(str(tmp / "t12"))

    def tiny(checkpoint):
        if "conformer" in checkpoint:
            return "conformer", ConformerEncoderConfig.tiny_test(hidden_act="swish")
        return "wav2vec2", Wav2Vec2EncoderConfig.tiny_test()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pretrained, "encoder_config_for_checkpoint", tiny)
        for ckpt in (tt.W2V_CKPT, tt.CONF_CKPT):
            mp.setitem(PRETRAINED_LATENT_SIZES, ckpt, 96)
        yield tmp, tt


def _experiment(env, family, **overrides):
    tmp, tt = env
    cls = impl.B2TGruAndW2VConformerExperiment if family == "conformer" else impl.B2TGruAndW2VExperiment
    return cls(tt.config(family, **overrides), YamlConfigModel(**tt.yaml_fields(tmp)), device="cpu")


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_a_prefetched_train_epoch_records_the_table(env, family, recorder):
    exp = _experiment(env, family, results_subdir_name=f"tracing_{family}", host_prefetch=True)
    trainer = train_loop.Trainer(exp)
    n = len(exp.dataloader_train)
    assert n >= 2
    trainer._train_epoch(exp.dataloader_train, 0)
    rec = profiling.stop()
    assert rec["dropped"] == 0
    _check_nesting(rec)
    main = {s[4] for _, s in _by_name(rec, "train_step")}
    assert len(main) == 1
    worker = {tid for tid, name in rec["threads"].items() if name == "host-prefetch"}
    assert len(worker) == 1 and not worker & main

    roots = _by_name(rec, "train_step")
    assert [s[5] for _, s in roots] == list(range(n)) and all(s[3] == -1 for _, s in roots)
    for i, s in roots:
        kids = _children(rec, i)
        assert [k[0] for k in sorted(kids, key=lambda k: k[1])] == STEP_CHILDREN
        assert all(k[5] == s[5] for k in kids)  # the children serve the step's batch
    masks = _by_name(rec, "hash_mask")
    assert masks and all({"forward", "backward"} & set(_ancestors(rec, i)) for i, _ in masks)
    assert {"forward", "backward"} <= {rec["spans"][s[3]][0] for _, s in masks}  # the backward regenerates
    assert not _by_name(rec, "grad_allreduce")  # one process

    # the worker collates and places each batch the steps consume, under the step's id
    for name in ("collate", "place"):
        spans = [s for _, s in _by_name(rec, name)]
        assert [s[5] for s in spans] == list(range(n)) and {s[4] for s in spans} == worker, name
        assert all(s[3] == -1 for s in spans)
    waits = [s for _, s in _by_name(rec, "input_wait")]
    assert [s[5] for s in waits][:n] == list(range(n)) and {s[4] for s in waits} == main
    for name in ("fetch", "evaluator"):
        spans = [s for _, s in _by_name(rec, name)]
        assert {s[4] for s in spans} == main
        assert [s[5] for s in spans if s[5] is not None] == list(range(n)), name
    assert [s[5] for _, s in _by_name(rec, "evaluator")].count(None) == 1  # the epoch's evaluate()
    summary = profiling.summarize(rec)
    assert summary["train_step"]["count"] == n
    assert 0 <= summary["train_step"]["self_ms"] < summary["train_step"]["host_ms"]


def test_an_inline_predict_pass_records_the_table(env, recorder):
    exp = _experiment(env, "conformer", results_subdir_name="tracing_predict", host_prefetch=False)
    trainer = train_loop.Trainer(exp)
    n = len(exp.dataloader_test)
    exp._predict(trainer, "test")
    rec = profiling.stop()
    _check_nesting(rec)
    roots = _by_name(rec, "eval_step")
    assert [s[5] for _, s in roots] == list(range(n))
    assert all([k[0] for k in _children(rec, i)] == ["forward"] for i, _ in roots)
    assert not _by_name(rec, "train_step") and not _by_name(rec, "hash_mask")  # eval: no dropout
    # inline: the loader's collate and the placement inside the consumer's wait, on one thread
    waits = _by_name(rec, "input_wait")
    assert [s[5] for _, s in waits] == list(range(n + 1))  # the last finds the pass's end
    for name in ("collate", "place"):
        spans = _by_name(rec, name)
        assert [s[5] for _, s in spans] == list(range(n))
        assert all(rec["spans"][s[3]][0] == "input_wait" and rec["spans"][s[3]][5] == s[5] for _, s in spans)
    assert len({s[4] for s in rec["spans"]}) == 1
    assert [s[5] for _, s in _by_name(rec, "fetch")] == list(range(n))
    assert [s[5] for _, s in _by_name(rec, "evaluator")] == list(range(n)) + [None]


def test_the_cap_counts_what_it_drops_and_self_time_leaves_out_children(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 3)
    profiling.start()
    try:
        with profiling.span("a", 7):
            with profiling.span("b"):
                pass
            with profiling.span("c", 9):
                with profiling.span("d"):
                    pass
        with profiling.span("e"):
            pass
    finally:
        rec = profiling.stop()
    assert rec["cap"] == 3 and rec["dropped"] == 2
    assert [s[0] for s in rec["spans"]] == ["a", "b", "c"]
    assert [s[3] for s in rec["spans"]] == [-1, 0, 0] and [s[5] for s in rec["spans"]] == [7, 7, 9]
    a, b, c = rec["spans"]
    summary = profiling.summarize(rec)
    want = (a[2] - a[1] - (b[2] - b[1]) - (c[2] - c[1])) / 1e6
    assert summary["a"]["self_ms"] == pytest.approx(want) and summary["a"]["count"] == 1
    assert summary["c"]["self_ms"] == summary["c"]["host_ms"]  # its child was dropped


def test_the_trace_variable_writes_the_run_s_spans(tmp_path, monkeypatch):
    class Stub:
        def run(self):
            kernels.LAUNCHES["ctc"] += 2
            for k in range(3):
                profiling.serve(k)
                with profiling.span("train_step", profiling.SERVED), profiling.span("forward"):
                    pass
            profiling.serve(None)

    monkeypatch.setattr(run, "get_experiment_from_args", lambda argv, device: Stub())
    monkeypatch.setenv(profiling.TRACE_DIR_ENV, str(tmp_path / "trace"))
    run.main(["--experiment_type=b2p2t_gru+w2v"], device="cpu")
    assert not profiling._on
    with open(tmp_path / "trace" / f"spans-{os.getpid()}.json") as f:
        got = json.load(f)
    assert got["fields"] == list(profiling.FIELDS) and got["clock"] == "time.time_ns"
    assert [(s[0], s[3], s[5]) for s in got["spans"]] == [
        ("train_step", -1, 0), ("forward", 0, 0), ("train_step", -1, 1), ("forward", 2, 1),
        ("train_step", -1, 2), ("forward", 4, 2)]
    assert got["summary"]["train_step"]["count"] == 3 and got["dropped"] == 0
    assert got["launches"]["ctc"] == 2 and sum(got["launches"].values()) == 2
    monkeypatch.delenv(profiling.TRACE_DIR_ENV)
    run.main([], device="cpu")  # unset: nothing written, the recorder stays off
    assert os.listdir(tmp_path / "trace") == [f"spans-{os.getpid()}.json"]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_launches_of_a_traced_step_fall_inside_its_span():
    from wav2vec2forbrain_tpu_torch.data.batch import to_device
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
    from wav2vec2forbrain_tpu_torch.ops import select

    dev = _cuda()
    select.f32_products()
    spec = tiny_spec("conformer")
    params, state = assembly.init_model_params(torch.Generator(device=dev).manual_seed(0), spec, dev)
    labels = assembly.param_labels(params, "brain_encoder+w2v")
    optimizer = optim.make_optimizer(labels, "adam", 1e-4)
    opt_state = optimizer.init(params)
    train = steps.build_train_step(spec, labels, optimizer, steps.StepConfig(None, 0.02, 0.25))
    batches = [to_device(b, dev) for b in make_requests(3, 8, 200, seed=3)]
    rng = StepRng(0, dev)
    out = train(params, opt_state, state, batches[0], rng, 1e-3, 1e-4)  # warm: nothing is first in the trace
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        profiling.start()
        try:
            for k, batch in enumerate(batches[1:]):
                profiling.serve(k)
                out = train(params, out.opt_state, out.model_state, batch, rng, 1e-3, 1e-4)
            torch.cuda.synchronize(dev)
        finally:
            rec = profiling.stop()
            profiling.serve(None)
    steps_ns = [(s[1], s[2]) for s in rec["spans"] if s[0] == "train_step"]
    assert len(steps_ns) == 2
    events = list(prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    launches = [e for e in events if e.device_type() == cpu and e.name() in LAUNCH_CALLS]
    kernel_at = {e.correlation_id(): e.start_ns() for e in events if e.device_type() != cpu}
    assert len(launches) > 100
    for e in launches:
        assert any(a <= e.start_ns() and e.start_ns() + e.duration_ns() <= b for a, b in steps_ns), e.name()
        assert kernel_at[e.correlation_id()] >= e.start_ns()
    # a launch's resource id is its thread's pthread id, cut to 32 bits: the main thread's or autograd's
    threads = {tid & 0xFFFFFFFF for tid in rec["threads"]}
    assert {e.device_resource_id() & 0xFFFFFFFF for e in launches} <= threads
    assert threading.get_ident() & 0xFFFFFFFF in {e.device_resource_id() & 0xFFFFFFFF for e in launches}
