"""The plain reference (port_bench/reference/) against the port at tiny
sizes on the CPU: one eval forward and one train step of each family, on
weights, inputs and seed streams the benchmark makes. The reference itself
imports nothing of the port; this test imports both."""

import numpy as np
import pytest
import torch

from port_bench import check, seeds, traffic_gen, weights
from port_bench.reference import data as ref_data
from port_bench.reference import model
from port_bench.reference.train import Adam, leaves, train_step
from port_bench.tests import tiny

torch.set_num_threads(2)
FAMILIES = ("conformer", "w2v")
REL = 1e-4  # f32 on both sides, sums in other orders


def _spec(cfg):
    from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec
    from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
    from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig

    enc, brain = cfg["encoder"], cfg["brain"]
    if cfg["encoder_family"] == "conformer":
        kw = dict(conformer_cfg=ConformerEncoderConfig(
            **{k: v for k, v in enc.items() if k in ConformerEncoderConfig.__dataclass_fields__}))
    else:
        kw = dict(w2v_cfg=Wav2Vec2EncoderConfig(
            **{k: v for k, v in enc.items() if k in Wav2Vec2EncoderConfig.__dataclass_fields__}))
    return ModelSpec(gru_hidden_size=brain["gru_hidden_size"], gru_num_layers=brain["gru_num_layers"],
                     gru_dropout=brain["gru_dropout"], fc_hidden_sizes=tuple(brain["fc_hidden_sizes"]),
                     gaussian_smooth_width=brain["gaussian_smooth_width"], latent_size=enc["hidden_size"],
                     encoder_family=cfg["encoder_family"], **kw)


def _inputs(cfg, seed, n=4):
    traffic = tiny.traffic("train")
    sessions = traffic_gen.make_sessions(traffic, seed)
    trials = ref_data.Trials(sessions)
    keys = [(s.day, n_) for s in sessions for n_ in s.lengths][:n]
    return trials.batch(keys, n, "cpu")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("family", FAMILIES)
def test_eval_forward_matches_the_port(family):
    from wav2vec2forbrain_tpu_torch.models.assembly import forward

    cfg = tiny.config(family)
    params, state = weights.make(cfg, 11, "cpu")
    batch = _inputs(cfg, 11)
    got, got_lens, _ = forward(params, state, _spec(cfg), batch["input"], batch["day_idxs"].int(),
                               batch["input_lens"].int())
    ref, ref_lens, _ = model.forward(params, state, cfg, batch["input"], batch["day_idxs"], batch["input_lens"])
    assert torch.equal(got_lens.long(), ref_lens.long())
    assert _rel(got, ref) < REL


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_matches_the_port(family):
    from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch
    from wav2vec2forbrain_tpu_torch.models.assembly import param_labels
    from wav2vec2forbrain_tpu_torch.train.optim import make_optimizer
    from wav2vec2forbrain_tpu_torch.train.steps import StepConfig, build_train_step

    cfg = tiny.config(family, layerdrop=0.3)
    flags = cfg["flags"]
    spec = _spec(cfg)
    batch = _inputs(cfg, 12)
    lr = check.lr_at(flags, cfg["first_epoch"])

    params, state = weights.make(cfg, 12, "cpu")
    labels = param_labels(params, "brain_encoder+w2v")
    opt = make_optimizer(labels, "adam", flags.get("weight_decay", 0.0), flags["optimizer_epsilon"])
    step = build_train_step(spec, labels, opt, StepConfig(None, flags["whiteNoiseSD"], flags["constantOffsetSD"]))
    rng = seeds.bench_rng(12, "cpu", cfg["encoder"]["num_hidden_layers"], cfg["encoder"]["layerdrop"])
    port_batch = B2tBatch(batch["input"], batch["target"].int(), batch["day_idxs"].int(), batch["input_lens"].int(),
                          batch["target_lens"].int(), batch["sample_mask"])
    out = step(params, opt.init(params), state, port_batch, rng, lr["brain"], lr["w2v"])
    got = dict(leaves(params))

    ref_params, ref_state = weights.make(cfg, 12, "cpu")
    d = rng.draws[0]
    ref_seeds = model.StepSeeds(model.SeedList(d.gru), model.SeedList(d.enc, d.layerdrop), model.SeedList(d.head))
    gen = torch.Generator().manual_seed(rng.noise_seed)
    ref_opt = Adam(ref_params, flags.get("weight_decay", 0.0), flags["optimizer_epsilon"])
    loss, _, _ = train_step(ref_params, ref_state, cfg, ref_opt, batch, ref_seeds, gen, lr, model.Precision())
    assert abs(float(out.loss) - float(loss)) <= REL * abs(float(loss))
    # each leaf's step against the reference's, by norm; leaves whose gradient is nought to rounding (a key's
    # bias under softmax) move under Adam by round-off alone and are left out, as the check leaves them out
    taken = {p: float(v) for p, v in ref_opt.taken_norms.items()}
    floor = check.GRAD_FLOOR * float(np.median(list(taken.values())))
    start = dict(leaves(weights.make(cfg, 12, "cpu")[0]))
    ref_now = dict(leaves(ref_params))
    with torch.no_grad():
        for p in (p for p in taken if taken[p] >= floor):
            ref_step, got_step = ref_now[p] - start[p], got[p] - start[p]
            assert float((got_step - ref_step).norm()) <= 1e-2 * float(ref_step.norm()), p


def test_the_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    for path in (Path(model.__file__).parent).glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not {m.split(".")[0] for m in names} & {"wav2vec2forbrain_tpu_torch", "wav2vec2forbrain_tpu", "jax"}


def test_trials_are_named_by_session_and_length():
    traffic = tiny.traffic("train")
    a = traffic_gen.make_sessions(traffic, 5)
    b = traffic_gen.make_sessions(traffic, 6)
    assert sorted(a[0].lengths) == sorted(b[0].lengths)  # every seed: the same sizes, in another order
    assert a[0].lengths != b[0].lengths or a[1].lengths != b[1].lengths
    assert all(len(set(s.lengths)) == len(s.lengths) for s in a)
    assert np.array_equal(a[0].tx1[0], traffic_gen.make_sessions(traffic, 5)[0].tx1[0])
