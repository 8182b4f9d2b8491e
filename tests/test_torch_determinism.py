"""Bitwise reproducible w2v-base training: the two ops that broke it on the
card and what replaced them.

- The pos-conv (models/wav2vec2.py): `_DeterministicConv1d` sets cuDNN's
  deterministic flag around its forward and its backward. On the CPU its
  output and gradients are F.conv1d's and autograd's, bit for bit, and
  pos_conv_embed gives the same bits with the flag's path on and off.
- The CTC loss (ops/ctc.py): on CPU tensors `ctc_nll` is its plain
  version, F.ctc_loss; under the `none` policy ctc_loss takes the plain
  version on any device.
- On a card (`cuda`): the kernel csrc/ctc.cu against F.ctc_loss, NLL and
  gradient, at w2v-base's batch (B 64, T' 89, 169, 230; ragged lengths, an
  infeasible sample, an empty target): the NLL within TOL_NLL relative
  (f32 log-sum-exps taken in another order), the gradient (a difference
  of probabilities, at most 1 in magnitude) within TOL_GRAD absolute and
  no further from F.ctc_loss at f64 than F32_CLASS x the plain f32
  version is (both put sums of magnitude |nll|, hundreds, in the exponent
  of each term: each sits ~1e-4 off the f64 result at T' 169); and
  bitwise against itself over 20 calls; and two tiny w2v-base trainings from one
  seed at B 64 and 700 frames (T' 168, where F.ctc_loss's backward was not
  reproducible) give bitwise equal params and Adam moments.

No jax here: the `cuda` tests run where jax is not installed.
"""

import pytest
import torch
import torch.nn.functional as F

from wav2vec2forbrain_tpu_torch.models import wav2vec2
from wav2vec2forbrain_tpu_torch.ops import kernels, select
from wav2vec2forbrain_tpu_torch.ops.ctc import ctc_loss, ctc_nll, ctc_nll_plain

torch.set_num_threads(2)
TOL_NLL = 1e-5
TOL_GRAD = 1e-3
F32_CLASS = 2.0
VOCAB = 32


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _pos_conv_inputs(gen):
    cfg = wav2vec2.Wav2Vec2EncoderConfig.tiny_test()
    h, k, g = cfg.hidden_size, cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    p = {"weight_v": torch.randn((h, h // g, k), generator=gen), "weight_g": torch.rand((1, 1, k), generator=gen),
         "bias": torch.randn((h,), generator=gen)}
    return cfg, p, torch.randn((3, 11, h), generator=gen)


def test_deterministic_conv1d_is_conv1d_and_its_autograd():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 13), generator=gen)
    w = torch.randn((8, 2, 5), generator=gen)
    gy = torch.randn((2, 8, 13), generator=gen)
    outs = []
    for fn in (lambda a, b: wav2vec2._DeterministicConv1d.apply(a, b, 2, 4),
               lambda a, b: F.conv1d(a, b, padding=2, groups=4)):
        a, b = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(a, b)
        y.backward(gy)
        outs.append((y.detach(), a.grad, b.grad))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("deterministic", [True, False])
def test_pos_conv_embed_is_the_same_with_either_path(monkeypatch, deterministic):
    cfg, p, x = _pos_conv_inputs(torch.Generator().manual_seed(1))
    runs = []
    for flag in (True, deterministic):
        monkeypatch.setattr(wav2vec2, "DETERMINISTIC_POS_CONV", flag)
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xx = x.clone().requires_grad_()
        y = wav2vec2.pos_conv_embed(leaves, xx, cfg)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        runs.append([y.detach(), xx.grad] + [leaves[k].grad for k in sorted(leaves)])
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def _ctc_inputs(dev, b, t, seed=0):
    """log_probs (B, T', 32), ragged logit lengths, targets of up to T'/3
    tokens; sample 1 infeasible (too short for its target), sample 2 an
    empty target."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((b, t, VOCAB), generator=gen, device=dev)
    in_lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
    in_lens[0] = t
    u = max(2, t // 3)
    tgt_lens = torch.randint(1, u + 1, (b,), generator=gen, device=dev)
    targets = torch.randint(1, VOCAB, (b, u), generator=gen, device=dev)
    in_lens[1], tgt_lens[1] = 1, 2
    tgt_lens[2] = 0
    return F.log_softmax(logits, dim=-1), targets, in_lens, tgt_lens


def test_ctc_nll_on_the_cpu_is_its_plain_version():
    lp, targets, in_lens, tgt_lens = _ctc_inputs("cpu", 4, 12)
    runs = []
    for fn in (ctc_nll, ctc_nll_plain):
        x = lp.clone().requires_grad_()
        nll = fn(x, targets, in_lens, tgt_lens)
        nll.sum().backward()
        runs.append((nll.detach(), x.grad))
    for got, want in zip(*runs):
        assert torch.equal(got, want)
    assert runs[0][0][1] == 0 and not runs[0][1][1].any()  # no alignment: 0, and a zero gradient


def test_none_policy_takes_the_plain_ctc(monkeypatch):
    calls = []
    monkeypatch.setattr("wav2vec2forbrain_tpu_torch.ops.ctc.ctc_nll", lambda *a: calls.append(a) or ctc_nll_plain(*a))
    logits = torch.randn((2, 6, VOCAB))
    args = (torch.tensor([6, 5]), torch.tensor([[3, 4], [5, 0]]), torch.tensor([2, 1]))
    try:
        select.set_kernel_policy("none")
        ctc_loss(logits, *args)
        assert not calls
        select.set_kernel_policy("auto")
        ctc_loss(logits, *args)
        assert len(calls) == 1
    finally:
        select.set_kernel_policy("auto")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [89, 169, 230])
def test_cuda_ctc_kernel_matches_plain_and_itself(t):
    dev = _cuda()
    lp, targets, in_lens, tgt_lens = _ctc_inputs(dev, 64, t)
    g = torch.rand((64,), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    want, want_grad = [], []
    for dtype in (torch.float32, torch.float64):
        x = lp.detach().to(dtype).requires_grad_()
        nll = ctc_nll_plain(x, targets, in_lens, tgt_lens)
        (nll * g.to(dtype)).sum().backward()
        want.append(nll.detach())
        want_grad.append(x.grad)
    runs = []
    for _ in range(20):
        kernels.reset_launches()
        x = lp.detach().clone().requires_grad_()
        nll = ctc_nll(x, targets, in_lens, tgt_lens)
        (nll * g).sum().backward()
        assert kernels.LAUNCHES["ctc"] == 1
        runs.append((nll.detach(), x.grad))
    nll, grad = runs[0]
    assert torch.isfinite(nll).all() and nll[1] == 0 and not grad[1].any()
    assert (nll - want[0]).abs().max().item() <= TOL_NLL * want[0].abs().max().item()
    assert (grad - want_grad[0]).abs().max().item() <= TOL_GRAD
    plain_err = (want_grad[0].double() - want_grad[1]).abs().max().item()
    assert (grad.double() - want_grad[1]).abs().max().item() <= F32_CLASS * plain_err
    assert not grad[0, :, :].eq(0).all() and not grad[3, int(in_lens[3]):].any()
    for a, b in runs[1:]:
        assert torch.equal(a, nll) and torch.equal(b, grad)
    with torch.no_grad():  # the NLL alone (no gradient written) is the same NLL
        assert torch.equal(ctc_nll(lp, targets, in_lens, tgt_lens), nll)


@pytest.mark.cuda
def test_cuda_tiny_w2v_trainings_from_one_seed_are_bitwise_equal():
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
    from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec, init_model_params, param_labels
    from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
    from wav2vec2forbrain_tpu_torch.train.optim import make_optimizer
    from wav2vec2forbrain_tpu_torch.train.steps import StepConfig, build_train_step
    from wav2vec2forbrain_tpu_torch.train.train_loop import train_batches
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    dev = _cuda()
    select.f32_products()
    spec = ModelSpec(encoder_family="wav2vec2", w2v_cfg=wav2vec2.Wav2Vec2EncoderConfig.tiny_test(), latent_size=96,
                     gru_hidden_size=32, gru_num_layers=2, gru_dropout=0.1, compute_dtype=torch.float32,
                     activation_dtype=torch.float32)
    batches = make_requests(2, 64, 700, seed=3)
    runs = []
    for _ in range(2):
        params, state = init_model_params(torch.Generator(device=dev).manual_seed(0), spec, dev)
        labels = param_labels(params, "brain_encoder+w2v")
        opt = make_optimizer(labels, "adam", 1e-4)
        step = build_train_step(spec, labels, opt, StepConfig(None, 0.02, 0.25))
        kernels.reset_launches()
        out = train_batches(step, params, opt.init(params), state, batches, StepRng(0, dev), 1e-3, 1e-4)
        assert kernels.LAUNCHES["ctc"] == 2
        runs.append(tree_leaves(params) + tree_leaves(out.opt_state.mu) + tree_leaves(out.opt_state.nu))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
