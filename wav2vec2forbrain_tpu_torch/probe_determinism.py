"""Bitwise reproducibility of w2v-base training on one CUDA card.

    python -m wav2vec2forbrain_tpu_torch.probe_determinism [--steps 2] [--ctc-calls 20]

a. Train steps: profile_train's w2v-base setup (the fft sweep point,
   batch 64 x 384 frames, chip_smoke phase 6's batches) takes --steps train
   steps from seed 0, twice for each compute dtype (bf16, f32) and each
   pos-conv setting (models/wav2vec2.py::DETERMINISTIC_POS_CONV: cuDNN's
   deterministic flag around the pos-conv, or a plain F.conv1d). Prints how
   many param, mu and nu leaves of the second run differ from the first's,
   and the losses.
b. The CTC loss (ops/ctc.py::ctc_loss, "mean" reduction) and its backward,
   --ctc-calls times on one set of w2v-shaped logits (B 64, 32 classes) at
   T' 89 (384 frames), 169 (700 frames, the corpus' longest) and 230, and
   at B 32, T' 169 (the conformer's batch): how many of the logits
   gradients differ bitwise from the first call's, and the largest
   difference.

Prints the card's name and power limit first. Needs a CUDA card.
"""

import argparse
import subprocess

import torch

from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
from wav2vec2forbrain_tpu_torch.models import wav2vec2
from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
from wav2vec2forbrain_tpu_torch.ops import select
from wav2vec2forbrain_tpu_torch.ops.ctc import ctc_loss
from wav2vec2forbrain_tpu_torch.profile_train import BRAIN_LR, W2V_LR, build_trainer
from wav2vec2forbrain_tpu_torch.train.train_loop import train_batches
from wav2vec2forbrain_tpu_torch.tree import tree_leaves

CTC_SHAPES = ((64, 89), (64, 169), (64, 230), (32, 169))  # (B, T')
VOCAB = 32


def train_leaves(dev, steps: int, compute_dtype):
    """(losses, CPU copies of the params, mu and nu leaves) after `steps`
    w2v-base train steps from seed 0."""
    tr = build_trainer(dev, 0, "w2v", compute_dtype)
    batches = make_requests(steps, tr.batch_size, 384, seed=1)
    run = train_batches(tr.train_step, tr.params, tr.opt_state, tr.state, batches, StepRng(0, dev),
                        BRAIN_LR, W2V_LR)
    torch.cuda.synchronize()
    leaves = [t.detach().cpu() for t in tree_leaves(tr.params) + tree_leaves(run.opt_state.mu)
              + tree_leaves(run.opt_state.nu)]
    return [m.loss for m in run.history.metrics], leaves


def ctc_inputs(dev, b: int, t: int, seed: int = 0):
    """Logits (B, T', 32), logit lengths T'/2..T', targets of T'/4..T'/3
    tokens (ids 1..31), feasible for every sample."""
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((b, t, VOCAB), generator=g, device=dev)
    lens = torch.randint(t // 2, t + 1, (b,), generator=g, device=dev)
    lens[0] = t
    u = t // 3
    tlens = torch.randint(t // 4, u + 1, (b,), generator=g, device=dev)
    targets = torch.randint(1, VOCAB, (b, u), generator=g, device=dev)
    return logits, lens, targets, tlens


def ctc_grads(inputs, calls: int):
    logits, lens, targets, tlens = inputs
    out = []
    for _ in range(calls):
        x = logits.clone().requires_grad_()
        loss = ctc_loss(x, lens, targets, tlens)
        loss.backward()
        out.append((loss.detach(), x.grad))
    torch.cuda.synchronize()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--ctc-calls", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_determinism: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")
    select.f32_products()
    dev = torch.device("cuda", 0)

    print(f"a. {args.steps} w2v-base train steps from seed 0, twice per setting")
    for dtype in (torch.bfloat16, torch.float32):
        for deterministic in (False, True):
            wav2vec2.DETERMINISTIC_POS_CONV = deterministic
            (loss_a, a), (loss_b, b) = (train_leaves(dev, args.steps, dtype) for _ in range(2))
            differ = sum(not torch.equal(x, y) for x, y in zip(a, b))
            worst = max((x - y).abs().max().item() for x, y in zip(a, b))
            print(f"  compute {str(dtype).split('.')[1]}, pos-conv {'deterministic' if deterministic else 'default'}: "
                  f"{differ} of {len(a)} leaves (params, mu, nu) differ, max |diff| {worst:.3e}; "
                  f"losses {loss_a} / {loss_b}")
    wav2vec2.DETERMINISTIC_POS_CONV = True

    print(f"b. the CTC loss and its backward, {args.ctc_calls} calls on one set of logits")
    for b, t in CTC_SHAPES:
        runs = ctc_grads(ctc_inputs(dev, b, t), args.ctc_calls)
        loss0, g0 = runs[0]
        differ = sum(not torch.equal(g, g0) for _, g in runs[1:])
        loss_differ = sum(not torch.equal(x, loss0) for x, _ in runs[1:])
        worst = max((g - g0).abs().max().item() for _, g in runs[1:])
        print(f"  B {b} T' {t}: {differ} of {args.ctc_calls - 1} gradients differ from the first "
              f"(max |diff| {worst:.3e}, |g| max {g0.abs().max().item():.3e}); {loss_differ} losses differ")


if __name__ == "__main__":
    main()
