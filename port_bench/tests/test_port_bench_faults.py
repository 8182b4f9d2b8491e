"""A whole run on the CPU at tiny sizes (the harness's look for a card
skipped), with the timed path broken underneath: `correct` has to come out
false under the cell's own limits, once for each fault the cell can have.
The same run unbroken comes out true. (The exchange between chips is not
among the faults: every cell runs on one card.)"""

import contextlib
import json
import time
from pathlib import Path

import pytest
import torch

from port_bench import harness, report
from port_bench.tests import tiny

PB = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)
# the limits each tiny run is held to; w2v-base's serve path has no cell yet (PERF.md, Open questions)
CELLS = {("conformer", "train"): "conformer.train", ("w2v", "train"): "w2v-base.train",
         ("conformer", "serve"): "conformer.serve", ("w2v", "serve"): "conformer.serve"}


def _run(family: str, kind: str) -> dict:
    with open(PB / "limits" / f"{CELLS[family, kind]}.json") as f:
        cell = tiny.cell(family, kind, limits=json.load(f))
    with tiny.tiny_program(cell.config):
        result = harness.run_cell(cell, 2**31 + 99, 1.0, False, time.perf_counter(), device="cpu")
    return report.result_line(cell, result, False, torch.device("cpu"))


@contextlib.contextmanager
def _state_unchanged():
    """The optimizer leaves params and moments as they were."""
    from wav2vec2forbrain_tpu_torch.train import optim

    step = optim.Optimizer.step
    optim.Optimizer.step = lambda self, params, grads, state, brain_lr, w2v_lr: optim.AdamState(
        state.count + 1, state.mu, state.nu)
    try:
        yield
    finally:
        optim.Optimizer.step = step


@contextlib.contextmanager
def _half_batch():
    """The loss leaves out the second half of the batch's rows and averages the rest."""
    from wav2vec2forbrain_tpu_torch.models import assembly

    loss = assembly.ctc_loss

    def half(logits, logit_lens, targets, target_lens, reduction="mean", blank_id=0, sample_mask=None,
             mask_total=None):
        mask = torch.ones(logits.shape[0], device=logits.device)
        mask[logits.shape[0] // 2:] = 0.0
        return loss(logits, logit_lens, targets, target_lens, reduction, blank_id, sample_mask=mask)

    assembly.ctc_loss = half
    try:
        yield
    finally:
        assembly.ctc_loss = loss


@contextlib.contextmanager
def _eval_output(change):
    """The eval step's outputs changed where they are produced."""
    from wav2vec2forbrain_tpu_torch.experiments import impl

    build = impl.build_eval_step

    def broken_build(*args, **kwargs):
        step = build(*args, **kwargs)

        def broken(*a, **k):
            return change(*step(*a, **k))

        return broken

    impl.build_eval_step = broken_build
    try:
        yield
    finally:
        impl.build_eval_step = build


def _token_altered(loss, logits, lens, pred, metrics):
    pred = pred.clone()
    pred[0, 0] = (pred[0, 0] + 1) % logits.shape[-1]
    return loss, logits, lens, pred, metrics


def _half_rows(loss, logits, lens, pred, metrics):
    """The second half of the rows is not computed: it repeats the first half."""
    b = logits.shape[0] // 2
    logits, pred = logits.clone(), pred.clone()
    logits[b: 2 * b], pred[b: 2 * b] = logits[:b], pred[:b]
    return loss, logits, lens, pred, metrics


@pytest.mark.parametrize("family", ["conformer", "w2v"])
@pytest.mark.parametrize("kind", ["train", "serve"])
def test_a_sound_run_is_correct(family, kind):
    assert _run(family, kind)["correct"] is True


@pytest.mark.parametrize("family", ["conformer", "w2v"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_a_broken_train_step_is_not_correct(family, fault):
    with fault():
        line = _run(family, "train")
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("family", ["conformer", "w2v"])
@pytest.mark.parametrize("change", [_token_altered, _half_rows])
def test_a_broken_eval_step_is_not_correct(family, change):
    with _eval_output(change):
        line = _run(family, "serve")
    assert line["correct"] is False, line["checks"]
