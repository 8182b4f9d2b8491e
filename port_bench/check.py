"""The comparison that decides `correct`: what the timed path produced
against the plain reference (reference/), run after the window on the same
inputs, weights and seed streams.

Train cells (the first `check_steps` steps, which set-up ran through the
window's own call and feed):
- loss_rel: the largest relative gap of a step's loss;
- grad_gap: over the leaves, the largest gap between the norms of the
  first gradient as Adam takes it (weight decay included), over the larger
  of the reference leaf's norm and the median leaf's;
- update_gap: the same for the norm of each leaf's change over the steps,
  leaving out the leaves whose reference gradient stays under a thousandth
  of the median leaf's in every step (they move under Adam by round-off).

Serve cells (the sampled batches of the window's last pass that reached
them, the batch with the longest trial among them):
- logit_gap: the widest gap by which a served (greedy) token's reference
  logit lies below the reference's best, over every valid frame;
- logit_rel: the largest gap of a valid frame's logit from the reference's,
  over the batch's largest reference logit (the logits are what the
  evaluator and an LM decode read; a greedy token moves only near a tie);
- lens_mismatch: rows whose logit length differs from the reference's.

The control (control.py) puts the reference computed in TF32 in the
program's place and goes through the same functions.
"""

import statistics
from typing import Dict, List

import numpy as np
import torch

from port_bench import weights
from port_bench.reference import data as ref_data
from port_bench.reference import model
from port_bench.reference.train import Adam, group_of, leaves, train_step

GRAD_FLOOR = 1e-3  # leaves whose reference gradient stays under this share of the median leaf's are left out


def lr_at(flags: dict, epoch: int) -> Dict[str, float]:
    """The brain and w2v LRs of an epoch (brain_encoder+w2v): the w2v LR
    warms up linearly over w2v_warmup_steps epochs from w2v_warmup_start_step."""
    start, steps = flags.get("w2v_warmup_start_step") or 0, flags.get("w2v_warmup_steps") or 0
    target = flags.get("w2v_learning_rate", flags["learning_rate"])
    w2v = 0.0 if epoch < start else target * (min(1.0, (epoch - start) / steps) if steps > 0 else 1.0)
    return {"brain": flags["learning_rate"], "w2v": w2v}


def reference_steps(cfg: dict, seed: int, trials: ref_data.Trials, batches: List[dict], draws, noise_seed: int,
                    epoch: int, device, precision: str = "f32", half_batch: bool = False) -> dict:
    """Losses, first-gradient norms, the largest gradient norm of each leaf
    over the steps, and the change norms, of the reference's steps.
    half_batch (a fault, for the limits): the loss leaves out the second
    half of each batch's rows and averages over the rest."""
    flags = cfg["flags"]
    params, state = weights.make(cfg, seed, device)
    p0 = {p: t.clone() for p, t in leaves(params) if group_of(p) != "frozen"}
    opt = Adam(params, flags.get("weight_decay", 0.0), flags.get("optimizer_epsilon", 1e-8))
    gen = torch.Generator(device=device).manual_seed(int(noise_seed))
    lr = lr_at(flags, epoch)
    losses, first, most = [], {}, {}
    with model.Precision(precision) as prec:
        for k, (b, d) in enumerate(zip(batches, draws)):
            batch = trials.batch(list(zip(b["days"], b["lens"])), b["rows"], device)
            if half_batch:
                batch["sample_mask"][b["rows"] // 2:] = 0.0
            step_seeds = model.StepSeeds(model.SeedList(d.gru), model.SeedList(d.enc, d.layerdrop),
                                         model.SeedList(d.head))
            loss, grads, state = train_step(params, state, cfg, opt, batch, step_seeds, gen, lr, prec)
            losses.append(float(loss))
            if k == 0:
                first = {p: float(v) for p, v in opt.taken_norms.items()}
            for p in p0:
                g = grads.get(p)
                most[p] = max(most.get(p, 0.0), 0.0 if g is None else float(torch.linalg.vector_norm(g)))
            del grads, batch
    delta = {p: float(torch.linalg.vector_norm(t - p0[p])) for p, t in leaves(params) if p in p0}
    return {"losses": losses, "grad_norms": first, "grad_most": most, "delta_norms": delta}


def _worst(got: Dict[str, float], ref: Dict[str, float], keep=None):
    paths = [p for p in ref if keep is None or keep(p)]
    med = statistics.median([ref[p] for p in paths])
    gaps = {p: abs(got.get(p, 0.0) - ref[p]) / max(ref[p], med) for p in paths}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_numbers(got: dict, ref: dict) -> dict:
    """The train cell's numbers: `got` from the program (or the control),
    `ref` from reference_steps."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    if len(got["losses"]) != len(ref["losses"]):
        loss_rel = float("inf")
    grad_gap, grad_leaf = _worst(got["grad_norms"], ref["grad_norms"])
    floor = GRAD_FLOOR * statistics.median(ref["grad_most"].values())
    update_gap, update_leaf = _worst(got["delta_norms"], ref["delta_norms"], lambda p: ref["grad_most"][p] >= floor)
    left_out = sorted(p for p, g in ref["grad_most"].items() if g < floor)
    return {"numbers": {"loss_rel": loss_rel, "grad_gap": grad_gap, "update_gap": update_gap},
            "notes": {"grad_leaf": grad_leaf, "update_leaf": update_leaf, "left_out": left_out,
                      "losses": got["losses"], "ref_losses": ref["losses"]}}


def reference_logits(cfg: dict, params, state, trials, rec: dict, device, precision: str = "f32"):
    keys = list(zip(rec["days"], rec["lens"]))
    batch = trials.batch(keys, len(keys), device)
    with torch.no_grad(), model.Precision(precision) as prec:
        logits, lens, _ = model.forward(params, state, cfg, batch["input"], batch["day_idxs"], batch["input_lens"],
                                        prec=prec)
    return logits, lens


def token_gap(ref_logits: torch.Tensor, ref_lens: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap of a token's reference logit below the reference's
    best, over every row's valid frames."""
    if tokens.shape[:2] != ref_logits.shape[:2]:
        return float("inf")
    chosen = torch.gather(ref_logits, -1, tokens.long().unsqueeze(-1)).squeeze(-1)
    gaps = ref_logits.max(dim=-1).values - chosen
    valid = torch.arange(gaps.shape[1], device=gaps.device)[None, :] < ref_lens[:, None]
    return float(torch.where(valid, gaps, torch.zeros_like(gaps)).max())


def logit_rel(got: torch.Tensor, ref_logits: torch.Tensor, ref_lens: torch.Tensor) -> float:
    if got.shape != ref_logits.shape:
        return float("inf")
    valid = (torch.arange(got.shape[1], device=got.device)[None, :] < ref_lens[:, None])[..., None]
    err = torch.where(valid, (got - ref_logits).abs(), torch.zeros_like(got)).max()
    return float(err / ref_logits.abs().max())


def serve_numbers(cfg: dict, seed: int, trials, captured: dict, device) -> dict:
    params, state = weights.make(cfg, seed, device)
    gap, rel, mismatch = 0.0, 0.0, 0
    for idx, (logits_p, lens_p, pred_p, rec) in sorted(captured.items()):
        ref, lens = reference_logits(cfg, params, state, trials, rec, device)
        b = len(rec["lens"])
        gap = max(gap, token_gap(ref, lens, pred_p[:b].to(device)))
        rel = max(rel, logit_rel(logits_p[:b].to(device), ref, lens))
        mismatch += int((lens_p[:b].to(device).long() != lens.long()).sum())
    return {"numbers": {"logit_gap": gap, "logit_rel": rel, "lens_mismatch": float(mismatch)},
            "notes": {"batches": sorted(captured)}}


def readings(cell, sessions, program: dict, seed: int, device) -> dict:
    trials = ref_data.Trials(sessions)
    if cell.kind == "train":
        ch = program["check"]
        ref = reference_steps(cell.config, seed, trials, ch["batches"], ch["draws"], ch["noise_seed"], ch["epoch"],
                              device)
        return train_numbers(ch, ref)
    return serve_numbers(cell.config, seed, trials, program["captured"], device)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(k in numbers and np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
