"""Plain reference of a train step: the augmentation noise, the forward and
CTC loss of reference/model.py, the gradients by autograd, and torch Adam
(weight decay added to the gradient, bias-corrected moments) with one LR
for the brain encoder and one for the wav2vec2 encoder and head."""

from typing import Dict, List, Optional

import torch

from port_bench.reference import model

B1, B2 = 0.9, 0.999
FROZEN = ("brain/preproc/inp_layers",)  # the dead per-day input layers, never applied nor trained


def leaves(tree, prefix: str = "") -> List[tuple]:
    """[(path, tensor)] in the tree's order: dict keys as given, list items
    by index, None leaves left out."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in items:
        out += leaves(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def group_of(path: str) -> str:
    if any(path.startswith(f) for f in FROZEN):
        return "frozen"
    return "brain" if path.startswith("brain/") else "w2v"


class Adam:
    def __init__(self, params: dict, weight_decay: float, eps: float):
        self.wd, self.eps, self.count = weight_decay, eps, 0
        self.m = {p: torch.zeros_like(t) for p, t in leaves(params) if group_of(p) != "frozen"}
        self.v = {p: torch.zeros_like(t) for p, t in self.m.items()}
        self.taken_norms = {}  # each leaf's gradient as the last step took it (weight decay added): its norm

    @torch.no_grad()
    def step(self, params: dict, grads: Dict[str, Optional[torch.Tensor]], lr: Dict[str, float]) -> None:
        self.count += 1
        bc1 = float(1.0 - torch.tensor(B1) ** float(self.count))
        bc2 = float(1.0 - torch.tensor(B2) ** float(self.count))
        for path, p in leaves(params):
            group = group_of(path)
            if group == "frozen":
                continue
            g = grads.get(path)
            g = torch.zeros_like(p) if g is None else g
            if self.wd:
                g = g + self.wd * p
            self.taken_norms[path] = torch.linalg.vector_norm(g)
            m = (1 - B1) * g + self.m[path] * B1
            v = (1 - B2) * g * g + self.v[path] * B2
            p.sub_(lr[group] * (m / bc1) / (torch.sqrt(v / bc2) + self.eps))
            self.m[path], self.v[path] = m, v


def noisy(x: torch.Tensor, gen: torch.Generator, white_sd: float, offset_sd: float) -> torch.Tensor:
    """The augmentation: white noise per element, then a constant offset
    per (row, channel), both N(0, 1) from `gen` in that order."""
    b, _, c = x.shape
    if white_sd > 0:
        x = x + torch.randn(x.shape, generator=gen, device=x.device, dtype=torch.float32) * white_sd
    if offset_sd > 0:
        x = x + torch.randn((b, 1, c), generator=gen, device=x.device, dtype=torch.float32) * offset_sd
    return x


def train_step(params, state, cfg, opt: Adam, batch: dict, seeds: model.StepSeeds, gen: torch.Generator,
               lr: Dict[str, float], prec: model.Precision):
    """One step in place: returns (loss, {path: gradient as Adam gets it
    before weight decay}, new state)."""
    flags = cfg["flags"]
    named = [(p, t) for p, t in leaves(params) if group_of(p) != "frozen"]
    for _, t in named:
        t.requires_grad_(True)
    x = noisy(batch["input"], gen, flags.get("whiteNoiseSD", 0.0), flags.get("constantOffsetSD", 0.0))
    logits, lens, new_state = model.forward(params, state, cfg, x, batch["day_idxs"], batch["input_lens"],
                                            seeds, train=True, prec=prec)
    loss = model.ctc_loss(logits, lens, batch["target"], batch["target_lens"], batch["sample_mask"])
    found = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
    grads = {p: g for (p, _), g in zip(named, found)}
    for _, t in named:
        t.requires_grad_(False)
    opt.step(params, grads, lr)
    return loss.detach(), grads, new_state
