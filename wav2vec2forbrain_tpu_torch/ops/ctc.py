"""CTC loss with the JAX package's semantics (counterpart of
wav2vec2forbrain_tpu/ops/ctc.py).

torch's F.ctc_loss on log_softmax (blank 0, reduction "none") gives the
per-sample negative log-likelihood; the two pieces the JAX wrapper adds are
written out here rather than left to F.ctc_loss's "mean":
- feasibility: a sample whose logit_len < target_len + #repeats has no
  alignment and contributes 0 (but still counts in the mean's denominator);
- "mean": per-sample loss / max(target_len, 1), averaged over the batch, or
  over sample_mask's weight when a mask is given. Under data parallelism a
  rank holds part of the batch and divides its part's sum by the global
  batch's weight (`mask_total`, which the host knows): the ranks' results
  sum to the global batch's mean.

F.ctc_loss runs with zero_infinity=True: its own backward of an infeasible
sample computes exp(... + nll - ...) with nll = inf, which is NaN, and a
NaN times the zero that the feasibility mask sends back is still NaN. With
zero_infinity the gradient of such a sample is exactly 0, as in the JAX
package (optax's finite log-semiring behind a `where`); the loss value does
not change, since the mask zeroes the same samples.
"""

import torch
import torch.nn.functional as F


def ctc_loss(
    logits: torch.Tensor,
    logit_lens: torch.Tensor,
    targets: torch.Tensor,
    target_lens: torch.Tensor,
    reduction: str = "mean",
    blank_id: int = 0,
    sample_mask: torch.Tensor = None,
    mask_total: float = None,
) -> torch.Tensor:
    """logits (B, T, K) raw; targets (B, U) padded with any value beyond
    target_lens; mask_total: the "mean" denominator of the global batch
    (its sample_mask sum, or its row count), where these rows are a part
    of it."""
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, K)
    per_sample = F.ctc_loss(
        log_probs,
        targets.long(),
        logit_lens.long(),
        target_lens.long(),
        blank=blank_id,
        reduction="none",
        zero_infinity=True,
    )
    u = targets.shape[1]
    valid_pos = torch.arange(1, u, device=targets.device)[None, :] < target_lens[:, None]
    repeats = ((targets[:, 1:] == targets[:, :-1]) & valid_pos).sum(dim=1)
    feasible = logit_lens >= target_lens + repeats
    per_sample = torch.where(feasible, per_sample, torch.zeros_like(per_sample))

    if sample_mask is not None:
        per_sample = per_sample * sample_mask
    if reduction == "mean":
        scaled = per_sample / torch.clamp(target_lens, min=1).to(per_sample.dtype)
        if mask_total is not None:
            return scaled.sum() / max(float(mask_total), 1.0)
        if sample_mask is not None:
            return scaled.sum() / torch.clamp(sample_mask.sum(), min=1.0)
        return scaled.mean()
    if reduction == "sum":
        return per_sample.sum()
    return per_sample
