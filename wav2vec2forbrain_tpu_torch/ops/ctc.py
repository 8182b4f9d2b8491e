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

The per-sample NLL (`ctc_nll`): on CUDA tensors the kernel csrc/ctc.cu,
one launch that computes the NLL and, where autograd needs it, the
gradient, each sum in a fixed order: F.ctc_loss's CUDA backward sums with
atomics at w2v-base's batch (B 64, T' >= 169) and is not reproducible
there. `ctc_nll_plain` (F.ctc_loss) is its plain version, on the CPU and
under the `none` policy; the kernel is held to it on the card.
"""

import torch
import torch.nn.functional as F

from wav2vec2forbrain_tpu_torch.ops import kernels
from wav2vec2forbrain_tpu_torch.ops.select import kernel_enabled


def ctc_nll_plain(log_probs, targets, in_lens, tgt_lens, blank: int = 0) -> torch.Tensor:
    """Per-sample NLL of log_probs (B, T, K) (log_softmax's output), 0 where
    no alignment exists; autograd gives F.ctc_loss's gradient."""
    return F.ctc_loss(log_probs.transpose(0, 1), targets.long(), in_lens.long(), tgt_lens.long(), blank=blank,
                      reduction="none", zero_infinity=True)


def _ctc_kernel(log_probs, targets, in_lens, tgt_lens, blank: int, need_grad: bool):
    """(nll (B,), the gradient (B, T, K) of each sample's nll with respect
    to log_probs or None): one launch of csrc/ctc.cu."""
    if log_probs.dim() != 3 or log_probs.dtype != torch.float32:
        raise ValueError(f"ctc_nll: log_probs must be (B, T, K) float32, got {tuple(log_probs.shape)} "
                         f"{log_probs.dtype}")
    lp = log_probs.contiguous()
    targets = targets.to(torch.int32).contiguous()
    in_lens, tgt_lens = in_lens.to(torch.int32).contiguous(), tgt_lens.to(torch.int32).contiguous()
    kernels.require_cuda("ctc_nll", lp, targets, in_lens, tgt_lens)
    b, t, k = lp.shape
    u = targets.shape[1]
    alpha = torch.empty((b, t, 2 * u + 1), dtype=torch.float32, device=lp.device)
    nll = torch.empty((b,), dtype=torch.float32, device=lp.device)
    grad = torch.empty_like(lp) if need_grad else None
    lib = kernels.lib()
    with torch.cuda.device(lp.device):
        code = lib.w2vb_ctc(lp.data_ptr(), targets.data_ptr(), in_lens.data_ptr(), tgt_lens.data_ptr(),
                            alpha.data_ptr(), nll.data_ptr(), None if grad is None else grad.data_ptr(),
                            b, t, k, u, int(blank), kernels.stream_of(lp))
    kernels.check("ctc", code)
    kernels.LAUNCHES["ctc"] += 1
    return nll, grad


class _CtcNll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, targets, in_lens, tgt_lens, blank):
        nll, grad = _ctc_kernel(log_probs, targets, in_lens, tgt_lens, blank, ctx.needs_input_grad[0])
        ctx.save_for_backward(grad)
        return nll

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return grad * g[:, None, None], None, None, None, None


def ctc_nll(log_probs, targets, in_lens, tgt_lens, blank: int = 0) -> torch.Tensor:
    """Same contract as ctc_nll_plain. On CUDA tensors the kernel runs (or
    raises); on CPU tensors its plain version."""
    if log_probs.is_cuda:
        return _CtcNll.apply(log_probs, targets, in_lens, tgt_lens, int(blank))
    return ctc_nll_plain(log_probs, targets, in_lens, tgt_lens, blank)


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
    log_probs = F.log_softmax(logits.float(), dim=-1)  # (B, T, K)
    nll = ctc_nll if kernel_enabled("ctc") else ctc_nll_plain
    per_sample = nll(log_probs, targets, logit_lens, target_lens, blank_id)
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
