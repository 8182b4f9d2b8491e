"""CTC gradients of a sample that has no alignment.

F.ctc_loss's own backward gives NaN for an infeasible sample (its nll is
inf), and the feasibility mask's zero upstream gradient times NaN stays NaN:
one such trial would turn every parameter NaN after an Adam step. The JAX
package's loss (optax's finite log-semiring behind a `where`) gives such a
sample gradient 0. The port must do the same and keep the loss value.
Tolerance: rtol 1e-5 / atol 1e-6 on loss and gradients (f32 CTC recursions
in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu.ops.ctc import ctc_loss as jax_ctc
from wav2vec2forbrain_tpu_torch.ops.ctc import ctc_loss


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_infeasible_sample_gets_zero_gradient_as_in_jax(reduction):
    # sample 1 has 3 frames; targets [1, 1, 2] need 4 with the repeat
    logits = np.random.default_rng(0).standard_normal((2, 5, 32)).astype(np.float32)
    logit_lens = np.array([5, 3], np.int32)
    targets = np.array([[4, 5, 0], [1, 1, 2]], np.int32)
    target_lens = np.array([2, 3], np.int32)
    args = [jnp.asarray(a) for a in (logit_lens, targets, target_lens)]
    ref_loss, ref_grad = jax.value_and_grad(lambda lg: jax_ctc(lg, *args, reduction))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    loss = ctc_loss(lt, *(torch.from_numpy(a) for a in (logit_lens, targets, target_lens)), reduction)
    loss.backward()
    assert torch.isfinite(lt.grad).all()
    assert torch.all(lt.grad[1] == 0)
    assert torch.any(lt.grad[0] != 0)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-6)
