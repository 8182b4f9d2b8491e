"""train/train_loop.py::train_batches on a tiny conformer on CPU.

It must take the same steps as calling the train step by hand with the same
StepRng (so the same dropout seeds, LayerDrop decisions and augmentation
noise): losses, params, Adam moments and BatchNorm state exactly equal. Its
per-step history (loss, greedy WER/CER of the train predictions) must equal
the JAX package's train evaluator fed the same predictions and batches, as
the JAX Trainer's _train_epoch feeds it."""

import numpy as np
import torch

from wav2vec2forbrain_tpu.data.tokenizer import Wav2Vec2CTCTokenizer as JaxTokenizer
from wav2vec2forbrain_tpu.train.evaluator import EvaluatorWithLMDecoder as JaxEvaluator
from wav2vec2forbrain_tpu_torch.data.batch import to_device
from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec, init_model_params, param_labels
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
from wav2vec2forbrain_tpu_torch.train.optim import make_optimizer
from wav2vec2forbrain_tpu_torch.train.steps import StepConfig, build_train_step
from wav2vec2forbrain_tpu_torch.train.train_loop import train_batches
from wav2vec2forbrain_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)
BRAIN_LR, W2V_LR = 1e-3, 1e-4


def _setup():
    spec = ModelSpec(gru_hidden_size=64, latent_size=96, gru_dropout=0.1,
                     conformer_cfg=ConformerEncoderConfig.tiny_test(hidden_act="swish", layerdrop=0.3))
    params, state = init_model_params(torch.Generator().manual_seed(0), spec, "cpu")
    labels = param_labels(params, "brain_encoder+w2v")
    opt = make_optimizer(labels)
    step = build_train_step(spec, labels, opt, StepConfig(None, 0.02, 0.25))
    return params, state, opt, step


def test_train_batches_equals_the_steps_by_hand_and_the_jax_train_evaluator():
    batches = make_requests(3, 4, 160, seed=0)

    params, state, opt, step = _setup()
    run = train_batches(step, params, opt.init(params), state, batches, StepRng(5, "cpu"), BRAIN_LR, W2V_LR)

    p2, s2, opt2, step2 = _setup()
    o2, rng = opt2.init(p2), StepRng(5, "cpu")
    jax_eval = JaxEvaluator(JaxTokenizer(), "train", lm_decoder=None)
    for host_batch in batches:
        out = step2(p2, o2, s2, to_device(host_batch, "cpu"), rng, BRAIN_LR, W2V_LR)
        o2, s2 = out.opt_state, out.model_state
        jax_eval.track_batch({"loss": float(out.loss), "pred_ids": out.pred_ids.numpy(),
                              "logit_lens": out.logit_lens.numpy()}, host_batch)

    assert run.steps == 3 and run.opt_state.count == 3
    for a, b in zip(tree_leaves(params) + tree_leaves(run.opt_state.mu) + tree_leaves(run.model_state),
                    tree_leaves(p2) + tree_leaves(o2.mu) + tree_leaves(s2)):
        assert torch.equal(a, b)
    ref = jax_eval.evaluate()
    got = run.history
    assert len(got.metrics) == len(ref.metrics) == 3
    for g, r in zip(got.metrics + [got.get_average()], ref.metrics + [ref.get_average()]):
        assert g.loss == r.loss and np.isfinite(g.loss)
        assert g.metrics == r.metrics
        assert set(g.metrics) == {"word_error_rate", "char_error_rate"}
