#!/usr/bin/env python3
"""Smoke test of the PyTorch port (wav2vec2forbrain_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, each of which exits nonzero on failure:
  0. device: CUDA with compute capability 9.0, else exit nonzero; prints the
     card's name and power limit; TF32 off for the comparisons.
  1. build: nvcc compiles csrc/*.cu for sm_90a into build/kernels/ (or reuses
     the build of identical sources); prints the seconds and ptxas' usage.
  2. kernels: each hand-written kernel, forward and backward, against its
     plain PyTorch version on the card at the slice's shapes, at f32 and
     bf16 compute, and the attention forward with dropout 0.1 against the
     dense version with the same seed: max-abs error beside its tolerance,
     and the median time of kernel vs plain (CUDA events, after warm-up, L2
     warm).
  3. serving: the full-width conformer-rope-large serving forward (24
     layers, d=1024; random weights from a fixed seed) answers 4 requests of
     32 samples x 384 frames through predict.py with the `auto` policy at
     bf16 compute / f32 activations; launch counts of every forward kernel,
     loss / WER / CER, samples/s; then one batch at f32 through `auto` and
     `none`.
  4. training: train_batches takes 4 full-width train steps (bf16 compute,
     f32 activations, dropout 0.1 everywhere, LayerDrop 0.1, both LR
     groups, Adam) with the `auto` policy: launch counts of all eight
     kernels, steps/s and samples/s, finite losses and params, every
     trainable leaf moved, the BN running stats of every layer that ran
     updated; then one step at f32 compute under `auto` and under `none`
     from the same params, optimizer state and seed streams (dropout on):
     loss, global gradient norm and the updated params against their bounds.
The second-to-last stdout line is the kernels JSON (launch counts from the
training run), the last line {"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
# f32: the same math as the plain version with sums in another order. The
# forward outputs are O(1): absolute bounds. The backward outputs sum up to
# T*B = 2848 (GRU dW), 384 (preproc dW) or 89 (attention, conv dK) products
# and grow with them: bounds relative to the largest output, max(1, |ref|).
TOL_F32 = {"preproc": 1e-5, "gru": 2e-5, "attention": 2e-5, "conv_glu": 1e-5,
           "preproc_bwd": 1e-5, "gru_bwd": 2e-5, "attention_bwd": 2e-5, "conv_glu_bwd": 1e-5}
# bf16 compute: both sides round the same values to bf16, but f32 sums taken
# in another order can flip a bf16 rounding; allow two bf16 ulps of the
# largest output magnitude. The attention mask is bit-identical between the
# kernel and the dense version (the same hash), so dropout 0.1 keeps the
# rate-0 tolerances.
BF16_ULPS = 2.0**-6
AUTO_VS_NONE_F32_BOUND = 1e-3  # logits max-abs, full model at f32
# the f32 train step, `auto` vs `none`, from the same params, Adam state and
# seed streams: the loss and the global gradient norm are sums over the whole
# model of values that differ only in summation order (rel 1e-4); a param
# moves by lr * (m_hat / (sqrt(v_hat) + eps)), and an order-level gradient
# difference moves that by a small fraction of one step: each leaf's max-abs
# difference is held to 0.1 x the LR of its own group (brain 1e-4, w2v 1e-5).
TRAIN_F32_LOSS_REL = 1e-4
TRAIN_F32_GRAD_NORM_REL = 1e-4
TRAIN_F32_PARAM_STEPS = 0.1
N_TRAIN_STEPS = 4
REPLACES = {
    "preproc": "wav2vec2forbrain_tpu/ops/pallas_preproc.py:283",
    "gru": "wav2vec2forbrain_tpu/ops/pallas_gru.py:286",
    "attention": "wav2vec2forbrain_tpu/ops/pallas_attention.py:210",
    "conv_glu": "wav2vec2forbrain_tpu/ops/pallas_conv_glu.py:152",
    "preproc_bwd": "wav2vec2forbrain_tpu/ops/pallas_preproc.py:341",
    "gru_bwd": "wav2vec2forbrain_tpu/ops/pallas_gru.py:323",
    "attention_bwd": "wav2vec2forbrain_tpu/ops/pallas_attention.py:280",
    "conv_glu_bwd": "wav2vec2forbrain_tpu/ops/pallas_conv_glu.py:169",
}
SOURCES = {name: f"wav2vec2forbrain_tpu_torch/csrc/{name.split('_bwd')[0]}.cu" for name in REPLACES}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, label, kernel_fn, plain_fn, tol_of, results):
    """Run kernel and plain on the same inputs, check every output, time;
    append a row. A kernel returning several outputs is held output by
    output; the row keeps the largest error and its tolerance."""
    import torch

    from wav2vec2forbrain_tpu_torch.ops import kernels

    before = kernels.LAUNCHES[name]
    outs = kernel_fn()
    torch.cuda.synchronize()
    if kernels.LAUNCHES[name] != before + 1:
        fail(f"{name} [{label}]: the wrapper did not launch its kernel")
    refs = plain_fn()
    torch.cuda.synchronize()
    if not isinstance(outs, tuple):
        outs, refs = (outs,), (refs,)
    ok, err, tol = True, 0.0, 0.0
    for out, ref in zip(outs, refs):
        out = out.reshape(ref.shape)
        if out.dtype != ref.dtype:
            fail(f"{name} [{label}]: kernel {out.dtype} vs plain {ref.dtype}")
        e = (out.float() - ref.float()).abs().max().item()
        t = tol_of(ref)
        ok = ok and bool(torch.isfinite(out).all().item()) and e <= t
        if e / t >= err / max(tol, 1e-30):
            err, tol = e, t
    ms = timed_ms(kernel_fn)
    plain_ms = timed_ms(plain_fn, iters=5, warmup=1)
    torch.cuda.synchronize()
    print(f"  {name:9s} {label:34s} max_abs_err {err:.3e} (tol {tol:.1e}) "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} [{label}]: kernel disagrees with its plain version ({err} > {tol})")
    results.append(dict(name=name, label=label, err=err, ms=ms, plain_ms=plain_ms))


def kernel_phases(dev, results):
    import torch

    from wav2vec2forbrain_tpu_torch.models.gru import bigru_inputs, init_gru_params
    from wav2vec2forbrain_tpu_torch.models.preprocessing import gaussian_kernel
    from wav2vec2forbrain_tpu_torch.ops import attention, conv_glu, gru, preproc

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32

    def f32_tol(name):
        return lambda ref: TOL_F32[name]

    def f32_rel_tol(name):
        return lambda ref: TOL_F32[name] * max(1.0, ref.float().abs().max().item())

    def bf16_tol(ref):
        return BF16_ULPS * max(1.0, ref.float().abs().max().item())

    def cd_name(cd):
        return str(cd)[6:]

    # 1. preproc: B=32, T=384, days spread over 0..23 (the chain is f32 only)
    x = torch.randn((32, 384, 256), generator=g, device=dev)
    w = torch.eye(256, device=dev)[None] + 0.05 * torch.randn((24, 256, 256), generator=g, device=dev)
    b = 0.1 * torch.randn((24, 1, 256), generator=g, device=dev)
    days = torch.arange(32, device=dev) % 24
    taps = gaussian_kernel(20, 0.3, dev)
    compare("preproc", "B32 T384 f32", lambda: preproc._fwd_kernel(x, w, b, days, taps, 32, 4),
            lambda: preproc.fused_preproc_plain(x, w, b, days, taps), f32_tol("preproc"), results)
    gp = 0.1 * torch.randn((32, 89, 8192), generator=g, device=dev)
    compare("preproc_bwd", "B32 T384 f32", lambda: preproc._bwd_kernel(x, w, b, days, taps, gp, 32, 4),
            lambda: preproc.fused_preproc_bwd_plain(x, w, b, days, taps, gp), f32_rel_tol("preproc_bwd"), results)

    # 2. GRU recurrence: T=89, B=32, H=256, layer-0 and layer-1 gi; H=512/1024 forward too
    for h, layers in ((256, (0, 1)), (512, (0,)), (1024, (0,))):
        params = init_gru_params(g, 8192, h, 2, True, True, False, dev)
        x0 = torch.rand((32, 89, 8192), generator=g, device=dev) * 2 - 1
        x1 = torch.rand((32, 89, 2 * h), generator=g, device=dev) * 2 - 1
        h0 = torch.zeros((2, 32, h), device=dev)
        for layer in layers:
            for cd in (f32, bf16):
                xin = x0 if layer == 0 else x1
                gi, w_hh, b_hh = bigru_inputs(params["layers"][layer]["directions"], xin, cd)
                gi = gi.detach()
                label = f"H{h} layer{layer} {cd_name(cd)}"
                compare("gru", label,
                        lambda: gru._fwd_kernel(gi, w_hh, b_hh, h0, cd),
                        lambda: gru.gru_recurrence_plain(gi, w_hh, b_hh, h0, cd),
                        f32_tol("gru") if cd == f32 else bf16_tol, results)
                if h != 256:
                    continue
                ys = gru.gru_recurrence_plain(gi, w_hh, b_hh, h0, cd)
                gy = torch.randn(ys.shape, generator=g, device=dev)
                compare("gru_bwd", label,
                        lambda: gru._bwd_kernel(gi, w_hh, b_hh, h0, ys, gy, cd),
                        lambda: gru.gru_recurrence_bwd_plain(gi, w_hh, b_hh, h0, ys, gy, cd),
                        f32_rel_tol("gru_bwd") if cd == f32 else bf16_tol, results)

    # 3. attention: B=32, T=89, 16 heads of 64; eval (rate 0) and train (rate 0.1, seed 77)
    for sd in (f32, bf16):
        q, k, v, ga = (torch.randn((32, 89, 1024), generator=g, device=dev).to(sd) for _ in range(4))
        for cd in (f32, bf16):
            if sd == bf16 and cd == f32:
                continue
            for rate in (0.0, 0.1):
                label = f"B32 T89 16x64 io {cd_name(sd)} cd {cd_name(cd)} p{rate}"
                compare("attention", label,
                        lambda: attention._fwd_kernel(q, k, v, 16, 0.125, rate, cd, 77),
                        lambda: attention.mha_dense_bth(q, k, v, 16, 0.125, rate, cd, 77),
                        f32_tol("attention") if cd == f32 else bf16_tol, results)
                compare("attention_bwd", label,
                        lambda: attention._bwd_kernel(q, k, v, ga, 16, 0.125, rate, cd, 77),
                        lambda: attention.mha_bwd_plain(q, k, v, ga, 16, 0.125, rate, cd, 77),
                        f32_rel_tol("attention_bwd") if cd == f32 else bf16_tol, results)

    # 4. GLU -> depthwise conv: B=32, T=89, C=1024, k=31
    wdw = (torch.rand((31, 1024), generator=g, device=dev) * 2 - 1) * (3.0 / 31) ** 0.5
    for sd in (f32, bf16):
        y = torch.randn((32, 89, 2048), generator=g, device=dev).to(sd)
        dz = torch.randn((32, 89, 1024), generator=g, device=dev).to(sd)
        for cd in (f32, bf16):
            if sd == bf16 and cd == f32:
                continue
            label = f"B32 T89 C1024 io {cd_name(sd)} cd {cd_name(cd)}"
            exact = cd == f32 and sd == f32
            compare("conv_glu", label,
                    lambda: conv_glu._fwd_kernel(y, wdw, cd),
                    lambda: conv_glu.glu_dwconv_plain(y, wdw, cd),
                    f32_tol("conv_glu") if exact else bf16_tol, results)
            compare("conv_glu_bwd", label,
                    lambda: conv_glu._bwd_kernel(y, wdw, dz, cd),
                    lambda: conv_glu.glu_dwconv_bwd_plain(y, wdw, dz, cd),
                    f32_rel_tol("conv_glu_bwd") if exact else bf16_tol, results)


def slice_phase(dev, device_name, power):
    import dataclasses

    import numpy as np
    import torch

    from wav2vec2forbrain_tpu_torch.data.batch import to_device
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
    from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec, init_model_params
    from wav2vec2forbrain_tpu_torch.ops import kernels, select
    from wav2vec2forbrain_tpu_torch.predict import predict
    from wav2vec2forbrain_tpu_torch.train.steps import build_eval_step
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    spec = ModelSpec(compute_dtype=torch.bfloat16, activation_dtype=torch.float32)
    t = time.perf_counter()
    params, state = init_model_params(torch.Generator(device=dev).manual_seed(SEED), spec, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"  model: conformer-rope-large (24 x d1024, 16 heads, FFN 4096, k31), "
          f"biGRU 2 x 256, {n_params / 1e6:.1f}M params, init {time.perf_counter() - t:.2f} s")
    batches = make_requests(4, 32, 384, SEED)

    expected_lens = [(b.input_lens - 32) // 4 for b in batches]

    def check(i, preds):
        logits = preds["logits"]
        if logits.shape != (32, 89, 32):
            fail(f"batch {i}: logits shape {logits.shape} != (32, 89, 32)")
        if not np.isfinite(logits).all():
            fail(f"batch {i}: non-finite logits")
        if not np.array_equal(preds["logit_lens"], expected_lens[i]):
            fail(f"batch {i}: logit_lens {preds['logit_lens']} != (input_lens - 32) // 4")
        if not np.isfinite(preds["loss"]) or preds["loss"] <= 0:
            fail(f"batch {i}: CTC loss {preds['loss']} (expected finite and > 0)")

    select.set_kernel_policy("auto")
    predict(params, state, spec, batches[:1])  # warm-up: cuBLAS handles, kernel load
    torch.cuda.synchronize()

    kernels.reset_launches()
    t = time.perf_counter()
    history = predict(params, state, spec, batches, on_batch=check)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    avg = history.get_average()
    n = sum(b.input.shape[0] for b in batches)
    print(f"  predict (auto, bf16 compute, f32 stream): {len(batches)} requests x 32 samples "
          f"in {wall:.3f} s = {n / wall:.1f} samples/s on {device_name} ({power})")
    print(f"  test loss {avg.loss:.4f}  WER {avg.metrics['word_error_rate']:.4f}  "
          f"CER {avg.metrics['char_error_rate']:.4f} (random weights: proves the path, not quality)")
    print(f"  kernel launches in the predict run: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if (v <= 0) != k.endswith("_bwd")]
    if missing:
        fail(f"forward kernels never launched, or backward kernels launched, in serving: {missing}")

    select.set_kernel_policy("none")
    t = time.perf_counter()
    predict(params, state, spec, batches)
    torch.cuda.synchronize()
    wall_none = time.perf_counter() - t
    print(f"  predict (none: plain PyTorch for every kernel): {n / wall_none:.1f} samples/s")

    spec32 = dataclasses.replace(spec, compute_dtype=torch.float32)
    step = build_eval_step(spec32)
    batch = to_device(batches[0], dev)
    logits = {}
    for policy in ("auto", "none"):
        select.set_kernel_policy(policy)
        logits[policy] = step(params, state, batch)[1]
        torch.cuda.synchronize()
    select.set_kernel_policy("auto")
    diff = (logits["auto"] - logits["none"]).abs().max().item()
    print(f"  f32 logits, auto vs none: max_abs_diff {diff:.3e} (bound {AUTO_VS_NONE_F32_BOUND:.0e}), "
          f"max |logit| {logits['none'].abs().max().item():.3f}")
    if not diff <= AUTO_VS_NONE_F32_BOUND:
        fail(f"auto vs none logits differ by {diff}")
    return launches, n / wall, n / wall_none


def _clone(tree):
    from wav2vec2forbrain_tpu_torch.tree import tree_map

    return tree_map(lambda t: None if t is None else t.detach().clone(), tree)


def train_phase(dev, device_name, power):
    """Phase 4; returns the launch counts of the timed training run."""
    import dataclasses

    import numpy as np
    import torch

    from wav2vec2forbrain_tpu_torch.data.batch import to_device
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
    from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
    from wav2vec2forbrain_tpu_torch.ops import kernels, select
    from wav2vec2forbrain_tpu_torch.profile_train import BRAIN_LR, STEP_CFG, W2V_LR, build_trainer
    from wav2vec2forbrain_tpu_torch.train.optim import AdamState
    from wav2vec2forbrain_tpu_torch.train.steps import build_grad_fn
    from wav2vec2forbrain_tpu_torch.train.train_loop import train_batches
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves, tree_leaves_with_path as leaves

    select.set_kernel_policy("auto")
    t = time.perf_counter()
    tr = build_trainer(dev, SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(tr.params))
    print(f"  model: conformer-rope-large (24 x d1024), biGRU 2 x 256, {n_params / 1e6:.1f}M params; "
          f"bf16 compute, f32 stream, dropout 0.1, LayerDrop 0.1, Adam; init {time.perf_counter() - t:.2f} s")
    batches = make_requests(N_TRAIN_STEPS + 1, 32, 384, SEED + 1)
    rng = StepRng(SEED, dev)
    # warm-up step: cuBLAS handles, the kernels' first launches, Adam state
    run = train_batches(tr.train_step, tr.params, tr.opt_state, tr.state, batches[:1], rng, BRAIN_LR, W2V_LR)
    torch.cuda.synchronize()
    before = dict(leaves(_clone(tr.params)))
    bn_before = _clone(run.model_state)

    kernels.reset_launches()
    t = time.perf_counter()
    run = train_batches(tr.train_step, tr.params, run.opt_state, run.model_state, batches[1:], rng,
                        BRAIN_LR, W2V_LR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    n = sum(b.input.shape[0] for b in batches[1:])
    print(f"  train_batches (auto): {run.steps} steps x 32 samples in {wall:.3f} s = "
          f"{run.steps / wall:.3f} steps/s, {n / wall:.1f} samples/s on {device_name} ({power})")
    losses = [m.loss for m in run.history.metrics]
    avg = run.history.get_average()
    print(f"  train losses {[round(x, 4) for x in losses]}  WER {avg.metrics['word_error_rate']:.4f}  "
          f"CER {avg.metrics.get('char_error_rate', float('nan')):.4f}")
    print(f"  kernel launches in the train run: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"kernels never launched in the train run: {missing}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite train loss {losses}")

    # which layers ran in some step (LayerDrop decisions of every step, warm-up included)
    masks = [f.enc.layerdrop_drawn[0] for f in rng.forwards]
    ran = [not all(m[i] for m in masks) for i in range(len(masks[0]))]
    print(f"  LayerDrop: layers dropped per step {[[i for i, d in enumerate(m) if d] for m in masks]}")
    label_of = dict(leaves(tr.labels))
    unmoved = []
    for path, p in leaves(tr.params):
        if not bool(torch.isfinite(p).all()):
            fail(f"non-finite parameter after training: {path}")
        moved = not torch.equal(p, before[path])
        layer = _layer_of(path)
        expect = label_of[path] != "frozen" and "/pos_conv/" not in path and (layer is None or ran[layer])
        if moved != expect:
            unmoved.append((path, moved, expect))
    if unmoved:
        fail(f"params moved (or stayed) against expectation: {unmoved[:8]} ({len(unmoved)} in all)")
    for i, (new, old) in enumerate(zip(run.model_state["encoder"]["layers"], bn_before["encoder"]["layers"])):
        changed = not torch.equal(new["batch_norm"]["mean"], old["batch_norm"]["mean"])
        if changed != ran[i]:
            fail(f"layer {i}: BN running stats {'changed' if changed else 'unchanged'} but the layer "
                 f"{'ran' if ran[i] else 'was dropped in every step'}")
    print(f"  every trainable leaf moved (dead pos_conv and layers dropped in every step excepted), "
          f"frozen leaves did not; BN stats updated in the {sum(ran)} layers that ran")

    # one f32 step under `auto` and under `none` from the same state and seed streams
    spec32 = dataclasses.replace(tr.spec, compute_dtype=torch.float32)
    batch = to_device(batches[-1], dev)
    res = {}
    for policy in ("auto", "none"):
        select.set_kernel_policy(policy)
        params = _clone(tr.params)
        state = _clone(run.model_state)
        opt_state = AdamState(run.opt_state.count, _clone(run.opt_state.mu), _clone(run.opt_state.nu))
        grad_fn = build_grad_fn(spec32, tr.labels, STEP_CFG)
        out, grads, norm = grad_fn(params, state, batch, StepRng(SEED + 7, dev))
        if not all(bool(torch.isfinite(gr).all()) for gr in tree_leaves(grads)):
            fail(f"non-finite gradient at f32 under {policy}")
        tr.optimizer.step(params, grads, opt_state, BRAIN_LR, W2V_LR)
        torch.cuda.synchronize()
        res[policy] = (float(out["loss"].detach()), float(norm), params)
        del out, grads
    select.set_kernel_policy("auto")
    (la, na, pa), (ln, nn, pn) = res["auto"], res["none"]
    loss_rel, norm_rel = abs(la - ln) / abs(ln), abs(na - nn) / abs(nn)
    # each leaf against 0.1 x its own group's LR; the worst leaf of each group
    lr_of = {"brain": BRAIN_LR, "w2v": W2V_LR}
    worst = {}  # group -> (ratio to its bound, max-abs, path)
    for (path, a), (_, b) in zip(leaves(pa), leaves(pn)):
        d = (a - b).abs().max().item()
        label = label_of[path]
        ratio = d / (TRAIN_F32_PARAM_STEPS * lr_of[label]) if label in lr_of else (0.0 if d == 0 else float("inf"))
        if label not in worst or ratio > worst[label][0]:
            worst[label] = (ratio, d, path)
    print(f"  f32 step, auto vs none: loss {la:.6f} vs {ln:.6f} (rel {loss_rel:.2e}, bound {TRAIN_F32_LOSS_REL:.0e}); "
          f"grad norm {na:.6f} vs {nn:.6f} (rel {norm_rel:.2e}, bound {TRAIN_F32_GRAD_NORM_REL:.0e})")
    for label, (ratio, d, path) in sorted(worst.items()):
        bound = TRAIN_F32_PARAM_STEPS * lr_of.get(label, 0.0)
        print(f"  updated params, group {label}: max-abs {d:.3e} at {path} (bound {bound:.1e}, "
              f"{ratio:.3f} of it)")
    if not (loss_rel <= TRAIN_F32_LOSS_REL and norm_rel <= TRAIN_F32_GRAD_NORM_REL
            and all(r <= 1.0 for r, _, _ in worst.values())):
        fail("the f32 train step differs between `auto` and `none` beyond its bounds")
    return launches, run.steps / wall, n / wall


def _layer_of(path):
    """The conformer layer index of a param path, or None."""
    parts = path.split("/")
    if "encoder" in parts and "layers" in parts:
        return int(parts[parts.index("layers") + 1])
    return None


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test runs on a CUDA card only")
    if torch.cuda.get_device_capability(0) != (9, 0):
        fail(f"needs compute capability 9.0 (Hopper), found {torch.cuda.get_device_capability(0)}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from wav2vec2forbrain_tpu_torch.ops import kernels
    except ImportError as e:
        fail(f"the port package is not beside this script ({e})")

    dev = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    power = smi.stdout.strip()
    print(power)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("[1] build")
    kernels.lib(verbose=True)
    info = kernels.build_info
    print(f"  {info['path']} ({'cached' if info['cached'] else 'built'} in {info['seconds']:.1f} s)")
    for line in info["log"].splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    print("[2] kernels vs plain on the card")
    results = []
    kernel_phases(dev, results)
    torch.cuda.synchronize()

    print("[3] serving: conformer-rope-large forward")
    serve_launches, sps, sps_none = slice_phase(dev, device_name, power)
    torch.cuda.synchronize()

    print("[4] training: conformer-rope-large train steps")
    launches, steps_ps, train_sps = train_phase(dev, device_name, power)
    torch.cuda.synchronize()

    # the row of each kernel is timed at the training run's configuration:
    # bf16 compute, f32 activation stream, dropout 0.1
    slice_labels = {
        "preproc": "B32 T384 f32",
        "gru": "H256 layer0 bfloat16",
        "attention": "B32 T89 16x64 io float32 cd bfloat16 p0.1",
        "conv_glu": "B32 T89 C1024 io float32 cd bfloat16",
    }
    slice_labels.update({f"{k}_bwd": v for k, v in slice_labels.items()})
    rows = []
    for name, label in slice_labels.items():
        mine = [r for r in results if r["name"] == name]
        at = next(r for r in mine if r["label"] == label)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(r["err"] for r in mine),
            "ms": at["ms"],
            "plain_ms": at["plain_ms"],
        })
    print(f"serving samples/s: auto {sps:.2f}  none {sps_none:.2f}; serving launches {json.dumps(serve_launches)}")
    print(f"training: {steps_ps:.3f} steps/s, {train_sps:.2f} samples/s on {power}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
