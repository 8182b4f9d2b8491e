#!/usr/bin/env python3
"""Smoke test of the PyTorch port (wav2vec2forbrain_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, each of which exits nonzero on failure:
  0. device: CUDA with compute capability 9.0, else exit nonzero; prints the
     card's name and power limit; TF32 off for the comparisons.
  1. build: nvcc compiles csrc/*.cu for sm_90a into build/kernels/ (or reuses
     the build of identical sources); prints the seconds and ptxas' usage.
  2. kernels: each hand-written kernel, forward and backward, against its
     plain PyTorch version on the card at both main paths' shapes, at f32
     and bf16 compute: preproc at B=32 (conformer, smoothing sigma 0.3) and
     B=64 (wav2vec2-base sweep, sigma 1.5); the GRU at H=256 through the
     fused entry (its forward one cluster-resident launch) with B=32 for the
     conformer and B=64 for the sweep grid's H=256 points, and, through its
     per-direction entry (one launch per step), at H=512 and 1024 with B=64
     for the sweep and at a ragged H=600 (the per-direction backward also
     timed without its f32 dW product); every GRU forward row's time per
     step printed; attention at T'=89, B=32, 16 heads, scale
     1/8 (conformer) and B=64, 12 heads, q pre-scaled by 1/8 and scale 1
     (wav2vec2-base), with dropout 0 and 0.1 against the dense version with
     the same seed (forward and backward on the tensor cores: bf16 products
     at bf16 compute, split-TF32 products at f32 compute), and at T'=169
     (about 700 frames) and T'=400, B=8 (about 1,600 frames: the forwards
     stream their key tiles there), at bf16 compute with dropout 0.1 and at
     f32 compute with dropout 0 and 0.1; GLU -> depthwise conv at B=32
     T=89 and at B=8 with T=169 and 400 (several of the backward's time
     chunks); the LayerNorm at both encoders'
     shapes with an f32 and a bf16 stream (the vector kernel at C 768 and
     1024). Each row: max-abs error beside its tolerance; the kernel's
     device time with the queue kept full (`device_ms`: calls queued behind
     a spin kernel run back to back, so the host's launch overhead drops
     out; where queueing outlasts the longest spin, the row is marked
     "starved" and the kernel and its library call are also timed as the
     sum of their kernels' device times per call from torch.profiler,
     `profiler_ms`) and its time per lone call (CUDA events around one call after the queue
     drained, the host's launch overhead included); the plain
     version's time per call; the bound (the larger of the bytes over 3.35
     TB/s and the operations over the peak rate of their type) and, where
     one PyTorch call computes the same function, that call's time both ways
     (SDPA at rate 0, F.layer_norm, and for the GRU a bidirectional cuDNN
     nn.GRU fed gi through an identity W_ih: an upper bound, as it adds
     that projection). L2 warm throughout. The fused GRU backward's rows
     are followed by a split: each kernel's own device time per call
     (torch.profiler; without the gaps between launches).
  3. conformer serving: the full-width conformer-rope-large serving forward
     (24 layers, d=1024; random weights from a fixed seed) answers 4
     requests of 32 samples x 384 frames through predict.py with the `auto`
     policy at bf16 compute / f32 activations; launch counts of every
     forward kernel of the path, loss / WER / CER, samples/s, then the same
     under `none`; then one batch at f32 through `auto` and `none`.
  4. conformer training: train_batches takes 4 full-width train steps (bf16
     compute, f32 activations, dropout 0.1 everywhere, both LR groups, Adam)
     with the `auto` policy, its LayerDrop replayed so that encoder layer
     DROPPED_LAYER is dropped in every step (warm-up included) and every
     other layer runs: launch counts of every kernel of the path, steps/s
     and samples/s, finite losses and params, every trainable leaf of a
     layer that ran moved and those of the dropped layer moved only by
     weight decay, the BN running stats updated exactly in the layers that
     ran; then one step at f32 compute under `auto` (its launch counts
     printed) and under `none` from the same params, optimizer state and
     seed streams (dropout on, the same layer dropped): loss, global
     gradient norm and the updated params against their bounds.
  5. wav2vec2-base serving: phase 3 for `b2p2t_gru+w2v` at the fft sweep
     point (wav2vec2-base-960h: 12 post-LN layers, d=768, 12 heads, FFN
     3072; biGRU 3 x 1024, latent 768), 4 requests of 64 x 384.
  6. wav2vec2-base training: phase 4 for the same model (GRU dropout 0.45,
     Adam at weight decay 1e-4), 4 steps of 64 x 384.
The counts are set to 0 just before each phase's timed run and read just
after it. The second-to-last stdout line is the kernels JSON (one row per
kernel; launches summed over the two training runs; `profiler_ms` and
`library_profiler_ms` null unless the row's device_ms was starved), the
last line {"ok": true, "device": {...}}.
"""

import itertools
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
# f32: the same math as the plain version with sums in another order. The
# forward outputs are O(1): absolute bounds. The backward outputs sum up to
# T*B = 5696 (GRU dW), 384 (preproc dW) or 89 (attention, conv dK, LN
# partials) products and grow with them: bounds relative to the largest
# output, max(1, |ref|).
TOL_F32 = {"preproc": 1e-5, "gru": 2e-5, "attention": 2e-5, "conv_glu": 1e-5, "layernorm": 1e-5,
           "preproc_bwd": 1e-5, "gru_bwd": 2e-5, "attention_bwd": 2e-5, "conv_glu_bwd": 1e-5,
           "layernorm_bwd": 2e-5}
TOL_F32.update(gru_dir=TOL_F32["gru"], gru_dir_bwd=TOL_F32["gru_bwd"])
# at logits 8x larger (phase 2's precision rows) two f32 versions of attention each carry f32
# rounding of s amplified by exp: each is held against the f64 result instead, the kernel to within
# this factor of the plain f32 version's own error (split TF32 keeps ~22 bits of a product, f32 24)
F32_CLASS_FACTOR = 2.0
DROPPED_LAYER = 1  # phases 4 and 6: the encoder layer LayerDrop drops in every train step
# bf16 compute or a bf16 stream: both sides round the same values to bf16,
# but f32 sums taken in another order can flip a bf16 rounding; allow two
# bf16 ulps of the largest output magnitude. The attention mask is
# bit-identical between the kernel and the dense version (the same hash),
# so dropout 0.1 keeps the rate-0 tolerances.
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
N_REQUESTS = N_TRAIN_STEPS = 4
LN_EPS = 1e-5
# the bound's rates (NVIDIA's data sheet for the H100 SXM, at 700 W)
HBM_BYTES_PER_S = 3.35e12
# f32 outside the tensor cores; bf16 tensor cores; f32 products on the TF32 tensor cores (495 TFLOP/s) as
# three TF32 products each (the split-TF32 attention kernels at f32 compute)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
_PALLAS = "wav2vec2forbrain_tpu/ops/"
REPLACES = {
    "preproc": _PALLAS + "pallas_preproc.py:283",
    "preproc_bwd": _PALLAS + "pallas_preproc.py:341",
    "gru": _PALLAS + "pallas_gru.py:286",
    "gru_bwd": _PALLAS + "pallas_gru.py:323",
    "gru_dir": _PALLAS + "pallas_gru.py:643",
    "gru_dir_bwd": _PALLAS + "pallas_gru.py:694",
    "attention": _PALLAS + "pallas_attention.py:210",
    "attention_bwd": _PALLAS + "pallas_attention.py:280",
    "conv_glu": _PALLAS + "pallas_conv_glu.py:152",
    "conv_glu_bwd": _PALLAS + "pallas_conv_glu.py:169",
    "layernorm": _PALLAS + "pallas_layernorm.py:100",
    "layernorm_bwd": _PALLAS + "pallas_layernorm.py:115",
}
SOURCES = {name: "wav2vec2forbrain_tpu_torch/csrc/{}.cu".format(name.split("_bwd")[0].replace("gru_dir", "gru"))
           for name in REPLACES}
# the kernels each main path must launch (backward kernels only in training)
PATH_KERNELS = {
    "conformer": ("preproc", "gru", "attention", "conv_glu", "layernorm"),
    "w2v": ("preproc", "gru_dir", "attention", "layernorm"),
}
# the configuration each row of the kernels JSON is timed at: a training run's
ROW_LABELS = {
    "preproc": "B32 T384 sigma0.3 f32",
    "gru": "H256 B32 layer0 bfloat16",
    "gru_dir": "H1024 B64 layer0 bfloat16",
    "attention": "B32 T89 16x64 scale0.125 io float32 cd bfloat16 p0.1",
    "conv_glu": "B32 T89 C1024 io float32 cd bfloat16",
    "layernorm": "B64 T89 C768 float32",
}
ROW_LABELS.update({f"{k}_bwd": v for k, v in list(ROW_LABELS.items())})
FAMILY_NAMES = {
    "conformer": "b2p2t_gru+w2v_conformer: conformer-rope-large (24 x d1024, 16 heads, FFN 4096, k31), biGRU 2 x 256",
    "w2v": "b2p2t_gru+w2v: wav2vec2-base-960h (12 x d768 post-LN, 12 heads, FFN 3072), biGRU 3 x 1024",
}


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


_SPIN_MS_PER_CYCLE = []  # device ms per cycle of torch.cuda._sleep, measured once


def device_ms(fn, reps: int = 10, trials: int = 5):
    """(ms, starved): the device time of fn() in ms with the queue kept full:
    the stream is held by a spin kernel while reps calls are queued behind
    it, so the calls run back to back and the host's launch overhead drops
    out (as it does in a device-bound step). Median over trials of (end -
    start) / reps. A trial in which queueing took longer on the host clock
    than the spin lasted on the device is run again with a longer spin;
    after the longest one it is kept and `starved` is True: either the
    launch queue was full (many launches a call, as the per-direction
    GRU's: the device was busy throughout) or the host was slower than the
    device (host time is in it). compare() then also takes profiler_ms."""
    import torch

    if not _SPIN_MS_PER_CYCLE:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        b.synchronize()
        _SPIN_MS_PER_CYCLE.append(a.elapsed_time(b) / 20_000_000)
        print(f"  (device_ms: a spin of 2e7 cycles holds the stream {a.elapsed_time(b):.3f} ms)")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, spin, starved_any = [], 5_000_000, False
    while len(times) < trials:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        starved = 1e3 * (time.perf_counter() - t0) > spin * _SPIN_MS_PER_CYCLE[0]
        end.synchronize()
        if starved and spin < 500_000_000:
            spin *= 4
            continue
        starved_any = starved_any or starved
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), starved_any


def _device_kernels(fn, reps: int):
    """[(device us per call, launches per call, name)] of every kernel and
    copy that fn() runs on the card, largest first (torch.profiler over reps
    calls; each kernel's own time, without the gaps between launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wav2vec2forbrain_tpu_torch.profile_predict import _device_us, _on_device

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted(((_device_us(e) / reps, e.count // reps, e.key) for e in prof.key_averages() if _on_device(e)),
                  reverse=True)


def profiler_ms(fn, reps: int = 5) -> float:
    """The device time of fn() in ms as the sum of its kernels' own device
    times per call (torch.profiler): the second measure of a row whose
    device_ms trial ended starved. It leaves out the gaps between launches."""
    return sum(us for us, _, _ in _device_kernels(fn, reps)) / 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(bytes_moved, flops):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their type's peak; flops is a list
    of (count, dtype name)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[dt] for n, dt in flops)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def compare(name, label, kernel_fn, plain_fn, tol_of, results, inputs, flops, library_fn=None):
    """Run kernel and plain on the same inputs, check every output, time;
    append a row. A kernel returning several outputs is held output by
    output; the row keeps the largest error and its tolerance. The bound
    counts `inputs` read once and the kernel's outputs written once."""
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
    bound, bound_by = bound_ms(nbytes(*inputs, *outs), flops)
    del outs, refs
    ms, starved = device_ms(kernel_fn)
    call_ms = timed_ms(kernel_fn)
    plain_ms = timed_ms(plain_fn, iters=5, warmup=1)
    library_ms, library_starved = (None, False) if library_fn is None else device_ms(library_fn)
    library_call_ms = None if library_fn is None else timed_ms(library_fn)
    # a starved trial has host time in it: time the kernel and the library a second way
    prof_ms = library_prof_ms = None
    if starved or library_starved:
        prof_ms = profiler_ms(kernel_fn)
        library_prof_ms = None if library_fn is None else profiler_ms(library_fn)
    torch.cuda.synchronize()

    def mark(is_starved, prof):
        return "" if prof is None else f" [{'starved; ' if is_starved else ''}profiler {prof:.4f}]"

    lib = ("" if library_ms is None else
           f"  library {library_ms:.4f} ms{mark(library_starved, library_prof_ms)} (call {library_call_ms:.4f})")
    print(f"  {name:13s} {label:42s} max_abs_err {err:.3e} (tol {tol:.1e}) kernel {ms:.4f} ms"
          f"{mark(starved, prof_ms)} (call {call_ms:.4f})  plain {plain_ms:.4f} ms{lib}  "
          f"bound {bound:.4f} ms ({bound_by})  {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} [{label}]: kernel disagrees with its plain version ({err} > {tol})")
    results.append(dict(name=name, label=label, err=err, ms=ms, profiler_ms=prof_ms, call_ms=call_ms,
                        plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=library_ms,
                        library_profiler_ms=library_prof_ms))


def kernel_split(label, fn, reps: int = 5, top: int = 6) -> None:
    """Print the device time of each kernel that fn() launches, per call
    (torch.profiler over reps calls; each kernel's own time, without the
    gaps between launches)."""
    rows = _device_kernels(fn, reps)
    parts = "; ".join(f"{name[:48]} {us / 1e3:.4f} ms x{n}" for us, n, name in rows[:top])
    print(f"  {'':13s} {label:42s} split: {parts}")


def cudnn_gru(gi, w_hh, b_hh, h0, gy, cd, ys):
    """The library yardstick of the GRU rows: (forward, backward) of one
    bidirectional nn.GRU call (cuDNN) that computes the recurrence on gi.
    Its input is [gi_fwd, gi_bwd flipped in time] (T, B, 6H); each
    direction's W_ih is the identity on its half, b_ih = 0. That input
    projection (and its weight gradient) is work the kernel does not do, so
    the times are upper bounds of the library's. The f32 forward is held to
    the plain ys, which checks the construction. A bf16 nn.GRU that the
    installed torch refuses gives (None, None)."""
    import torch

    t, _, b, h = ys.shape
    flip = lambda x: torch.flip(x, dims=(0,))  # noqa: E731
    mod = torch.nn.GRU(6 * h, h, bidirectional=True, device=gi.device, dtype=cd)
    mod.flatten_parameters()  # one weight buffer, as cuDNN wants it
    with torch.no_grad():
        eye = torch.eye(3 * h, device=gi.device)
        for d, sfx in enumerate(("", "_reverse")):
            w_ih = torch.zeros((3 * h, 6 * h), device=gi.device)
            w_ih[:, 3 * h * d: 3 * h * (d + 1)] = eye
            getattr(mod, "weight_ih_l0" + sfx).copy_(w_ih)
            getattr(mod, "weight_hh_l0" + sfx).copy_(w_hh[d].t())
            getattr(mod, "bias_ih_l0" + sfx).zero_()
            getattr(mod, "bias_hh_l0" + sfx).copy_(b_hh[d].reshape(-1))
        del eye, w_ih
    inp = torch.cat([gi[:, 0], flip(gi[:, 1])], dim=-1).to(cd).requires_grad_(True)
    hx = h0.to(cd)
    g_out = torch.cat([gy[:, 0], flip(gy[:, 1])], dim=-1).to(cd)
    try:
        out, _ = mod(inp, hx)
    except RuntimeError as e:
        if cd == torch.float32:
            raise
        print(f"  (no library time: nn.GRU at {cd} raised {str(e).splitlines()[0]})")
        return None, None
    if cd == torch.float32:
        got = torch.stack([out[..., :h], flip(out[..., h:])], dim=1)
        err = (got - ys).abs().max().item()
        if not err <= 1e-3:
            fail(f"the cuDNN GRU yardstick does not compute the recurrence (max-abs {err} vs plain)")
    leaves = [inp, *mod.parameters()]

    def fwd():
        with torch.no_grad():
            return mod(inp, hx)

    return fwd, lambda: torch.autograd.grad(out, leaves, g_out, retain_graph=True)


def kernel_phases(dev, results):
    import torch
    import torch.nn.functional as F

    from wav2vec2forbrain_tpu_torch.models.gru import bigru_inputs, init_gru_params
    from wav2vec2forbrain_tpu_torch.models.preprocessing import gaussian_kernel
    from wav2vec2forbrain_tpu_torch.ops import attention, conv_glu, gru, layernorm, preproc

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

    def preproc_rows(gen, batch, sigma):
        """preproc at T=384, days spread over 0..23 (the chain is f32 only)."""
        x = torch.randn((batch, 384, 256), generator=gen, device=dev)
        w = torch.eye(256, device=dev)[None] + 0.05 * torch.randn((24, 256, 256), generator=gen, device=dev)
        b = 0.1 * torch.randn((24, 1, 256), generator=gen, device=dev)
        days = torch.arange(batch, device=dev) % 24
        taps = gaussian_kernel(20, sigma, dev)
        affine, smooth = 2 * x.numel() * 256, 2 * x.numel() * taps.numel()
        label = f"B{batch} T384 sigma{sigma} f32"
        compare("preproc", label, lambda: preproc._fwd_kernel(x, w, b, days, taps, 32, 4),
                lambda: preproc.fused_preproc_plain(x, w, b, days, taps), f32_tol("preproc"), results,
                (x, w, b, days, taps), [(affine + smooth, "float32")])
        gp = 0.1 * torch.randn((batch, 89, 8192), generator=gen, device=dev)
        # dx through W^T and the per-sample dW: two affine-sized products; the smoothing and its adjoint
        compare("preproc_bwd", label, lambda: preproc._bwd_kernel(x, w, b, days, taps, gp, 32, 4),
                lambda: preproc.fused_preproc_bwd_plain(x, w, b, days, taps, gp), f32_rel_tol("preproc_bwd"),
                results, (x, w, b, days, taps, gp), [(2 * affine + 2 * smooth, "float32")])

    def attention_rows(gen, batch, heads, scale, q_scale, t=89, rows=None):
        """attention at T'=t, heads of 64, eval (rate 0) and train (rate 0.1,
        seed 77); q is multiplied by q_scale in the stream dtype first (the
        wav2vec2 encoder's pre-scaling); rows: the (stream, compute dtype,
        rate) triples to run. The library call: F.scaled_dot_product_attention
        at rate 0 (forward, and its backward), in the stream dtype (at f32 its
        memory-efficient kernel, split TF32 on the tensor cores)."""
        width = 64 * heads
        for sd in (f32, bf16):
            if rows is not None and all(sd != o[0] for o in rows):
                continue
            q, k, v, ga = (torch.randn((batch, t, width), generator=gen, device=dev).to(sd) for _ in range(4))
            q = q * q_scale
            hs = [x.view(batch, t, heads, 64).transpose(1, 2) for x in (q, k, v, ga)]
            leaves = [t.detach().requires_grad_(True) for t in hs[:3]]
            sdpa_out = F.scaled_dot_product_attention(*leaves, scale=scale)
            sdpa_fwd = lambda: F.scaled_dot_product_attention(*hs[:3], scale=scale)  # noqa: E731
            sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, leaves, hs[3], retain_graph=True)  # noqa: E731
            qkt = 2 * batch * heads * t * t * 64  # one (T, D) x (D, T) product per (batch, head)
            for cd in (f32, bf16):
                if sd == bf16 and cd == f32:
                    continue
                for rate in (0.0, 0.1):
                    if rows is not None and (sd, cd, rate) not in rows:
                        continue
                    label = f"B{batch} T{t} {heads}x64 scale{scale:g} io {cd_name(sd)} cd {cd_name(cd)} p{rate}"
                    op = "tf32x3" if cd == f32 else cd_name(cd)  # f32 products run as three TF32 ones
                    compare("attention", label,
                            lambda: attention._fwd_kernel(q, k, v, heads, scale, rate, cd, 77),
                            lambda: attention.mha_dense_bth(q, k, v, heads, scale, rate, cd, 77),
                            f32_tol("attention") if cd == f32 else bf16_tol, results,
                            (q, k, v), [(2 * qkt, op)], sdpa_fwd)
                    compare("attention_bwd", label,
                            lambda: attention._bwd_kernel(q, k, v, ga, heads, scale, rate, cd, 77),
                            lambda: attention.mha_bwd_plain(q, k, v, ga, heads, scale, rate, cd, 77),
                            f32_rel_tol("attention_bwd") if cd == f32 else bf16_tol, results,
                            (q, k, v, ga), [(5 * qkt, op)], sdpa_bwd)
            del sdpa_out

    def attention_f64(q, k, v, ga, heads, scale, rate, seed):
        """(o, dq, dk, dv) of the attention function in f64 on f64 copies of
        its operands: the exact result that the f32 versions round."""
        b, t, width = q.shape
        qh, kh, vh, gh = (x.double().view(b, t, heads, width // heads).transpose(1, 2).reshape(b * heads, t, -1)
                          for x in (q, k, v, ga))
        p = torch.softmax(torch.bmm(qh, kh.transpose(1, 2)) * scale, dim=-1)
        masked = attention._scaled_mask(seed, b, heads, t, rate, q.device)
        mask = None if masked is None else masked[0].double() * masked[1]
        pd = p if mask is None else p * mask
        dp = torch.bmm(gh, vh.transpose(1, 2))
        dp = dp if mask is None else dp * mask
        ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
        outs = (torch.bmm(pd, vh), torch.bmm(ds, kh) * scale, torch.bmm(ds.transpose(1, 2), qh) * scale,
                torch.bmm(pd.transpose(1, 2), gh))
        return [attention._unheads(x, b, heads, torch.float64) for x in outs]

    def attention_precision_rows(gen, batch, heads, t=89):
        """f32 compute at logits 8x those of the other rows: the w2v shape at
        scale 1 with q not pre-scaled, so s = q.k over 64 unit normals (std 8),
        where the f32 rounding of s moves p by 8x more. The kernel, the plain
        version and SDPA at f32 (rate 0), each against the f64 result; the
        kernel and SDPA against the plain version, the kernel's distance beside
        TOL_F32 (abs for the output, relative to the largest one for the
        gradients), which it may exceed here. Fails unless each of the
        kernel's outputs is within F32_CLASS_FACTOR x the plain f32 version's
        own error of the f64 result."""
        width = 64 * heads
        q, k, v, ga = (torch.randn((batch, t, width), generator=gen, device=dev) for _ in range(4))
        hs = [x.view(batch, t, heads, 64).transpose(1, 2) for x in (q, k, v)]
        leaves = [x.detach().requires_grad_(True) for x in hs]
        for rate in (0.0, 0.1):
            args = (heads, 1.0, rate, f32, 77)
            exact = attention_f64(q, k, v, ga, heads, 1.0, rate, 77)
            kern = [attention._fwd_kernel(q, k, v, *args), *attention._bwd_kernel(q, k, v, ga, *args)]
            plain = [attention.mha_dense_bth(q, k, v, *args), *attention.mha_bwd_plain(q, k, v, ga, *args)]
            sdpa = None
            if rate == 0.0:  # SDPA's dropout is not the hash mask
                out = F.scaled_dot_product_attention(*leaves, scale=1.0)
                grads = torch.autograd.grad(out, leaves, ga.view(batch, t, heads, 64).transpose(1, 2))
                sdpa = [x.transpose(1, 2).reshape(batch, t, width) for x in (out, *grads)]
            for i, what in enumerate(("o", "dq", "dk", "dv")):
                def err(x):
                    return (x.double() - exact[i]).abs().max().item()
                vs_plain = (kern[i] - plain[i]).abs().max().item()
                tol = TOL_F32["attention"] if i == 0 else f32_rel_tol("attention_bwd")(plain[i])
                k64, p64 = err(kern[i]), err(plain[i])
                lib = ("" if sdpa is None else
                       f" sdpa {err(sdpa[i]):.3e} (sdpa vs plain {(sdpa[i] - plain[i]).abs().max().item():.3e})")
                ok = k64 <= F32_CLASS_FACTOR * p64
                print(f"  {'attention':13s} {f'B{batch} T{t} {heads}x64 scale1 logits x8 f32 p{rate} {what}':42s} "
                      f"vs f64: kernel {k64:.3e} plain {p64:.3e}{lib}; kernel vs plain {vs_plain:.3e} "
                      f"({'within' if vs_plain <= tol else 'over'} TOL_F32 {tol:.1e})  {'ok' if ok else 'LESS ACCURATE'}")
                if not ok:
                    fail(f"attention logits x8 p{rate} {what}: kernel {k64} off the f64 result, over "
                         f"{F32_CLASS_FACTOR} x the plain f32 version's {p64}")
            del exact, kern, plain, sdpa

    # 1. preproc: B=32 with the conformer's smoothing (sigma 0.3)
    preproc_rows(g, 32, 0.3)

    # 2. GRU recurrence, T=89: H=256, B=32 (conformer; layer-0 and layer-1
    # gi) and B=64 (the sweep grid's H=256 points) through gru_recurrence;
    # H=512 and 1024, B=64 (wav2vec2-base sweep) through the per-direction
    # entry, whose dW_hh product is f32
    for h, batch, layers, per_dir in ((256, 32, (0, 1), False), (256, 64, (0,), False), (512, 64, (0,), True),
                                      (1024, 64, (0,), True), (600, 64, (0,), True)):
        name = "gru_dir" if per_dir else "gru"
        params = init_gru_params(g, 8192, h, 2, True, True, False, dev)
        x0 = torch.rand((batch, 89, 8192), generator=g, device=dev) * 2 - 1
        x1 = torch.rand((batch, 89, 2 * h), generator=g, device=dev) * 2 - 1
        h0 = torch.zeros((2, batch, h), device=dev)
        for layer in layers:
            for cd in (f32, bf16):
                gi, w_hh, b_hh = bigru_inputs(params["layers"][layer]["directions"], x0 if layer == 0 else x1, cd)
                gi, w_cd = gi.detach(), w_hh.to(cd)
                label = f"H{h} B{batch} layer{layer} {cd_name(cd)}"
                step = 2 * batch * h * 3 * h * 2 * 89  # one (B, H) x (H, 3H) product per direction and step
                ys = gru.gru_recurrence_plain(gi, w_hh, b_hh, h0, cd)
                gy = torch.randn(ys.shape, generator=g, device=dev)
                lib_fwd, lib_bwd = cudnn_gru(gi, w_hh, b_hh, h0, gy, cd, ys)
                compare(name, label,
                        lambda: gru._fwd_kernel(gi, w_hh, b_hh, h0, cd, per_dir),
                        lambda: gru.gru_recurrence_plain(gi, w_hh, b_hh, h0, cd),
                        f32_tol(name) if cd == f32 else bf16_tol, results,
                        (gi, w_cd, b_hh, h0), [(step, cd_name(cd))], lib_fwd)
                r = results[-1]  # the forward's time per step
                per_call, by = (r["ms"], "") if r["profiler_ms"] is None else (r["profiler_ms"], " (profiler)")
                print(f"  {'':13s} {label:42s} {1e3 * per_call / gi.shape[0]:.2f} us per step{by}")
                # gh recomputed and dh's product with W^T in the compute dtype; dW in it or in f32
                compare(f"{name}_bwd", label,
                        lambda: gru._bwd_kernel(gi, w_hh, b_hh, h0, ys, gy, cd, per_dir),
                        lambda: gru.gru_recurrence_bwd_plain(gi, w_hh, b_hh, h0, ys, gy, cd, per_dir),
                        f32_rel_tol(f"{name}_bwd") if cd == f32 else bf16_tol, results,
                        (gi, w_cd, b_hh, h0, ys, gy),
                        [(2 * step, cd_name(cd)), (step, "float32" if per_dir else cd_name(cd))], lib_bwd)
                if not per_dir:  # the backward's kernels: hprev, gh, the step launches, dW
                    kernel_split(label, lambda: gru._bwd_kernel(gi, w_hh, b_hh, h0, ys, gy, cd))
                else:  # the step launches alone, without the f32 dW / db product that follows them
                    rec_ms = timed_ms(lambda: gru._dir_bwd_recurrence(gi, w_hh, b_hh, h0, ys, gy, cd))
                    print(f"  {'':13s} {label:42s} recurrence alone {rec_ms:.4f} ms "
                          f"(the entry: {results[-1]['ms']:.4f} ms)")
                del gi, ys, gy, lib_fwd, lib_bwd
        del params, x0, x1

    # 3. attention: the conformer's B=32, 16 heads of 64 at scale 1/8
    attention_rows(g, 32, 16, 0.125, 1.0)

    # 4. GLU -> depthwise conv: B=32, T=89, C=1024, k=31 (no one PyTorch call computes it); then
    # B=8 at T=169 and T=400, several of the backward's 96-frame chunks (T=400: past the whole-sequence
    # backward's reach)
    wdw = (torch.rand((31, 1024), generator=g, device=dev) * 2 - 1) * (3.0 / 31) ** 0.5
    for (batch, t), sd in itertools.product(((32, 89), (8, 169), (8, 400)), (f32, bf16)):
        conv = 2 * batch * t * 1024 * 31
        y = torch.randn((batch, t, 2048), generator=g, device=dev).to(sd)
        dz = torch.randn((batch, t, 1024), generator=g, device=dev).to(sd)
        for cd in (f32, bf16):
            if sd == bf16 and cd == f32:
                continue
            label = f"B{batch} T{t} C1024 io {cd_name(sd)} cd {cd_name(cd)}"
            exact = cd == f32 and sd == f32
            compare("conv_glu", label,
                    lambda: conv_glu._fwd_kernel(y, wdw, cd),
                    lambda: conv_glu.glu_dwconv_plain(y, wdw, cd),
                    f32_tol("conv_glu") if exact else bf16_tol, results,
                    (y, wdw), [(conv, cd_name(cd))])
            compare("conv_glu_bwd", label,
                    lambda: conv_glu._bwd_kernel(y, wdw, dz, cd),
                    lambda: conv_glu.glu_dwconv_bwd_plain(y, wdw, dz, cd),
                    f32_rel_tol("conv_glu_bwd") if exact else bf16_tol, results,
                    (y, wdw, dz), [(2 * conv, cd_name(cd))])

    # 5. LayerNorm at the wav2vec2-base (64 x 89 x 768) and conformer (32 x
    # 89 x 1024) shapes, f32 and bf16 streams. The library call: F.layer_norm
    # (forward) and its backward
    for shape in ((64, 89, 768), (32, 89, 1024)):
        c = shape[-1]
        scale = 1 + 0.3 * torch.randn(c, generator=g, device=dev)
        bias = 0.2 * torch.randn(c, generator=g, device=dev)
        for sd in (f32, bf16):
            xs = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(sd)
            dys = torch.randn(shape, generator=g, device=dev).to(sd)
            label = f"B{shape[0]} T{shape[1]} C{c} {cd_name(sd)}"
            elems = xs.numel()
            if sd == f32:
                leaves = [t.detach().requires_grad_(True) for t in (xs, scale, bias)]
                ln_out = F.layer_norm(leaves[0], (c,), leaves[1], leaves[2], LN_EPS)
                ln_fwd = lambda: F.layer_norm(xs, (c,), scale, bias, LN_EPS)  # noqa: E731
                ln_bwd = lambda: torch.autograd.grad(ln_out, leaves, dys, retain_graph=True)  # noqa: E731
            else:  # F.layer_norm takes its weights in the input's dtype: no library row at a bf16 stream
                ln_fwd = ln_bwd = None
            compare("layernorm", label,
                    lambda: layernorm._fwd_kernel(xs, scale, bias, LN_EPS),
                    lambda: layernorm.layer_norm_plain(xs, scale, bias, LN_EPS),
                    f32_tol("layernorm") if sd == f32 else bf16_tol, results,
                    (xs, scale, bias), [(7 * elems, "float32")], ln_fwd)
            compare("layernorm_bwd", label,
                    lambda: layernorm._bwd_kernel(xs, scale, dys, LN_EPS),
                    lambda: layernorm.layer_norm_bwd_plain(xs, scale, dys, LN_EPS),
                    f32_rel_tol("layernorm_bwd") if sd == f32 else bf16_tol, results,
                    (xs, scale, dys), [(14 * elems, "float32")], ln_bwd)

    # 6. the wav2vec2-base path's shapes of the kernels it shares with the
    # conformer (inputs from their own seed): preproc at B=64 with the sweep's
    # smoothing (sigma 1.5); attention at B=64, 12 heads of 64 with q
    # pre-scaled by 1/8 in the stream dtype and the kernel at scale 1
    g_w2v = torch.Generator(device=dev).manual_seed(SEED + 1)
    preproc_rows(g_w2v, 64, 1.5)
    attention_rows(g_w2v, 64, 12, 1.0, 0.125)
    # 7. attention at T'=169 (B=32, 16 heads: the conformer's shape at ~700 frames) and at T'=400 (B=8,
    # ~1,600 frames: key tiles streamed), an f32 stream: bf16 compute in the training setting, f32
    # compute (the split-TF32 kernels) at both rates
    long_rows = [(f32, bf16, 0.1), (f32, f32, 0.0), (f32, f32, 0.1)]
    attention_rows(torch.Generator(device=dev).manual_seed(SEED + 2), 32, 16, 0.125, 1.0, t=169, rows=long_rows)
    attention_rows(torch.Generator(device=dev).manual_seed(SEED + 3), 8, 16, 0.125, 1.0, t=400, rows=long_rows)
    # 8. attention at f32 compute with logits 8x larger, against the f64 result
    attention_precision_rows(torch.Generator(device=dev).manual_seed(SEED + 4), 64, 12)


def _spec_and_batch(family):
    import torch

    from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec
    from wav2vec2forbrain_tpu_torch.profile_train import FAMILIES

    fields, _, batch_size = FAMILIES[family]
    return ModelSpec(compute_dtype=torch.bfloat16, activation_dtype=torch.float32, **fields), batch_size


def _check_launches(launches, family, train):
    """Every kernel of the family's path launched, no other kernel did."""
    want = set(PATH_KERNELS[family])
    if train:
        want |= {f"{k}_bwd" for k in want}
    wrong = sorted(k for k, v in launches.items() if (v > 0) != (k in want))
    if wrong:
        fail(f"{family} {'training' if train else 'serving'}: kernels launched against the path: "
             f"{ {k: launches[k] for k in wrong} } (expected exactly {sorted(want)})")


def serve_phase(dev, device_name, power, family):
    """Phases 3 and 5; returns (launches, samples/s auto, samples/s none)."""
    import dataclasses

    import numpy as np
    import torch

    from wav2vec2forbrain_tpu_torch.data.batch import to_device
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
    from wav2vec2forbrain_tpu_torch.models.assembly import init_model_params
    from wav2vec2forbrain_tpu_torch.ops import kernels, select
    from wav2vec2forbrain_tpu_torch.predict import predict
    from wav2vec2forbrain_tpu_torch.train.steps import build_eval_step
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves

    spec, batch_size = _spec_and_batch(family)
    t = time.perf_counter()
    params, state = init_model_params(torch.Generator(device=dev).manual_seed(SEED), spec, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"  model: {FAMILY_NAMES[family]}, {n_params / 1e6:.1f}M params, init {time.perf_counter() - t:.2f} s")
    batches = make_requests(N_REQUESTS, batch_size, 384, SEED)
    expected_lens = [(b.input_lens - 32) // 4 for b in batches]

    def check(i, preds):
        logits = preds["logits"]
        if logits.shape != (batch_size, 89, 32):
            fail(f"{family} batch {i}: logits shape {logits.shape} != ({batch_size}, 89, 32)")
        if not np.isfinite(logits).all():
            fail(f"{family} batch {i}: non-finite logits")
        if not np.array_equal(preds["logit_lens"], expected_lens[i]):
            fail(f"{family} batch {i}: logit_lens {preds['logit_lens']} != (input_lens - 32) // 4")
        if not np.isfinite(preds["loss"]) or preds["loss"] <= 0:
            fail(f"{family} batch {i}: CTC loss {preds['loss']} (expected finite and > 0)")

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
    print(f"  predict (auto, bf16 compute, f32 stream): {len(batches)} requests x {batch_size} samples "
          f"in {wall:.3f} s = {n / wall:.1f} samples/s on {device_name} ({power})")
    print(f"  test loss {avg.loss:.4f}  WER {avg.metrics['word_error_rate']:.4f}  "
          f"CER {avg.metrics['char_error_rate']:.4f} (random weights: proves the path, not quality)")
    print(f"  kernel launches in the predict run: {json.dumps(launches)}")
    _check_launches(launches, family, train=False)

    select.set_kernel_policy("none")
    t = time.perf_counter()
    predict(params, state, spec, batches)
    torch.cuda.synchronize()
    wall_none = time.perf_counter() - t
    print(f"  predict (none: plain PyTorch for every kernel): {n / wall_none:.1f} samples/s")

    step = build_eval_step(dataclasses.replace(spec, compute_dtype=torch.float32))
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
        fail(f"{family}: auto vs none logits differ by {diff}")
    return launches, n / wall, n / wall_none


def _clone(tree):
    from wav2vec2forbrain_tpu_torch.tree import tree_map

    return tree_map(lambda t: None if t is None else t.detach().clone(), tree)


def _layer_of(path):
    """The encoder layer index of a param path, or None."""
    parts = path.split("/")
    if "encoder" in parts and "layers" in parts:
        return int(parts[parts.index("layers") + 1])
    return None


def _layerdrop_rng(seed, dev, n_layers, steps):
    """A StepRng of `steps` steps whose encoder streams replay a LayerDrop
    mask (models/seeds.py) that drops layer DROPPED_LAYER and keeps every
    other layer; their dropout seeds come from numpy, the GRU and head
    streams from CPU generators, all from `seed`."""
    import numpy as np
    import torch

    from wav2vec2forbrain_tpu_torch.models.seeds import INT32_MAX, ForwardRng, SeedStream, StepRng

    rs = np.random.default_rng(seed)
    mask = [i == DROPPED_LAYER for i in range(n_layers)]

    def stream():
        return SeedStream(torch.Generator().manual_seed(int(rs.integers(2**62))))

    replay = [ForwardRng(stream(), SeedStream(seeds=rs.integers(0, INT32_MAX, 4096).tolist(), layerdrop=[mask]),
                         stream()) for _ in range(steps)]
    return StepRng(seed, dev, replay=replay)


def train_phase(dev, device_name, power, family):
    """Phases 4 and 6; returns (launches, steps/s, samples/s) of the timed run."""
    import dataclasses

    import numpy as np
    import torch

    from wav2vec2forbrain_tpu_torch.data.batch import to_device
    from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
    from wav2vec2forbrain_tpu_torch.ops import kernels, select
    from wav2vec2forbrain_tpu_torch.profile_train import BRAIN_LR, STEP_CFG, W2V_LR, build_trainer
    from wav2vec2forbrain_tpu_torch.train.optim import AdamState
    from wav2vec2forbrain_tpu_torch.train.steps import build_grad_fn
    from wav2vec2forbrain_tpu_torch.train.train_loop import train_batches
    from wav2vec2forbrain_tpu_torch.tree import tree_leaves, tree_leaves_with_path as leaves

    select.set_kernel_policy("auto")
    t = time.perf_counter()
    tr = build_trainer(dev, SEED, family)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(tr.params))
    print(f"  model: {FAMILY_NAMES[family]}, {n_params / 1e6:.1f}M params; bf16 compute, f32 stream, "
          f"GRU dropout {tr.spec.gru_dropout}, Adam weight decay {tr.optimizer.weight_decay}; "
          f"init {time.perf_counter() - t:.2f} s")
    bsz = tr.batch_size
    batches = make_requests(N_TRAIN_STEPS + 1, bsz, 384, SEED + 1)
    enc_cfg = tr.spec.w2v_cfg if tr.spec.encoder_family == "wav2vec2" else tr.spec.conformer_cfg
    n_layers = enc_cfg.num_hidden_layers
    rng = _layerdrop_rng(SEED, dev, n_layers, len(batches))
    # warm-up step: cuBLAS handles, the kernels' first launches, Adam state
    run = train_batches(tr.train_step, tr.params, tr.opt_state, tr.state, batches[:1], rng, BRAIN_LR, W2V_LR)
    torch.cuda.synchronize()
    before = dict(leaves(_clone(tr.params)))
    state_before = _clone(run.model_state)

    kernels.reset_launches()
    t = time.perf_counter()
    run = train_batches(tr.train_step, tr.params, run.opt_state, run.model_state, batches[1:], rng,
                        BRAIN_LR, W2V_LR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    n = sum(b.input.shape[0] for b in batches[1:])
    print(f"  train_batches (auto): {run.steps} steps x {bsz} samples in {wall:.3f} s = "
          f"{run.steps / wall:.3f} steps/s, {n / wall:.1f} samples/s on {device_name} ({power})")
    losses = [m.loss for m in run.history.metrics]
    avg = run.history.get_average()
    print(f"  train losses {[round(x, 4) for x in losses]}  WER {avg.metrics['word_error_rate']:.4f}  "
          f"CER {avg.metrics.get('char_error_rate', float('nan')):.4f}")
    print(f"  kernel launches in the train run: {json.dumps(launches)}")
    _check_launches(launches, family, train=True)
    if not all(np.isfinite(losses)):
        fail(f"{family}: non-finite train loss {losses}")

    # which layers ran in some step (LayerDrop decisions of every step, warm-up included)
    masks = [f.enc.layerdrop_drawn[0] for f in rng.forwards]
    ran = [not all(m[i] for m in masks) for i in range(len(masks[0]))]
    print(f"  LayerDrop (replayed): layers dropped per step {[[i for i, d in enumerate(m) if d] for m in masks]}")
    if len(masks) != len(batches) or ran[DROPPED_LAYER] or not all(ran[:DROPPED_LAYER] + ran[DROPPED_LAYER + 1:]):
        fail(f"{family}: the LayerDrop replay did not drop exactly layer {DROPPED_LAYER} in all "
             f"{len(batches)} steps: {masks}")
    label_of = dict(leaves(tr.labels))
    wrong = []
    for path, p in leaves(tr.params):
        if not bool(torch.isfinite(p).all()):
            fail(f"{family}: non-finite parameter after training: {path}")
        moved = not torch.equal(p, before[path])
        layer = _layer_of(path)
        if label_of[path] == "frozen":
            expect = False
        elif layer is not None and not ran[layer]:
            # no gradient: only weight decay moves it, and not a leaf that is all zeros
            expect = tr.optimizer.weight_decay > 0 and bool(before[path].ne(0).any())
        else:
            # the conformer's pos_conv is a dead parity param (its forward never applies it)
            expect = not (family == "conformer" and "/pos_conv/" in path)
        if moved != expect:
            wrong.append((path, moved, expect))
    if wrong:
        fail(f"{family}: params moved (or stayed) against expectation: {wrong[:8]} ({len(wrong)} in all)")
    if family == "conformer":
        for i, (new, old) in enumerate(zip(run.model_state["encoder"]["layers"], state_before["encoder"]["layers"])):
            changed = not torch.equal(new["batch_norm"]["mean"], old["batch_norm"]["mean"])
            if changed != ran[i]:
                fail(f"layer {i}: BN running stats {'changed' if changed else 'unchanged'} but the layer "
                     f"{'ran' if ran[i] else 'was dropped in every step'}")
        print(f"  BN stats updated in the {sum(ran)} layers that ran")
    print("  every trainable leaf of the layers that ran moved (the conformer's dead pos_conv excepted), "
          "frozen leaves did not; a layer dropped in every step moved only by weight decay "
          f"({tr.optimizer.weight_decay})")

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
        kernels.reset_launches()
        # the same replay: layer DROPPED_LAYER, whose Adam moments are still 0, stays dropped (a first
        # Adam step moves each weight by ~lr * sign(g), which an order-level gradient difference flips)
        out, grads, norm = grad_fn(params, state, batch, _layerdrop_rng(SEED + 7, dev, n_layers, 1))
        if policy == "auto":  # at f32 compute attention takes the split-TF32 kernels (D <= 128)
            print(f"  kernel launches in the f32 step (auto): {json.dumps(dict(kernels.LAUNCHES))}")
        if not all(bool(torch.isfinite(gr).all()) for gr in tree_leaves(grads)):
            fail(f"{family}: non-finite gradient at f32 under {policy}")
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
        fail(f"{family}: the f32 train step differs between `auto` and `none` beyond its bounds")
    del res, pa, pn, tr, run
    torch.cuda.empty_cache()
    return launches, N_TRAIN_STEPS / wall, n / wall


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

    serve, train = {}, {}
    for i, family in enumerate(("conformer", "w2v")):
        print(f"[{3 + 2 * i}] serving: {FAMILY_NAMES[family]}")
        serve[family] = serve_phase(dev, device_name, power, family)
        torch.cuda.synchronize()
        print(f"[{4 + 2 * i}] training: {FAMILY_NAMES[family]}")
        train[family] = train_phase(dev, device_name, power, family)
        torch.cuda.synchronize()

    rows = []
    for name, label in ROW_LABELS.items():
        mine = [r for r in results if r["name"] == name]
        at = next(r for r in mine if r["label"] == label)
        by_path = {f"{fam}_train": train[fam][0][name] for fam in train}
        launches = sum(by_path.values())
        if launches <= 0:
            fail(f"{name}: launched in no training run")
        rows.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": max(r["err"] for r in mine),
            "ms": at["ms"],
            "profiler_ms": at["profiler_ms"],
            "call_ms": at["call_ms"],
            "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "library_profiler_ms": at["library_profiler_ms"],
            "at": label,
        })
    for family in serve:
        _, sps, sps_none = serve[family]
        _, steps_ps, train_sps = train[family]
        print(f"{family}: serving samples/s auto {sps:.2f} none {sps_none:.2f}; "
              f"training {steps_ps:.3f} steps/s, {train_sps:.2f} samples/s on {power}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
