"""Operations and bytes of each op family of the port's kernels, per entry
call, from its shapes, and the least time the chip could take for them.

Each input byte is counted read once and each output byte written once
(f32: 4 bytes an element); products are counted at the rate their compute
dtype allows (peaks.json: every f32 product at the split-TF32 rate), other
arithmetic at the f32 rate. The per-direction GRU backward's dW / db
product runs outside the port's kernels (one f32 batched product), so its
operations are not counted with them."""

import json
from pathlib import Path
from typing import List, Sequence, Tuple

F4 = 4
Flops = List[Tuple[float, str]]

with open(Path(__file__).resolve().parents[1] / "peaks.json") as _f:
    PEAKS = json.load(_f)


def least_s(flops: Flops, nbytes: float) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"], sum(n / PEAKS["flops_per_s"][rate] for n, rate in flops))


def preproc(b: int, t: int, taps: int, k: int = 32, stride: int = 4, c: int = 256, days: int = 24):
    t_out = (t - k) // stride + 1
    flops = [(2 * b * t * c * c, "tf32x3"), (2 * b * t * c * taps, "tf32x3")]
    return flops, F4 * (b * t * c + days * c * c + days * c + b + taps + b * t_out * c * k)


def preproc_bwd(b: int, t: int, taps: int, k: int = 32, stride: int = 4, c: int = 256, days: int = 24):
    t_out = (t - k) // stride + 1
    flops = [(4 * b * t * c * c, "tf32x3"), (4 * b * t * c * taps, "tf32x3")]
    inputs = b * t * c + days * c * c + days * c + b + taps + b * t_out * c * k
    return flops, F4 * (inputs + b * t * c + days * c * c + days * c)


def gru(t: int, b: int, h: int):
    """Both directions' recurrence of one layer over t steps (the input
    projection is a cuBLAS product outside)."""
    flops = [(2 * b * h * 3 * h * 2 * t, "tf32x3")]
    return flops, F4 * (t * 2 * b * 3 * h + 2 * h * 3 * h + 2 * 3 * h + 2 * b * h + t * 2 * b * h)


def gru_bwd(t: int, b: int, h: int, dw_in_kernels: bool):
    step = 2 * b * h * 3 * h * 2 * t
    flops = [(2 * step + (step if dw_in_kernels else 0), "tf32x3")]
    inputs = t * 2 * b * 3 * h + 2 * h * 3 * h + 2 * 3 * h + 2 * b * h + 2 * t * 2 * b * h
    outputs = t * 2 * b * 3 * h + 2 * b * h + (2 * h * 3 * h + 2 * 3 * h if dw_in_kernels else 0)
    return flops, F4 * (inputs + outputs)


def attention(b: int, t: int, heads: int, d: int):
    qkt = 2 * b * heads * t * t * d
    return [(2 * qkt, "tf32x3")], F4 * 4 * b * t * heads * d


def attention_bwd(b: int, t: int, heads: int, d: int):
    qkt = 2 * b * heads * t * t * d
    return [(5 * qkt, "tf32x3")], F4 * 7 * b * t * heads * d


def conv_glu(b: int, t: int, c: int, ks: int):
    return [(2 * b * t * c * ks, "tf32x3")], F4 * (b * t * 2 * c + ks * c + b * t * c)


def conv_glu_bwd(b: int, t: int, c: int, ks: int):
    return [(4 * b * t * c * ks, "tf32x3")], F4 * (2 * (b * t * 2 * c + ks * c) + b * t * c)


def layernorm(rows: int, c: int):
    return [(7 * rows * c, "float32")], F4 * (2 * rows * c + 2 * c)


def layernorm_bwd(rows: int, c: int):
    return [(14 * rows * c, "float32")], F4 * (3 * rows * c + 3 * c)


def ctc(t: int, vocab: int, u: int, in_lens: Sequence[int], tgt_lens: Sequence[int], grad: bool):
    """The alpha (and, with the gradient, beta) recursions over each
    sample's frames x (2 L + 1) states and the gradient's (t, class) terms."""
    b = len(in_lens)
    states = sum(i * (2 * u_ + 1) for i, u_ in zip(in_lens, tgt_lens))
    flops = [(states * (2 * 12 + 5) + sum(in_lens) * vocab * 5, "float32")] if grad else [(states * 12, "float32")]
    return flops, F4 * (b * t * vocab * (2 if grad else 1) + b * u + 3 * b)


def family_least_s(family: str, step: dict, cfg: dict, calls: int) -> float:
    """Least seconds of `calls` entry calls of `family` at a step's shapes
    (the step record: batch rows, width, each real row's frames and target
    tokens; padded rows repeat the last real row)."""
    brain, enc = cfg["brain"], cfg["encoder"]
    b, t = step["batch_rows"], step["width"]
    k, s = brain["unfolder_kernel_len"], brain["unfolder_stride_len"]
    t_out = (t - k) // s + 1
    h, heads = enc["hidden_size"], enc["num_attention_heads"]
    pad = b - len(step["lens"])
    lens = list(step["lens"]) + [step["lens"][-1]] * pad
    tgts = list(step["tgt_lens"]) + [step["tgt_lens"][-1]] * pad
    h_gru = brain["gru_hidden_size"]
    train = step.get("train", True)
    fn = {
        "preproc": lambda: preproc(b, t, brain["smooth_taps"], k, s),
        "preproc_bwd": lambda: preproc_bwd(b, t, brain["smooth_taps"], k, s),
        "gru": lambda: gru(t_out, b, h_gru),
        "gru_bwd": lambda: gru_bwd(t_out, b, h_gru, dw_in_kernels=h_gru < 512),
        "attention": lambda: attention(b, t_out, heads, h // heads),
        "attention_bwd": lambda: attention_bwd(b, t_out, heads, h // heads),
        "conv_glu": lambda: conv_glu(b, t_out, h, enc.get("conv_depthwise_kernel_size", 31)),
        "conv_glu_bwd": lambda: conv_glu_bwd(b, t_out, h, enc.get("conv_depthwise_kernel_size", 31)),
        "layernorm": lambda: layernorm(b * t_out, h),
        "layernorm_bwd": lambda: layernorm_bwd(b * t_out, h),
        "ctc": lambda: ctc(t_out, enc["vocab_size"], step["tgt_width"], [(n - k) // s for n in lens], tgts, train),
    }[family]
    return calls * least_s(*fn())


def family_times(trace: dict, cfg: dict, families: dict) -> dict:
    """{family: (least seconds, device seconds)} over a trace's steps, for
    the families whose calls and device time the trace both holds."""
    out = {}
    for fam, spec in families.items():
        device = trace["op_device_s"].get(fam, 0.0)
        least = sum(family_least_s(fam, s, cfg, sum(s.get("launches", {}).get(c, 0) for c in spec["counters"]))
                    for s in trace["steps"])
        if device > 0 and least > 0:
            out[fam] = (least, device)
    return out
