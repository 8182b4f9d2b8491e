"""Plain PyTorch reference of the two benchmarked models: the B2P2T brain
encoder (smoothing, per-day affine, softsign, unfold; a stacked biGRU; FC)
feeding a Wav2Vec2-Conformer-RoPE or a post-LN Wav2Vec2 encoder and its CTC
head, the CTC loss, and the hash-keyed dropout the models train with.

It imports nothing of the program. It is written from the published model
equations (Hugging Face's Wav2Vec2 and Wav2Vec2-Conformer, torch's GRU,
BatchNorm and CTC) and from the brain2text model's documented quirks:
- the unfold reports (L - kernel) // stride output frames, one fewer than
  it emits; the CTC loss reads the former;
- the backward GRU direction runs over the time-flipped padded sequence;
- no attention mask: padded frames take part in every softmax;
- RoPE rotates the hidden states before the q and k projections;
- each dropout decision is a murmur3-finalised hash of (seed, coordinates),
  so a replayed seed gives the same mask (`hash_uniform`, `hash_keep_mask`).

Parameters are nested dicts in the brain2text checkpoint layout (linear
kernels stored (in, out)). Everything runs in float32; `Precision.tf32`
computes every product in TF32 instead (the benchmark's control).
"""

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

_M32 = 0xFFFFFFFF
_SEED_MIX = 0x27D4EB2F
_COORD_MIX = (0x165667B1, 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35)


# --- precision ---------------------------------------------------------------------


class Precision:
    """How products are computed: "f32" (TF32 off) or "tf32" (the control:
    on a card the TF32 tensor cores, on the CPU operands rounded to TF32)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "tf32"):
            raise ValueError(f"precision {mode!r}: expected f32 or tf32")
        self.mode = mode

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved
        return False

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """x as a product reads it: on the CPU under "tf32" rounded to TF32's
        10-bit mantissa (nearest), with the gradient passed straight through."""
        if self.mode != "tf32" or x.is_cuda:
            return x
        return x + (_tf32_round(x.detach()) - x.detach())


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def mm(prec: Precision, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(prec.operand(a), prec.operand(b))


def bmm(prec: Precision, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bmm(prec.operand(a), prec.operand(b))


# --- hash dropout -------------------------------------------------------------------


def _finalize(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on values held in int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _uniform_of(x: torch.Tensor) -> torch.Tensor:
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hash_uniform(shape: Sequence[int], seed: int, device) -> torch.Tensor:
    """f32 uniforms in [0, 1) keyed on (seed, element coordinates)."""
    x = torch.full((), (int(seed) * _SEED_MIX) & _M32, dtype=torch.int64, device=device)
    nd = len(shape)
    for d, n in enumerate(shape):
        view = [1] * nd
        view[d] = n
        i = torch.arange(n, dtype=torch.int64, device=device).reshape(view)
        x = (x + ((i * _COORD_MIX[d % 4]) & _M32)) & _M32
    return _uniform_of(_finalize(x.expand(*shape).contiguous()))


def _f32(value: float) -> float:
    return float(torch.tensor(value, dtype=torch.float32))


def _keep_scaled(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    keep = hash_uniform(x.shape, seed, x.device) < _f32(1.0 - rate)
    return torch.where(keep, x * _f32(1.0 / (1.0 - rate)), 0.0)


class _Dropout(torch.autograd.Function):
    """Hash dropout whose backward draws the mask again from the seed."""

    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.args = (seed, rate)
        return _keep_scaled(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        return _keep_scaled(g, *ctx.args), None, None


def dropout(x: torch.Tensor, seeds: Optional["SeedList"], rate: float, train: bool) -> torch.Tensor:
    if not train or rate <= 0.0:
        return x
    return _Dropout.apply(x, seeds.next(), float(rate))


def hash_keep_mask(seed: int, b: int, h: int, t: int, keep_prob: float, device) -> torch.Tensor:
    """(B, H, T, T) 0/1 keep mask of attention probabilities, keyed on
    (seed, row, head, query, key)."""

    def iota(n, dim, mult):
        view = [1, 1, 1, 1]
        view[dim] = n
        return (torch.arange(n, dtype=torch.int64, device=device).reshape(view) * mult) & _M32

    mix = ((int(seed) * _SEED_MIX) & _M32) + iota(b, 0, 0x165667B1)
    mix = ((mix & _M32) + iota(h, 1, 0x9E3779B9)) & _M32
    rc = (iota(t, 2, 0x9E3779B9) + iota(t, 3, 0x85EBCA6B)) & _M32
    u = _uniform_of(_finalize((mix + rc) & _M32))
    return (u < _f32(keep_prob)).to(torch.float32)


class SeedList:
    """One stream of dropout seeds and LayerDrop decisions, as drawn by the
    benchmark and handed to both sides."""

    def __init__(self, seeds: Sequence[int], layerdrop: Optional[Sequence[bool]] = None):
        self.seeds = list(seeds)
        self.layerdrop = None if layerdrop is None else list(layerdrop)
        self.used = 0

    def next(self) -> int:
        s = self.seeds[self.used]
        self.used += 1
        return s

    def skip(self, n: int) -> None:
        self.used += n


@dataclass
class StepSeeds:
    """A train step's streams: the GRU's, the encoder's (with its LayerDrop
    decisions) and the head's."""

    gru: SeedList
    enc: SeedList
    head: SeedList


# --- brain encoder ------------------------------------------------------------------


def gaussian_taps(n: int, sigma: float, device) -> torch.Tensor:
    grid = torch.arange(n, dtype=torch.float32, device=device)
    mean = (n - 1) / 2.0
    k = (1.0 / (sigma * math.sqrt(2 * math.pi))) * torch.exp(-(((grid - mean) / sigma) ** 2) / 2)
    return k / torch.sum(k)


def preprocess(p: dict, x: torch.Tensor, days: torch.Tensor, brain: dict, prec: Precision) -> torch.Tensor:
    """(B, T, 256) -> (B, T', 256 * kernel): 'same' gaussian smoothing over
    time (an even kernel pads one more frame on the right), the day's
    affine, softsign, then overlapping windows, feature c * kernel + j."""
    taps = gaussian_taps(brain["smooth_taps"], brain["gaussian_smooth_width"], x.device)
    k_s = taps.shape[0]
    t = x.shape[1]
    xp = F.pad(x, (0, 0, (k_s - 1) // 2, k_s // 2))
    y = torch.zeros_like(x)
    for i in range(k_s):
        y = y + taps[i] * xp[:, i : i + t]
    y = bmm(prec, y, p["day_weights"][days]) + p["day_bias"][days]
    y = y / (1.0 + torch.abs(y))
    k, s = brain["unfolder_kernel_len"], brain["unfolder_stride_len"]
    t_out = (t - k) // s + 1
    idx = (torch.arange(t_out, device=x.device) * s)[:, None] + torch.arange(k, device=x.device)[None, :]
    b, _, c = y.shape
    return y[:, idx, :].permute(0, 1, 3, 2).reshape(b, t_out, c * k)


def out_lens(lens: torch.Tensor, brain: dict) -> torch.Tensor:
    return torch.div(lens - brain["unfolder_kernel_len"], brain["unfolder_stride_len"], rounding_mode="floor")


def _gru_direction(d: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """torch.nn.GRU's recurrence (gates r, z, n; b_hh inside r * (...)),
    h0 = 0. x: (B, T, in) -> (B, T, H)."""
    gi = mm(prec, x, d["w_ih"]) + d["b_ih"]
    h = torch.zeros((x.shape[0], d["w_hh"].shape[0]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(x.shape[1]):
        gh = mm(prec, h, d["w_hh"]) + d["b_hh"]
        i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys, dim=1)


def bigru(p: dict, x: torch.Tensor, brain: dict, seeds: Optional[SeedList], train: bool, prec: Precision):
    layers = p["layers"]
    for i, layer in enumerate(layers):
        fwd, bwd = layer["directions"]
        yf = _gru_direction(fwd, x, prec)
        yb = torch.flip(_gru_direction(bwd, torch.flip(x, dims=(1,)), prec), dims=(1,))
        x = torch.cat([yf, yb], dim=-1)
        if i < len(layers) - 1:
            x = dropout(x, seeds, brain["gru_dropout"], train)
    return x


def linear(p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return mm(prec, x, p["kernel"]) + p["bias"]


ACTIVATIONS = {"gelu": lambda x: F.gelu(x, approximate="none"), "swish": F.silu, "silu": F.silu}


def fc(p: dict, x: torch.Tensor, act: str, prec: Precision) -> torch.Tensor:
    n = len(p["layers"])
    for i, layer in enumerate(p["layers"]):
        x = linear(layer, x, prec)
        if i < n - 1:
            x = ACTIVATIONS[act](x)
    return x


# --- encoders -----------------------------------------------------------------------


def layer_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def attention(q, k, v, heads: int, scale: float, rate: float, seeds, train: bool, prec: Precision):
    """Multi-head attention over every frame, the probabilities dropped by
    the hash keep mask. q, k, v: (B, T, H * D)."""
    b, t, hd = q.shape
    d = hd // heads

    def split(x):
        return x.reshape(b, t, heads, d).permute(0, 2, 1, 3).reshape(b * heads, t, d)

    probs = torch.softmax(bmm(prec, split(q), split(k).transpose(1, 2)) * scale, dim=-1)
    if train and rate > 0.0:
        keep = hash_keep_mask(seeds.next(), b, heads, t, 1.0 - rate, q.device).reshape(b * heads, t, t)
        probs = probs * keep * _f32(1.0 / (1.0 - rate))
    ctx = bmm(prec, probs, split(v))
    return ctx.reshape(b, heads, t, d).permute(0, 2, 1, 3).reshape(b, t, hd)


def feed_forward(p, x, enc: dict, seeds, train, prec):
    y = ACTIVATIONS[enc["hidden_act"]](linear(p["intermediate_dense"], x, prec))
    y = dropout(y, seeds, enc["activation_dropout"], train)
    y = linear(p["output_dense"], y, prec)
    return dropout(y, seeds, enc["hidden_dropout"], train)


def _rotary(x: torch.Tensor, heads: int, base: float) -> torch.Tensor:
    b, t, h = x.shape
    d = h // heads
    inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    freqs = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = torch.cos(emb)[None, :, None, :], torch.sin(emb)[None, :, None, :]
    xh = x.reshape(b, t, heads, d)
    rotated = torch.cat([-xh[..., d // 2 :], xh[..., : d // 2]], dim=-1)
    return (xh * cos + rotated * sin).reshape(b, t, h)


def _batch_norm(p: dict, s: dict, x: torch.Tensor, enc: dict, train: bool):
    """torch BatchNorm1d over the channels of (B, T, C): batch statistics
    (biased variance, every frame) in train mode, moving the running ones by
    the momentum with the unbiased variance; the running ones in eval mode."""
    if train:
        n = x.shape[0] * x.shape[1]
        mean = x.mean(dim=(0, 1))
        var = x.var(dim=(0, 1), unbiased=False)
        m = enc["batch_norm_momentum"]
        new = {"mean": (1 - m) * s["mean"] + m * mean.detach(),
               "var": (1 - m) * s["var"] + m * (var * n / max(n - 1, 1)).detach()}
    else:
        mean, var, new = s["mean"], s["var"], s
    return (x - mean) * torch.rsqrt(var + enc["batch_norm_eps"]) * p["scale"] + p["bias"], new


def conformer_layer(p, s, x, enc, seeds, train, prec):
    eps, heads = enc["layer_norm_eps"], enc["num_attention_heads"]
    x = x + 0.5 * feed_forward(p["ffn1"], layer_norm(p["ffn1_layer_norm"], x, eps), enc, seeds, train, prec)
    y = layer_norm(p["self_attn_layer_norm"], x, eps)
    qk = _rotary(y, heads, enc["rotary_embedding_base"])
    a = p["self_attn"]
    ctx = attention(linear(a["linear_q"], qk, prec), linear(a["linear_k"], qk, prec), linear(a["linear_v"], y, prec),
                    heads, 1.0 / math.sqrt(y.shape[-1] // heads), enc["attention_dropout"], seeds, train, prec)
    x = x + dropout(linear(a["linear_out"], ctx, prec), seeds, enc["attention_dropout"], train)
    c = p["conv_module"]
    y = mm(prec, layer_norm(c["layer_norm"], x, eps), c["pointwise_conv1"]["kernel"])
    a_half, gate = y.chunk(2, dim=-1)
    y = a_half * torch.sigmoid(gate)
    w = c["depthwise_conv"]["kernel"][:, 0, :]  # (ks, C)
    ks, t = w.shape[0], y.shape[1]
    yp = F.pad(y, (0, 0, (ks - 1) // 2, ks // 2))
    y = sum(yp[:, j : j + t] * w[j] for j in range(ks))
    y, new_s = _batch_norm(c["batch_norm"], s["batch_norm"], y, enc, train)
    y = mm(prec, ACTIVATIONS[enc["hidden_act"]](y), c["pointwise_conv2"]["kernel"])
    x = x + dropout(y, seeds, enc["conformer_conv_dropout"], train)
    x = x + 0.5 * feed_forward(p["ffn2"], layer_norm(p["ffn2_layer_norm"], x, eps), enc, seeds, train, prec)
    return layer_norm(p["final_layer_norm"], x, eps), {"batch_norm": new_s}


CONFORMER_SITES = ("activation_dropout", "hidden_dropout", "attention_dropout", "attention_dropout",
                   "conformer_conv_dropout", "activation_dropout", "hidden_dropout")
W2V_SITES = ("attention_dropout", "hidden_dropout", "activation_dropout", "hidden_dropout")


def _sites(enc: dict, names) -> int:
    return sum(enc[n] > 0.0 for n in names)


def _layerdrop(enc: dict, seeds, train: bool) -> List[bool]:
    n = enc["num_hidden_layers"]
    if not train or enc["layerdrop"] <= 0.0:
        return [False] * n
    return list(seeds.layerdrop)


def conformer_encoder(p, s, x, enc, seeds, train, prec):
    x = dropout(x, seeds, enc["hidden_dropout"], train)
    drop = _layerdrop(enc, seeds, train)
    states = []
    for lp, ls, dropped in zip(p["layers"], s["layers"], drop):
        if dropped:
            seeds.skip(_sites(enc, CONFORMER_SITES))
            states.append(ls)
            continue
        x, ns = conformer_layer(lp, ls, x, enc, seeds, train, prec)
        states.append(ns)
    return layer_norm(p["layer_norm"], x, enc["layer_norm_eps"]), {"layers": states}


def pos_conv(p: dict, x: torch.Tensor, enc: dict, prec: Precision) -> torch.Tensor:
    """The weight-normed grouped convolution (norm over all but the tap
    dim), 'same' padding k // 2 with the extra right frame trimmed, GELU."""
    v = p["weight_v"]
    w = p["weight_g"] * v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True)), min=1e-12)
    k = enc["num_conv_pos_embeddings"]
    y = F.conv1d(prec.operand(x.transpose(1, 2)), prec.operand(w), padding=k // 2,
                 groups=enc["num_conv_pos_embedding_groups"])
    y = y.transpose(1, 2) + p["bias"]
    if k % 2 == 0:
        y = y[:, : x.shape[1]]
    return F.gelu(y, approximate="none")


def w2v_layer(p, x, enc, seeds, train, prec):
    heads, eps = enc["num_attention_heads"], enc["layer_norm_eps"]
    a = p["attention"]
    q = linear(a["q_proj"], x, prec) * (x.shape[-1] // heads) ** -0.5
    ctx = attention(q, linear(a["k_proj"], x, prec), linear(a["v_proj"], x, prec), heads, 1.0,
                    enc["attention_dropout"], seeds, train, prec)
    y = dropout(linear(a["out_proj"], ctx, prec), seeds, enc["hidden_dropout"], train)
    x = layer_norm(p["layer_norm"], x + y, eps)
    return layer_norm(p["final_layer_norm"], x + feed_forward(p["feed_forward"], x, enc, seeds, train, prec), eps)


def w2v_encoder(p, x, enc, seeds, train, prec):
    """The post-LN (base) encoder: pos-conv, LayerNorm, dropout, layers."""
    if enc.get("do_stable_layer_norm", False):
        raise NotImplementedError("the reference holds the post-LN encoder only")
    x = x + pos_conv(p["pos_conv"], x, enc, prec)
    x = layer_norm(p["layer_norm"], x, enc["layer_norm_eps"])
    x = dropout(x, seeds, enc["hidden_dropout"], train)
    for lp, dropped in zip(p["layers"], _layerdrop(enc, seeds, train)):
        if dropped:
            seeds.skip(_sites(enc, W2V_SITES))
            continue
        x = w2v_layer(lp, x, enc, seeds, train, prec)
    return x


# --- the model and its loss --------------------------------------------------------


def forward(params: dict, state: dict, cfg: dict, x: torch.Tensor, days: torch.Tensor, lens: torch.Tensor,
            seeds: Optional[StepSeeds] = None, train: bool = False, prec: Optional[Precision] = None):
    """(logits (B, T', vocab), logit lens (B,), new state) of a batch of
    (B, T, 256) neural features."""
    prec = prec or Precision()
    brain, enc = cfg["brain"], cfg["encoder"]
    b_p = params["brain"]
    h = preprocess(b_p["preproc"], x, days, brain, prec)
    h = bigru(b_p["gru"], h, brain, seeds.gru if train else None, train, prec)
    h = fc(b_p["fc"], h, brain["fc_activation"], prec)
    enc_seeds = seeds.enc if train else None
    if cfg["encoder_family"] == "conformer":
        h, new_enc = conformer_encoder(params["w2v"]["encoder"], state["encoder"], h, enc, enc_seeds, train, prec)
        new_state = {"encoder": new_enc}
    else:
        h = w2v_encoder(params["w2v"]["encoder"], h, enc, enc_seeds, train, prec)
        new_state = state
    h = dropout(h, seeds.head if train else None, enc["final_dropout"], train)
    return linear(params["w2v"]["lm_head"], h, prec), out_lens(lens, brain), new_state


def ctc_loss(logits, logit_lens, targets, target_lens, sample_mask) -> torch.Tensor:
    """Per-sample CTC negative log-likelihood (0 where the target cannot be
    aligned: fewer frames than tokens plus repeats), each divided by its
    target length, masked rows out, averaged over the real rows."""
    log_probs = F.log_softmax(logits, dim=-1)
    nll = F.ctc_loss(log_probs.transpose(0, 1), targets.long(), logit_lens.long(), target_lens.long(), blank=0,
                     reduction="none", zero_infinity=True)
    u = targets.shape[1]
    valid = torch.arange(1, u, device=targets.device)[None, :] < target_lens[:, None]
    repeats = ((targets[:, 1:] == targets[:, :-1]) & valid).sum(dim=1)
    nll = torch.where(logit_lens >= target_lens + repeats, nll, torch.zeros_like(nll)) * sample_mask
    return (nll / torch.clamp(target_lens, min=1).to(nll.dtype)).sum() / torch.clamp(sample_mask.sum(), min=1.0)
