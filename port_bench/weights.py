"""Weights and BatchNorm state made from the seed, on the device, in the
brain2text checkpoint layout (the tree the program's `adopt_params` takes
and the reference reads).

All leaves come from one N(0, 1) draw of a device generator, one view each,
scaled by the leaf's kind: a product's weights by 1 / sqrt(fan-in), biases
by 0.02, norm scales 1 + 0.05 n and shifts 0.05 n, the per-day affines the
identity plus 0.02 n, the positional convolution's magnitudes the norms of
its directions (so its weight is its direction)."""

import math
from typing import List, Tuple

import torch

N_DAYS, NEURAL_DIM = 24, 256


def _linear(prefix, i, o):
    return [(f"{prefix}/kernel", (i, o), "matrix"), (f"{prefix}/bias", (o,), "bias")]


def _norm(prefix, h):
    return [(f"{prefix}/scale", (h,), "scale"), (f"{prefix}/bias", (h,), "shift")]


def _pos_conv(prefix, h, enc):
    k, groups = enc["num_conv_pos_embeddings"], enc["num_conv_pos_embedding_groups"]
    return [(f"{prefix}/weight_g", (1, 1, k), "pos_g"), (f"{prefix}/weight_v", (h, h // groups, k), "pos_v"),
            (f"{prefix}/bias", (h,), "bias")]


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """[(path, shape, kind)] of every leaf, in the layout's order."""
    brain, enc = cfg["brain"], cfg["encoder"]
    h_gru, kernel = brain["gru_hidden_size"], brain["unfolder_kernel_len"]
    spec = [("brain/preproc/day_weights", (N_DAYS, NEURAL_DIM, NEURAL_DIM), "day_weights"),
            ("brain/preproc/day_bias", (N_DAYS, 1, NEURAL_DIM), "bias"),
            ("brain/preproc/inp_layers/weight", (N_DAYS, NEURAL_DIM, NEURAL_DIM), "matrix"),
            ("brain/preproc/inp_layers/bias", (N_DAYS, NEURAL_DIM), "bias")]
    for layer in range(brain["gru_num_layers"]):
        width = NEURAL_DIM * kernel if layer == 0 else 2 * h_gru
        for d in range(2):
            p = f"brain/gru/layers/{layer}/directions/{d}"
            spec += [(f"{p}/w_ih", (width, 3 * h_gru), "matrix"), (f"{p}/w_hh", (h_gru, 3 * h_gru), "matrix"),
                     (f"{p}/b_ih", (3 * h_gru,), "bias"), (f"{p}/b_hh", (3 * h_gru,), "bias")]
    sizes = [2 * h_gru] + list(brain["fc_hidden_sizes"]) + [enc["hidden_size"]]
    for i in range(len(sizes) - 1):
        spec += _linear(f"brain/fc/layers/{i}", sizes[i], sizes[i + 1])
    h, ff, e = enc["hidden_size"], enc["intermediate_size"], "w2v/encoder"
    spec += _pos_conv(f"{e}/pos_conv", h, enc) + _norm(f"{e}/layer_norm", h)
    for i in range(enc["num_hidden_layers"]):
        p = f"{e}/layers/{i}"
        if cfg["encoder_family"] == "conformer":
            ks = enc["conv_depthwise_kernel_size"]
            spec += _norm(f"{p}/ffn1_layer_norm", h) + _linear(f"{p}/ffn1/intermediate_dense", h, ff)
            spec += _linear(f"{p}/ffn1/output_dense", ff, h) + _norm(f"{p}/self_attn_layer_norm", h)
            for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
                spec += _linear(f"{p}/self_attn/{name}", h, h)
            c = f"{p}/conv_module"
            spec += _norm(f"{c}/layer_norm", h) + [
                (f"{c}/pointwise_conv1/kernel", (h, 2 * h), "matrix"),
                (f"{c}/depthwise_conv/kernel", (ks, 1, h), "depthwise"),
                (f"{c}/batch_norm/scale", (h,), "scale"), (f"{c}/batch_norm/bias", (h,), "shift"),
                (f"{c}/pointwise_conv2/kernel", (h, h), "matrix")]
            spec += _norm(f"{p}/ffn2_layer_norm", h) + _linear(f"{p}/ffn2/intermediate_dense", h, ff)
            spec += _linear(f"{p}/ffn2/output_dense", ff, h) + _norm(f"{p}/final_layer_norm", h)
        else:
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                spec += _linear(f"{p}/attention/{name}", h, h)
            spec += _norm(f"{p}/layer_norm", h) + _linear(f"{p}/feed_forward/intermediate_dense", h, ff)
            spec += _linear(f"{p}/feed_forward/output_dense", ff, h) + _norm(f"{p}/final_layer_norm", h)
    return spec + _linear("w2v/lm_head", h, enc["vocab_size"])


def state_spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    if cfg["encoder_family"] != "conformer":
        return []
    h = cfg["encoder"]["hidden_size"]
    return [s for i in range(cfg["encoder"]["num_hidden_layers"])
            for s in ((f"encoder/layers/{i}/batch_norm/mean", (h,), "shift"),
                      (f"encoder/layers/{i}/batch_norm/var", (h,), "variance"))]


def _nest(pairs) -> dict:
    """{path: tensor} -> nested dicts, with lists where the keys are indices."""
    root: dict = {}
    for path, t in pairs:
        node, parts = root, path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _fill(spec, flat: torch.Tensor) -> list:
    out, at = [], 0
    for path, shape, kind in spec:
        n = math.prod(shape)
        t = flat[at: at + n].view(shape)
        at += n
        if kind == "matrix":
            t.mul_(1.0 / math.sqrt(shape[-2]))
        elif kind == "depthwise":
            t.mul_(1.0 / math.sqrt(shape[0]))
        elif kind == "pos_v":
            t.mul_(1.0 / math.sqrt(shape[1] * shape[2]))
        elif kind == "bias":
            t.mul_(0.02)
        elif kind == "scale":
            t.mul_(0.05).add_(1.0)
        elif kind == "shift":
            t.mul_(0.05)
        elif kind == "variance":
            t.abs_().mul_(0.1).add_(1.0)
        elif kind == "day_weights":
            t.mul_(0.02).add_(torch.eye(shape[-1], device=t.device))
        out.append((path, t))
    for i, (path, t) in enumerate(out):  # weight norm's magnitude: the norm of its direction
        if path.endswith("weight_g"):
            v = out[i + 1][1]
            t.copy_(torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True)))
    return out


def make(cfg: dict, seed: int, device) -> Tuple[dict, dict]:
    """(params, state); the param leaves are views of one buffer."""
    spec, sspec = param_spec(cfg), state_spec(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in spec), generator=gen, device=device)
    sflat = torch.randn(max(1, sum(math.prod(s) for _, s, _ in sspec)), generator=gen, device=device)
    params = _nest(_fill(spec, flat))
    state = _nest(_fill(sspec, sflat)) if sspec else {}
    return params, {"encoder": state.get("encoder", {})}
