"""The operations a forward pass needs for one sample, on its valid frames
only: L frames in, (L - kernel) // stride frames after the unfold, and
encoder layers as many as ran. Products only (2 a multiply-add);
elementwise work, recomputation and padded frames are not counted. A
training step needs three times its forward (forward, and the two products
of the backward)."""


def forward_flops(cfg: dict, frames: int, layers_ran: int) -> float:
    brain, enc = cfg["brain"], cfg["encoder"]
    k, s = brain["unfolder_kernel_len"], brain["unfolder_stride_len"]
    t = (frames - k) // s
    if t <= 0:
        return 0.0
    c = 256
    flops = 2 * frames * c * c + 2 * frames * c * brain["smooth_taps"]  # the day's affine and the smoothing
    h_gru = brain["gru_hidden_size"]
    width = c * k
    for _ in range(brain["gru_num_layers"]):
        flops += 2 * (2 * t * width * 3 * h_gru + 2 * t * h_gru * 3 * h_gru)  # both directions
        width = 2 * h_gru
    for out in list(brain["fc_hidden_sizes"]) + [enc["hidden_size"]]:
        flops += 2 * t * width * out
        width = out
    d, ff = enc["hidden_size"], enc["intermediate_size"]
    attn = 4 * 2 * t * d * d + 2 * 2 * t * t * d  # q, k, v, out; q.k and p.v
    if cfg["encoder_family"] == "conformer":
        ks = enc["conv_depthwise_kernel_size"]
        layer = attn + 2 * (2 * 2 * t * d * ff) + 2 * t * d * 2 * d + 2 * t * d * ks + 2 * t * d * d
    else:
        layer = attn + 2 * 2 * t * d * ff
        groups, kp = enc["num_conv_pos_embedding_groups"], enc["num_conv_pos_embeddings"]
        flops += 2 * t * d * (d // groups) * kp
    return flops + layers_ran * layer + 2 * t * d * enc["vocab_size"]


def step_flops(cfg: dict, lens, layers_ran: int, train: bool) -> float:
    return (3 if train else 1) * sum(forward_flops(cfg, n, layers_ran) for n in lens)
