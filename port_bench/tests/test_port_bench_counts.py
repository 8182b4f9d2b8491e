"""The yardstick's arithmetic: each op family's operations and bytes for
one shape against totals worked by hand, the trace's busy and idle
reduction on made-up intervals, and the mfu's operations against the
parameters a frame passes through at a tiny configuration."""

import pytest

from port_bench import trace, weights
from port_bench.counts import model_flops, ops
from port_bench.tests import tiny


@pytest.mark.parametrize("family, got, flops, nbytes", [
    # B 2, T 40, 3 taps, window 32 stride 4 -> T' 3: x 2*40*256, W 24*256*256, b 24*256, days 2, taps 3,
    # out 2*3*256*32; products 2*2*40*256*256 (affine) + 2*2*40*256*3 (smoothing)
    ("preproc", ops.preproc(2, 40, 3), 10485760 + 122880,
     4 * (20480 + 1572864 + 6144 + 2 + 3 + 49152)),
    ("preproc_bwd", ops.preproc_bwd(2, 40, 3), 2 * (10485760 + 122880),
     4 * ((20480 + 1572864 + 6144 + 2 + 3 + 49152) + 20480 + 1572864 + 6144)),
    # T' 5, B 2, H 4: 2*2*4*12*2*5 products; gi 5*2*2*12, W 2*4*12, b 2*12, h0 2*2*4, ys 5*2*2*4
    ("gru", ops.gru(5, 2, 4), 1920, 4 * (240 + 96 + 24 + 16 + 80)),
    ("gru_bwd fused", ops.gru_bwd(5, 2, 4, True), 3 * 1920, 4 * ((240 + 96 + 24 + 16 + 160) + (240 + 16 + 96 + 24))),
    ("gru_bwd per direction", ops.gru_bwd(5, 2, 4, False), 2 * 1920, 4 * ((240 + 96 + 24 + 16 + 160) + (240 + 16))),
    # B 2, T' 3, 2 heads of 4: q.k 2*2*2*9*4 = 288 products a side
    ("attention", ops.attention(2, 3, 2, 4), 576, 4 * 4 * 48),
    ("attention_bwd", ops.attention_bwd(2, 3, 2, 4), 1440, 4 * 7 * 48),
    # B 2, T' 3, C 4, 5 taps
    ("conv_glu", ops.conv_glu(2, 3, 4, 5), 240, 4 * (48 + 20 + 24)),
    ("conv_glu_bwd", ops.conv_glu_bwd(2, 3, 4, 5), 480, 4 * (2 * (48 + 20) + 24)),
    ("layernorm", ops.layernorm(6, 4), 168, 4 * (48 + 8)),
    ("layernorm_bwd", ops.layernorm_bwd(6, 4), 336, 4 * (72 + 12)),
    # frames 3 and 2, targets 1 and 0 -> states 3*3 + 2*1 = 11; K 5, U 1, T' 3
    ("ctc", ops.ctc(3, 5, 1, [3, 2], [1, 0], True), 11 * 29 + 5 * 5 * 5, 4 * (2 * 3 * 5 * 2 + 2 + 6)),
    ("ctc eval", ops.ctc(3, 5, 1, [3, 2], [1, 0], False), 11 * 12, 4 * (2 * 3 * 5 + 2 + 6)),
])
def test_op_counts(family, got, flops, nbytes):
    got_flops, got_bytes = got
    assert sum(n for n, _ in got_flops) == flops
    assert got_bytes == nbytes


def test_least_time_is_the_larger_bound():
    peaks = ops.PEAKS
    assert ops.least_s([(peaks["flops_per_s"]["tf32x3"], "tf32x3")], 0) == pytest.approx(1.0)
    assert ops.least_s([(1.0, "tf32x3")], peaks["hbm_bytes_per_s"] * 2) == pytest.approx(2.0)


def test_idle_share_of_made_up_intervals():
    # span 0-100; device busy 10-30, 20-40 (overlapping) and 60-70, and 95-145 clipped to 95-100: busy 45
    events = [("k1", 10, 20), ("k2", 20, 20), ("k3", 60, 10), ("late", 95, 50)]
    host = {"dispatch": [(40, 55)], "input_wait": [(72, 92)]}
    got = trace.reduce_events(events, (0, 100), host, [])
    assert got["span_s"] == pytest.approx(100e-9)
    assert got["busy_s"] == pytest.approx(45e-9)
    assert got["outside_s"] == pytest.approx(45e-9)
    gaps = dict((label.split(" (")[0], s) for label, s in got["breakdown"]["idle_gaps"])
    # gaps: 0-10 (no host span), 40-60 (dispatch at its middle, 50), 70-95 (input wait at 82)
    assert gaps["host: dispatching a step"] == pytest.approx(20e-9)
    assert gaps["host: waiting for a batch"] == pytest.approx(25e-9)
    assert gaps[trace.OTHER] == pytest.approx(10e-9)


def test_kernel_names_map_to_their_family():
    assert trace.family_of("void (anonymous namespace)::attention_fwd_mma_kernel<16, 32, 64>(float*)") == "attention"
    assert trace.family_of("layernorm_fwd_kernel(float const*)") == "layernorm"
    assert trace.family_of("layernorm_fwd_vec_kernel<true>(float const*)") == "layernorm"
    assert trace.family_of("gru_dw_kernel") == "gru_bwd"
    assert trace.family_of("ampere_sgemm_128x64_nn") is None


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_mfu_flops_are_the_parameters_a_frame_passes(family):
    cfg = tiny.config(family)
    spec = {p: s for p, s, _ in weights.param_spec(cfg)}
    enc, brain = cfg["encoder"], cfg["brain"]
    frames = 72
    t = (frames - brain["unfolder_kernel_len"]) // brain["unfolder_stride_len"]

    def numel(prefix, suffix=""):
        n = 0
        for p, s in spec.items():
            if p.startswith(prefix) and p.endswith(suffix) and len(s) > 1 and "weight_g" not in p:
                k = 1
                for x in s:
                    k *= x
                n += k
        return n

    # every product weight a frame passes: the encoder's, the GRU's, the FC's, the head's (biases and norms are
    # not products; the conformer's depthwise kernel is one multiply-add a tap and channel), the pos-conv's
    # grouped kernel once
    per_frame = (numel("w2v/encoder/layers/") + numel("brain/gru/") + numel("brain/fc/") + numel("w2v/lm_head")
                 + numel("w2v/encoder/pos_conv") * (family == "w2v"))
    attention = enc["num_hidden_layers"] * 2 * 2 * t * t * enc["hidden_size"]
    preproc = 2 * frames * 256 * 256 + 2 * frames * 256 * brain["smooth_taps"]
    assert model_flops.forward_flops(cfg, frames, enc["num_hidden_layers"]) == 2 * per_frame * t + attention + preproc
    assert model_flops.step_flops(cfg, [frames], enc["num_hidden_layers"], True) == \
        3 * model_flops.forward_flops(cfg, frames, enc["num_hidden_layers"])
