"""The CLI's numerics on the card: TF32 off, and the training step's
per-day sums in a fixed order.

- An experiment built through run.main's path (get_experiment_from_args:
  argv, ./config.yaml) turns TF32 off for cuBLAS and cuDNN, and so does
  predict.predict (CPU, tiny encoders);
- the preproc backward's per-day dW / db sums (ops/preproc.py::day_sum,
  which replaced index_add_'s float atomics) against jax.vjp of the JAX
  package's Pallas kernel (interpret mode) at f32, with days that repeat,
  and against index_add_;
- on a card (`cuda`): the w2v pos-conv (models/wav2vec2.py, cuDNN) of an
  experiment built by the CLI's path, at f32, against the f64 result
  within the f32 tolerance (2e-5 of the largest output); the preproc
  backward through autograd gives bitwise equal day tables in two runs.

jax is imported inside the CPU parity test only, so the `cuda` tests run
where jax is not installed.
"""

import numpy as np
import pytest
import torch

from wav2vec2forbrain_tpu_torch.args.argparsing import get_experiment_from_args
from wav2vec2forbrain_tpu_torch.data.dataset import sessionNames
from wav2vec2forbrain_tpu_torch.data.synthetic import make_synthetic_splits_dir
from wav2vec2forbrain_tpu_torch.models import pretrained
from wav2vec2forbrain_tpu_torch.models.conformer import ConformerEncoderConfig
from wav2vec2forbrain_tpu_torch.models.preprocessing import gaussian_kernel
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig, pos_conv_embed
from wav2vec2forbrain_tpu_torch.ops import preproc as port_pre
from wav2vec2forbrain_tpu_torch.predict import predict

torch.set_num_threads(2)
W2V_FLAGS = ["--experiment_type=b2p2t_gru+w2v", "--w2v_skip_loading_weights=true", "--batch_size=2",
             "--encoder_gru_hidden_size=32", "--encoder_num_gru_layers=1", "--device_data_cache=off"]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture
def cli_dir(tmp_path, monkeypatch):
    """A working directory with a config.yaml and two tiny synthetic sessions."""
    splits = make_synthetic_splits_dir(str(tmp_path / "t12"), session_names=sessionNames[:2], n_trials=4,
                                       n_blocks=2, seed=1, min_frames=40, max_frames=60)
    (tmp_path / "config.yaml").write_text(
        f"cache_dir: {tmp_path}/cache\nfig_dir: {tmp_path}/figs\nn3gram_lm_model_path: {tmp_path}/none.arpa\n"
        f"n5gram_lm_model_path: {tmp_path}/none5.arpa\ndataset_splits_dir: {splits}\nwandb_api_key: offline\n")
    monkeypatch.chdir(tmp_path)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    yield tmp_path
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _tiny_encoders(monkeypatch):
    monkeypatch.setattr(pretrained, "encoder_config_for_checkpoint",
                        lambda c: ("conformer", ConformerEncoderConfig.tiny_test()) if "conformer" in c
                        else ("wav2vec2", Wav2Vec2EncoderConfig.tiny_test()))


def test_the_cli_and_predict_turn_tf32_off(cli_dir, monkeypatch):
    _tiny_encoders(monkeypatch)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    exp = get_experiment_from_args(W2V_FLAGS, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    assert predict(exp.params, exp.model_state, exp.spec, []).metrics == []
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _preproc_inputs(seed, b, t):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, 256)).astype(np.float32)
    w = (np.eye(256)[None] + 0.05 * rng.standard_normal((24, 256, 256))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((24, 1, 256))).astype(np.float32)
    days = np.array([0, 7, 7, 23, 0, 7][:b], np.int32)
    return x, w, bias, days


@pytest.mark.parametrize("sigma", [0.3, 1.5])
def test_day_sums_match_jax_vjp(sigma):
    """Days 0, 7, 7, 23, 0, 7: three samples of day 7, two of day 0."""
    import jax
    import jax.numpy as jnp

    from wav2vec2forbrain_tpu.ops.pallas_preproc import fused_preproc as jax_pre

    x, w, bias, days = _preproc_inputs(11, 6, 64)
    feats, vjp = jax.vjp(lambda x, w, b: jax_pre(x, w, b, jnp.asarray(days), sigma),
                         *(jnp.asarray(a) for a in (x, w, bias)))
    g = (0.1 * np.random.default_rng(12).standard_normal(feats.shape)).astype(np.float32)
    _, dw_ref, db_ref = vjp(jnp.asarray(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w, bias)]
    port_pre.fused_preproc(*args, torch.from_numpy(days), gaussian_kernel(20, sigma)).backward(torch.from_numpy(g))
    for got, ref in ((args[1].grad, dw_ref), (args[2].grad, db_ref)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 2e-5 * max(1.0, np.abs(ref).max())
        assert not got[1].any() and got[7].abs().max() > 0  # days no sample has stay zero


def test_day_sum_against_index_add():
    rng = np.random.default_rng(3)
    parts = torch.from_numpy(rng.standard_normal((9, 5, 7)).astype(np.float32))
    days = torch.tensor([2, 0, 2, 2, 5, 0, 1, 2, 5], dtype=torch.int32)
    got = port_pre.day_sum(parts, days, 6)
    ref = torch.zeros((6, 5, 7)).index_add_(0, days.long(), parts)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)
    assert torch.equal(got, port_pre.day_sum(parts, days, 6))
    assert not got[3].any() and not got[4].any()


@pytest.mark.cuda
def test_cuda_pos_conv_under_the_cli_settings_holds_f32(cli_dir):
    """wav2vec2-base's pos-conv (768 channels, 128 taps, 16 groups: 6144-term
    sums) as the CLI builds it on the card, at f32, against f64."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    exp = get_experiment_from_args(W2V_FLAGS, device="cuda")
    assert exp.device.type == "cuda" and exp.base_config.compute_dtype == "float32"
    p = exp.params["w2v"]["encoder"]["pos_conv"]
    cfg = exp.spec.w2v_cfg
    x = torch.randn((4, 89, cfg.hidden_size), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    got = pos_conv_embed(p, x, cfg)
    ref = pos_conv_embed({k: v.double().cpu() for k, v in p.items()}, x.double().cpu(), cfg)
    err = (got.double().cpu() - ref).abs().max().item()
    assert err <= 2e-5 * max(1.0, ref.abs().max().item()), err


@pytest.mark.cuda
def test_cuda_preproc_day_tables_are_bitwise_reproducible():
    """The preproc backward through autograd at B 64 (days 0, 7, 23, 7, ...):
    two runs give bitwise equal dx and day tables."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((64, 384, 256), generator=gen, device=dev)
    w = torch.eye(256, device=dev)[None] + 0.05 * torch.randn((24, 256, 256), generator=gen, device=dev)
    bias = 0.1 * torch.randn((24, 1, 256), generator=gen, device=dev)
    days = torch.tensor([0, 7, 23, 7], dtype=torch.int32, device=dev).repeat(16)
    g = 0.1 * torch.randn((64, 89, 8192), generator=gen, device=dev)
    taps = gaussian_kernel(20, 1.5, dev)
    runs = []
    for _ in range(2):
        args = [a.clone().requires_grad_() for a in (x, w, bias)]
        port_pre.fused_preproc(*args, days, taps).backward(g)
        runs.append([a.grad for a in args])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
