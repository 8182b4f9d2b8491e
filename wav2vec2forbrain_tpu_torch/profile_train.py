"""Device-time breakdown of a full-width train step on one CUDA card.

    python -m wav2vec2forbrain_tpu_torch.profile_train [--family conformer|w2v] [--policy auto|none|...]
        [--compute-dtype bfloat16|float32] [--pos-conv deterministic|default]

--family conformer (default): `b2p2t_gru+w2v_conformer` at full width
(conformer-rope-large: 24 layers, d=1024, 16 heads, FFN 4096, k=31; biGRU
2 x 256), dropout 0.1 everywhere and LayerDrop 0.1, Adam at weight decay 0,
batches of 32. --family w2v: `b2p2t_gru+w2v` at the fft sweep point
(sweeps/b2p2t_gru+w2v_full_fine_tuning.yaml: wav2vec2-base-960h encoder,
12 post-LN layers, d=768, 12 heads, FFN 3072, dropouts and LayerDrop 0.1;
biGRU 3 x 1024 with dropout 0.45, no FC hidden layer, latent 768,
gaussian_smooth_width 1.5), Adam at weight decay 1e-4, batches of 64. Both:
random weights from a fixed seed, bf16 compute (--compute-dtype float32:
f32, the CLI's default) with an f32 activation stream, unfreeze_strategy "brain_encoder+w2v" at LRs 1e-4 / 1e-5,
augmentation at the sweeps' whiteNoiseSD 0.02 / constantOffsetSD 0.25, 384
frames. Warms up with one step, runs STEPS steps through train_batches
without the profiler and then STEPS more under torch.profiler. Prints the
card's name and power limit, the ops with the most device time, the
device-busy share of the profiled wall window (summed kernel time / wall
time; one stream, so kernels do not overlap) and of the unprofiled one, and
wall ms per step of both. --pos-conv default runs w2v-base's pos-conv as a
plain F.conv1d, without cuDNN's deterministic flag
(models/wav2vec2.py::DETERMINISTIC_POS_CONV): the cost of bitwise
reproducible w2v-base training. Needs a CUDA card; it has no CPU path.
"""

import argparse
import subprocess
import time
from typing import Any, NamedTuple

import torch

from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec, init_model_params, param_labels
from wav2vec2forbrain_tpu_torch.models import wav2vec2
from wav2vec2forbrain_tpu_torch.models.seeds import StepRng
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig
from wav2vec2forbrain_tpu_torch.ops import select
from wav2vec2forbrain_tpu_torch.profile_predict import _device_us, _on_device
from wav2vec2forbrain_tpu_torch.train.optim import make_optimizer
from wav2vec2forbrain_tpu_torch.train.steps import StepConfig, build_train_step
from wav2vec2forbrain_tpu_torch.train.train_loop import train_batches

BRAIN_LR, W2V_LR = 1e-4, 1e-5
STEPS = 2
STEP_CFG = StepConfig(gradient_clipping=None, white_noise_sd=0.02, constant_offset_sd=0.25)


# family -> (ModelSpec fields, Adam weight decay, batch size)
FAMILIES = {
    "conformer": (dict(gru_dropout=0.1), 0.0, 32),
    "w2v": (dict(encoder_family="wav2vec2", w2v_cfg=Wav2Vec2EncoderConfig.base_960h(), latent_size=768,
                 gru_hidden_size=1024, gru_num_layers=3, gru_dropout=0.45, fc_hidden_sizes=(),
                 gaussian_smooth_width=1.5), 1e-4, 64),
}


class Trainer(NamedTuple):
    spec: ModelSpec
    params: dict
    state: dict
    labels: dict
    optimizer: Any
    opt_state: Any
    train_step: Any
    batch_size: int


def build_trainer(device, seed: int = 0, family: str = "conformer", compute_dtype=torch.bfloat16) -> Trainer:
    """The full-width training setup of `family` above, on `device`."""
    fields, weight_decay, batch_size = FAMILIES[family]
    spec = ModelSpec(compute_dtype=compute_dtype, activation_dtype=torch.float32, **fields)
    params, state = init_model_params(torch.Generator(device=device).manual_seed(seed), spec, device)
    labels = param_labels(params, "brain_encoder+w2v")
    optimizer = make_optimizer(labels, "adam", weight_decay)
    return Trainer(spec, params, state, labels, optimizer, optimizer.init(params),
                   build_train_step(spec, labels, optimizer, STEP_CFG), batch_size)


_PORT_KERNELS = ("attention_", "gru_", "conv_glu_", "smooth_affine", "unfold_kernel", "bwd_dz_dy", "bwd_dw", "bwd_dx",
                 "layernorm_")


def _category(name: str) -> str:
    """Coarse device-time category of a kernel name."""
    if "(anonymous namespace)::" in name and any(k in name for k in _PORT_KERNELS):
        return "port CUDA kernels (csrc/)"
    if any(k in name.lower() for k in ("nvjet", "gemm", "cutlass")):
        return "GEMMs (cuBLAS)"
    if "<long" in name:
        return "int64 elementwise (hash-dropout masks)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy / memset"
    return "other elementwise, reductions, copies"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="conformer", choices=sorted(FAMILIES), help="model family (see above)")
    ap.add_argument("--policy", default="auto", help="kernel policy (ops/select.py)")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="the model's compute dtype (the activation stream stays float32)")
    ap.add_argument("--pos-conv", default="deterministic", choices=("deterministic", "default"),
                    help="w2v-base's pos-conv with cuDNN's deterministic flag, or a plain F.conv1d")
    args = ap.parse_args(argv)
    wav2vec2.DETERMINISTIC_POS_CONV = args.pos_conv == "deterministic"
    top = 30
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")
    select.f32_products()
    dev = torch.device("cuda", 0)
    select.set_kernel_policy(args.policy)
    tr = build_trainer(dev, family=args.family, compute_dtype=getattr(torch, args.compute_dtype))
    rng = StepRng(0, dev)
    batches = make_requests(STEPS + 1, tr.batch_size, 384, seed=0)
    run = train_batches(tr.train_step, tr.params, tr.opt_state, tr.state, batches[:1], rng, BRAIN_LR, W2V_LR)
    torch.cuda.synchronize()
    # the same steps without the profiler, for the wall time the idle share is taken against
    t = time.perf_counter()
    run = train_batches(tr.train_step, tr.params, run.opt_state, run.model_state, batches[1:], rng,
                        BRAIN_LR, W2V_LR)
    torch.cuda.synchronize()
    bare_wall = time.perf_counter() - t

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        run = train_batches(tr.train_step, tr.params, run.opt_state, run.model_state, batches[1:], rng,
                            BRAIN_LR, W2V_LR)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = [e for e in prof.key_averages() if _on_device(e) and _device_us(e) > 0]
    events.sort(key=_device_us, reverse=True)
    total_us = sum(_device_us(e) for e in events)
    print(f"family {args.family}, policy {args.policy}, compute {args.compute_dtype}, pos-conv {args.pos_conv}, "
          f"batch {tr.batch_size}: "
          f"{STEPS} train steps in {wall * 1e3:.2f} ms wall "
          f"({wall * 1e3 / STEPS:.2f} ms/step), device busy {total_us / 1e3:.2f} ms "
          f"= {100 * total_us / 1e6 / wall:.1f}% of wall; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"without the profiler: {bare_wall * 1e3 / STEPS:.2f} ms/step wall; device busy "
          f"{100 * total_us / 1e6 / bare_wall:.1f}%, idle {100 - 100 * total_us / 1e6 / bare_wall:.1f}% "
          f"(profiled device time over the unprofiled wall; other seeds, same shapes)")
    by_cat = {}
    for e in events:
        by_cat[_category(e.key)] = by_cat.get(_category(e.key), 0.0) + _device_us(e)
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:40s} {us / 1e3 / STEPS:9.2f} ms/step {100 * us / total_us:5.1f}%")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  op")
    for e in events[:top]:
        us = _device_us(e)
        print(f"{us / 1e3:10.3f} {100 * us / total_us:5.1f}% {e.count:6d}  {e.key[:110]}")


if __name__ == "__main__":
    main()
