"""Device-time breakdown of a full-width train step on one CUDA card.

    python -m wav2vec2forbrain_tpu_torch.profile_train [--family conformer|w2v] [--policy auto|none|...]
        [--compute-dtype bfloat16|float32] [--pos-conv deterministic|default] [--remat-policy none|min|...]

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
reproducible w2v-base training. --remat-policy checkpoints each encoder
layer under that policy (models/remat.py; default none): the recompute's
kernels and products show in the breakdown. --memory prints, instead of
the time breakdown, where one train step (after a warm-up step) reaches
its peak allocation: every op the step dispatches (the backward's too)
is logged with the bytes allocated before it and the allocator's peak
after it, and the ops are listed by the peak they reached, each with
the autograd node it ran in (none: the forward) and the bytes it
allocated beyond what was live before it. Needs a CUDA card; it has no
CPU path.
"""

import argparse
import subprocess
import time
from typing import Any, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from wav2vec2forbrain_tpu_torch.data.batch import to_device
from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec, init_model_params, param_labels
from wav2vec2forbrain_tpu_torch.models import remat, wav2vec2
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


def build_trainer(device, seed: int = 0, family: str = "conformer", compute_dtype=torch.bfloat16,
                  remat_policy: str = "none") -> Trainer:
    """The full-width training setup of `family` above, on `device`."""
    fields, weight_decay, batch_size = FAMILIES[family]
    spec = ModelSpec(compute_dtype=compute_dtype, activation_dtype=torch.float32, remat_policy=remat_policy,
                     **fields)
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


class _OpMemory(TorchDispatchMode):
    """Logs (op, autograd node or None, bytes allocated before the op, the
    allocator's peak after it) for every op dispatched under it."""

    def __init__(self, device):
        super().__init__()
        self.device, self.rows = device, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = torch.cuda.memory_allocated(self.device)
        out = func(*args, **(kwargs or {}))
        node = torch._C._current_autograd_node()
        self.rows.append((str(func), None if node is None else node.name(), before,
                          torch.cuda.max_memory_allocated(self.device)))
        return out


def memory_peak(tr: Trainer, batches, rng: StepRng, device, top: int) -> None:
    """--memory: one warm-up step, then one step under _OpMemory; prints the
    step's peak and the ops that reached the highest peaks."""
    run = train_batches(tr.train_step, tr.params, tr.opt_state, tr.state, batches[:1], rng, BRAIN_LR, W2V_LR)
    batch = to_device(batches[1], device)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    with _OpMemory(device) as log:
        tr.train_step(tr.params, run.opt_state, run.model_state, batch, rng, BRAIN_LR, W2V_LR)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    print(f"peak {peak / 2**30:.3f} GiB, {resident / 2**30:.3f} GiB allocated before the step; "
          f"{len(log.rows)} ops dispatched")
    # an op that raised the peak: the first row at each new peak value
    rises, high = [], resident
    for i, (op, node, before, after) in enumerate(log.rows):
        if after > high:
            rises.append((after, i, op, node, before))
            high = after
    print(f"{'peak GiB':>9} {'live before':>11} {'op adds':>9} {'op #':>6}  op (autograd node)")
    for after, i, op, node, before in sorted(rises, reverse=True)[:top]:
        print(f"{after / 2**30:9.3f} {before / 2**30:11.3f} {(after - before) / 2**30:9.3f} {i:6d}  "
              f"{op} ({node or 'forward'})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="conformer", choices=sorted(FAMILIES), help="model family (see above)")
    ap.add_argument("--policy", default="auto", help="kernel policy (ops/select.py)")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="the model's compute dtype (the activation stream stays float32)")
    ap.add_argument("--pos-conv", default="deterministic", choices=("deterministic", "default"),
                    help="w2v-base's pos-conv with cuDNN's deterministic flag, or a plain F.conv1d")
    ap.add_argument("--remat-policy", default="none", choices=remat.POLICIES,
                    help="what each train-mode encoder layer keeps for its backward (models/remat.py)")
    ap.add_argument("--memory", action="store_true", help="where the step's peak allocation is reached (above)")
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
    tr = build_trainer(dev, family=args.family, compute_dtype=getattr(torch, args.compute_dtype),
                       remat_policy=args.remat_policy)
    rng = StepRng(0, dev)
    batches = make_requests(STEPS + 1, tr.batch_size, 384, seed=0)
    if args.memory:
        print(f"family {args.family}, compute {args.compute_dtype}, remat {args.remat_policy}, "
              f"batch {tr.batch_size} x 384 frames")
        memory_peak(tr, batches, rng, dev, top)
        return
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
          f"remat {args.remat_policy}, batch {tr.batch_size}: "
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
