"""Device-time breakdown of the serving forward on one CUDA card.

    python -m wav2vec2forbrain_tpu_torch.profile_predict [--family conformer|w2v] [--policy auto|none|...]
        [--compute-dtype bfloat16|float32]

Builds the full-width model of the family (profile_train.FAMILIES:
conformer-rope-large with a biGRU 2 x 256 at batch 32, or wav2vec2-base
with a biGRU 3 x 1024 at batch 64; random weights, fixed seed; bf16
compute or --compute-dtype float32, an f32 activation stream), warms up,
then runs 2 requests of 384 frames through predict() under torch.profiler.
Prints the card's name and power limit, the ops with the most device time,
the device-busy share of the profiled wall window (summed kernel time /
wall time; one stream, so kernels do not overlap), and wall ms per batch.
Needs a CUDA card; it has no CPU path.
"""

import argparse
import subprocess
import time

import torch

from wav2vec2forbrain_tpu_torch.data.synthetic import make_requests
from wav2vec2forbrain_tpu_torch.models.assembly import ModelSpec, init_model_params
from wav2vec2forbrain_tpu_torch.ops import select
from wav2vec2forbrain_tpu_torch.predict import predict


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


def _on_device(evt) -> bool:
    """Kernels and copies themselves, not the host-side aten ops that launched
    them (those carry the same device time again)."""
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


def main(argv=None) -> None:
    from wav2vec2forbrain_tpu_torch.profile_train import FAMILIES  # profile_train imports this module

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="conformer", choices=sorted(FAMILIES), help="model family (see above)")
    ap.add_argument("--policy", default="auto", help="kernel policy (ops/select.py)")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="the model's compute dtype (the activation stream stays float32)")
    args = ap.parse_args(argv)
    fields, _, batch_size = FAMILIES[args.family]
    n_batches, top = 2, 25
    if not torch.cuda.is_available():
        raise SystemExit("profile_predict: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")
    select.f32_products()
    dev = torch.device("cuda", 0)
    select.set_kernel_policy(args.policy)
    spec = ModelSpec(compute_dtype=getattr(torch, args.compute_dtype), activation_dtype=torch.float32, **fields)
    params, state = init_model_params(torch.Generator(device=dev).manual_seed(0), spec, dev)
    batches = make_requests(n_batches + 1, batch_size, 384, seed=0)
    predict(params, state, spec, batches[:1])
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        predict(params, state, spec, batches[1:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = [e for e in prof.key_averages() if _on_device(e) and _device_us(e) > 0]
    events.sort(key=_device_us, reverse=True)
    total_us = sum(_device_us(e) for e in events)
    print(f"family {args.family}, policy {args.policy}, compute {args.compute_dtype}, batch {batch_size}: "
          f"{n_batches} batches in {wall * 1e3:.2f} ms wall "
          f"({wall * 1e3 / n_batches:.2f} ms/batch), device busy {total_us / 1e3:.2f} ms "
          f"= {100 * total_us / 1e6 / wall:.1f}% of wall")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  op")
    for e in events[:top]:
        us = _device_us(e)
        print(f"{us / 1e3:10.3f} {100 * us / total_us:5.1f}% {e.count:6d}  {e.key[:110]}")


if __name__ == "__main__":
    main()
