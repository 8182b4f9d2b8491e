"""The control of a cell's check: the plain reference computed in TF32 (the
next precision below the configurations' float32 with TF32 off) put in the
program's place, on the cell's own inputs and sizes, through the same
comparison (check.py). Its readings are the upper ends the limits sit
below; a limit that the control passes would not catch a program that
dropped to TF32. With --fault half_batch (train cells) the reference whose
loss leaves out half of each batch's rows takes the program's place
instead: a fault each train cell's limits must also catch.

    python3 port_bench/control.py --workload <name> --seeds <n> [<n> ...] [--fault half_batch]

prints one JSON line a seed. Train cells: `check_steps` steps on full
batches of the train split, drawn from the seed as the program's first
batches are; serve cells: the test split in the loader's order, the batch
with the longest trial and `check_batches - 1` more from the seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def train_control(cell, seed: int, device, fault: str = "") -> dict:
    import numpy as np

    from port_bench import check, traffic_gen
    from port_bench.reference import data as ref_data
    from port_bench.seeds import StepDraws, seeds_per_step

    sessions = traffic_gen.make_sessions(cell.traffic, seed)
    trials = ref_data.Trials(sessions)
    keys = [(s.day, n) for s in sessions for n, b in zip(s.lengths, s.blocks) if b != s.blocks.min()]
    rng = np.random.default_rng([int(seed), 5])
    order = rng.permutation(len(keys))
    rows, steps = cell.config["flags"]["batch_size"], cell.traffic["check_steps"]
    batches = []
    for k in range(steps):
        chosen = [keys[i] for i in order[k * rows:(k + 1) * rows]]
        batches.append({"days": [d for d, _ in chosen], "lens": [n for _, n in chosen], "rows": rows})
    enc = cell.config["encoder"]
    phase = float(rng.random())
    draws = [StepDraws(rng, enc["num_hidden_layers"], enc["layerdrop"], seeds_per_step(enc["num_hidden_layers"]), k,
                       phase)
             for k in range(steps)]
    noise_seed, epoch = int(rng.integers(2**62)), cell.config["first_epoch"]
    ref = check.reference_steps(cell.config, seed, trials, batches, draws, noise_seed, epoch, device, "f32")
    low = check.reference_steps(cell.config, seed, trials, batches, draws, noise_seed, epoch, device,
                                "f32" if fault else "tf32", half_batch=fault == "half_batch")
    return check.train_numbers(low, ref)


def serve_control(cell, seed: int, device) -> dict:
    import numpy as np
    import torch

    from port_bench import check, traffic_gen, weights
    from port_bench.reference import data as ref_data

    sessions = traffic_gen.make_sessions(cell.traffic, seed)
    trials = ref_data.Trials(sessions)
    keys = [(s.day, n) for s in sessions for n, b in zip(s.lengths, s.blocks) if b == s.blocks.min()]
    rows = cell.config["flags"]["batch_size"]
    passes = [keys[i:i + rows] for i in range(0, len(keys), rows)]
    longest = max(range(len(passes)), key=lambda i: max(n for _, n in passes[i]))
    rng = np.random.default_rng([int(seed), 3])
    rest = [i for i in range(len(passes)) if i != longest]
    sample = [longest] + rng.choice(rest, size=min(cell.traffic["check_batches"] - 1, len(rest)),
                                    replace=False).tolist()
    params, state = weights.make(cell.config, seed, device)
    gap = rel = 0.0
    for i in sample:
        rec = {"days": [d for d, _ in passes[i]], "lens": [n for _, n in passes[i]]}
        ref, lens = check.reference_logits(cell.config, params, state, trials, rec, device, "f32")
        low, _ = check.reference_logits(cell.config, params, state, trials, rec, device, "tf32")
        gap = max(gap, check.token_gap(ref, lens, torch.argmax(low, dim=-1)))
        rel = max(rel, check.logit_rel(low, ref, lens))
    return {"numbers": {"logit_gap": gap, "logit_rel": rel, "lens_mismatch": 0.0}, "notes": {"batches": sample}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("half_batch",), default="")
    args = ap.parse_args(argv)

    import torch

    from port_bench.harness import Cell

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell.from_benchmark(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        if cell.kind == "train":
            got = train_control(cell, seed, torch.device("cuda"), args.fault)
        else:
            got = serve_control(cell, seed, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed, "in_place": args.fault or "tf32", "seconds":
                          time.perf_counter() - t, **got}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
