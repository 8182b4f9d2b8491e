"""The port's benchmark: one run of one cell, one JSON line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`) names a
configuration and a traffic mix; the run writes that mix's splits from the
seed into TMPDIR, builds the program's experiment on the card with weights
made from the seed, warms up, measures for --seconds, checks what the
window produced against the plain reference (port_bench/reference/) and
prints, as its last line, {"correct", "attempted", "failed", "metrics",
"device"[, "breakdown"], "checks"}. With --trace 0 the metrics are the
cell's end-to-end ones, with --trace 1 its per-layer ones (a few steps of
the window under torch.profiler).

It exits with a code other than 0 and prints no result where there is no
card, where the program cannot be imported, or where JAX or the JAX package
was loaded in the process.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()  # set-up counts from here: torch's import and the program's are loading too

ROOT = Path(__file__).resolve().parents[1]
# a library that would load JAX by itself keeps off it
for _name in ("USE_FLAX", "USE_TF"):
    os.environ[_name] = "0"
# build and kernel caches inside the checkout, at fixed paths (the port's own kernels build under build/kernels/)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness, report

    with open(ROOT / "BENCHMARK.json") as f:
        chips = {w["name"]: w["chips"] for w in json.load(f)["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    cell = harness.Cell.from_benchmark(args.workload)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"port_bench: the process loaded {found}", file=sys.stderr)
        return 3
    line = report.result_line(cell, result, bool(args.trace), torch.device("cuda"))
    print(f"port_bench: {args.workload} seed {args.seed}: setup {result['setup_s']:.2f} s, window "
          f"{result['window_s']:.2f} s, check {result['check_s']:.2f} s", file=sys.stderr)
    print(f"port_bench: set-up's stages end at (s) {json.dumps(result['setup_parts'])}", file=sys.stderr)
    if result.get("trace"):
        from port_bench.counts.ops import family_times
        from port_bench.trace import FAMILIES

        tr = result["trace"]
        shares = {f: round(100 * least / dev, 2) for f, (least, dev) in family_times(tr, cell.config, FAMILIES).items()}
        print(f"port_bench: roofline % by kernel family {json.dumps(shares)}", file=sys.stderr)
        print(f"port_bench: device seconds by category {json.dumps(tr['category_s'])}; by family "
              f"{json.dumps(tr['op_device_s'])}; outside the span {tr['outside_s']}", file=sys.stderr)
    report.print_checks(line["checks"], sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
