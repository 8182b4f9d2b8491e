"""The control (control.py) at tiny sizes on the CPU: the reference computed
in TF32 (operands rounded to TF32's 10-bit mantissa) in the program's
place fails at least one of each cell's limits, as it does on the card at
the cells' own sizes (PERF.md gives those readings)."""

import json
from pathlib import Path

import pytest
import torch

from port_bench import control
from port_bench.check import verdict
from port_bench.harness import Cell
from port_bench.tests import tiny

PB = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)
CELLS = {"conformer.train": ("conformer", "train"), "w2v-base.train": ("w2v", "train"),
         "conformer.serve": ("conformer", "serve"), "w2v-base.serve": ("w2v", "serve")}
# w2v-base's serve path has no cell yet (PERF.md, Open questions): its tiny run is held to conformer.serve's limits
LIMITS = {"w2v-base.serve": "conformer.serve"}


def _limits(workload: str) -> dict:
    with open(PB / "limits" / f"{LIMITS.get(workload, workload)}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("seed", [1, 2])
def test_the_tf32_control_fails_a_limit(workload, seed):
    family, kind = CELLS[workload]
    cell = tiny.cell(family, kind, limits=_limits(workload))
    fn = control.train_control if kind == "train" else control.serve_control
    got = fn(cell, seed, torch.device("cpu"))
    assert not verdict(got["numbers"], cell.limits), got["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(set(CELLS) - set(LIMITS)))
def test_the_tf32_control_fails_a_limit_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = Cell.from_benchmark(workload)
    fn = control.train_control if cell.kind == "train" else control.serve_control
    got = fn(cell, 2**31 + 5, torch.device("cuda"))
    assert not verdict(got["numbers"], cell.limits), got["numbers"]
