"""The result line of a run: its end-to-end or per-layer metrics, the
device, the trace's breakdown and the numbers `correct` was decided on.

End-to-end metrics are the harness's own clocks: `<kind>_samples_per_s`,
every sample of the window's completed steps over the window's time
(epoch and pass boundaries included), and `setup_s`. A per-layer metric is
read by port_bench/metrics/<name>.py, found by the metric's name; a reader
that finds nothing to read returns None and the metric is left out."""

import importlib.util
from pathlib import Path
from typing import Optional

import torch

from port_bench import check

PB = Path(__file__).resolve().parent


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", PB / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def context(cell, result: dict) -> dict:
    """What the per-layer readers read."""
    return {"kind": cell.kind, "config": cell.config, "steps": result["steps"], "window_s": result["window_s"],
            "layerdrop": result.get("layerdrop"), "trace": result.get("trace")}


def device_info(device: torch.device, result: dict, trace: bool) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = result["memory_peak_bytes"]
    if trace and result.get("trace"):
        info["busy_s"] = result["trace"]["busy_s"]
        info["window_s"] = result["trace"]["span_s"]
    return info


def result_line(cell, result: dict, trace: bool, device: torch.device) -> dict:
    samples = sum(s["true_b"] for s in result["steps"])
    metrics = {}
    if trace:
        ctx = context(cell, result)
        for m in cell.per_layer:
            value: Optional[float] = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics[f"{cell.kind}_samples_per_s"] = {"value": samples / result["window_s"], "unit": "samples/s"}
        metrics["setup_s"] = {"value": result["setup_s"], "unit": "s"}
    numbers = result["readings"]["numbers"]
    line = {"correct": check.verdict(numbers, cell.limits), "attempted": samples, "failed": 0,
            "metrics": metrics, "device": device_info(device, result, trace)}
    if trace and result.get("trace"):
        line["breakdown"] = result["trace"]["breakdown"]
    line["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in cell.limits}
    return line


def print_checks(checks: dict, stream) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=stream)
