"""The traced segment's reduction, from the profiler's raw events (summing
them directly: key_averages() over many steps takes tens of seconds).

- span: from just before the first traced step's dispatch to just after a
  synchronize past the last (the harness's wall clock, the clock the
  profiler stamps device events with);
- busy: the union of the device's kernel, copy and set intervals in it;
- each op family's device seconds (counts/kernel_ops.json's kernel names);
- the idle gaps between busy intervals, each labelled by the harness span
  the host was in at its middle: waiting for a batch, dispatching a step,
  or neither (the evaluator, the epoch's or pass's boundary, the lag-1
  fetch of the last step's outputs).
"""

import json
import re
from pathlib import Path
from typing import Dict, List, Tuple

import torch

PB = Path(__file__).resolve().parent
OTHER = "host: evaluator, outputs fetch, epoch or pass boundary"
with open(PB / "counts" / "kernel_ops.json") as _f:
    FAMILIES = json.load(_f)["families"]
_PATTERNS = {fam: re.compile("|".join(rf"(?<![A-Za-z0-9_]){re.escape(k)}(?![A-Za-z0-9_])" for k in spec["kernels"]))
             for fam, spec in FAMILIES.items()}


def family_of(kernel_name: str):
    for fam, pattern in _PATTERNS.items():
        if pattern.search(kernel_name):
            return fam
    return None


def category(name: str) -> str:
    """Coarse device-time category of a kernel name."""
    if family_of(name) is not None:
        return "port kernels"
    low = name.lower()
    if any(k in low for k in ("nvjet", "gemm", "cutlass", "cublas")):
        return "GEMMs"
    if "<long" in name or "int64" in low:
        return "int64 elementwise (hash-dropout masks)"
    if "memcpy" in low or "memset" in low:
        return "memcpy / memset"
    if "conv" in low or "cudnn" in low:
        return "cuDNN convolution"
    return "other elementwise, reductions, copies"


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def gaps_of(busy: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def label_gaps(gaps, host_spans: Dict[str, List[Tuple[int, int]]]) -> Dict[str, Tuple[float, int]]:
    """{label: (idle ns, gap count)}."""
    totals: Dict[str, Tuple[float, int]] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        label = next((name for name, spans in host_spans.items() if any(s <= mid < e for s, e in spans)), OTHER)
        ns, n = totals.get(label, (0.0, 0))
        totals[label] = (ns + (b - a), n + 1)
    return totals


def reduce_events(events, span_ns, host_spans: Dict[str, List[Tuple[int, int]]], traced_steps: List[dict]) -> dict:
    """events: (name, start_ns, duration_ns) of the device's activity;
    span_ns: the traced segment; host_spans: {"input_wait" | "dispatch": [(start, end)]}."""
    lo, hi = span_ns
    if lo is None or hi is None or hi <= lo:
        return {}
    device, by_kernel, outside = [], {}, 0
    for name, s, d in events:
        a, b = max(s, lo), min(s + d, hi)
        outside += d - max(0, b - a)
        if b > a:
            device.append((a, b))
            by_kernel[name] = by_kernel.get(name, 0) + (b - a)
    busy = merge(device)
    busy_ns = sum(b - a for a, b in busy)
    if busy_ns == 0:
        return {}
    op_ns: Dict[str, float] = {}
    by_category: Dict[str, float] = {}
    for name, ns in by_kernel.items():
        fam = family_of(name)
        if fam is not None:
            op_ns[fam] = op_ns.get(fam, 0) + ns
        cat = category(name)
        by_category[cat] = by_category.get(cat, 0) + ns
    labels = {"host: waiting for a batch": host_spans.get("input_wait", []),
              "host: dispatching a step": host_spans.get("dispatch", [])}
    labelled = label_gaps(gaps_of(busy, lo, hi), labels)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    breakdown = {
        "device_ops": [[f"[{category(n)}] {n[:120]}", ns / 1e9] for n, ns in top],
        "idle_gaps": [[f"{label} ({n} gaps)", ns / 1e9] for label, (ns, n) in
                      sorted(labelled.items(), key=lambda kv: -kv[1][0])][:10],
    }
    return {"span_s": (hi - lo) / 1e9, "busy_s": busy_ns / 1e9, "outside_s": outside / 1e9,
            "op_device_s": {k: v / 1e9 for k, v in op_ns.items()},
            "category_s": {k: v / 1e9 for k, v in by_category.items()}, "breakdown": breakdown,
            "steps": traced_steps}


def reduce(prof, span_ns, host_spans, traced_steps: List[dict]) -> dict:
    cpu = torch.autograd.DeviceType.CPU
    events = [(e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
              if e.device_type() != cpu and not e.is_user_annotation()]
    return reduce_events(events, span_ns, host_spans, traced_steps)
