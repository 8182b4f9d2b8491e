"""The program's phases in a traced run: the port's own spans
(wav2vec2forbrain_tpu_torch/util/profiling.py) laid over the profiler's
device events and CUDA runtime launch calls, on the clock they share
(time.time_ns()).

    python3 port_bench/phases.py --workload <name> --seed <n> --seconds <s>

runs `port_bench/run.py --trace 1` with the program's span recorder on over
the traced steps, the same steps the profiler covers. The harness's files
are not changed: `recorded` wraps `harness.Window`'s start and stop of the
trace and `trace.reduce_events` in this process, so the result line
(stdout's last) is run.py's, read with the recorder on. On stderr it adds,
for each span name, its host ms, self ms, idle ms and kernel launches a
step, and a line `port_bench phases: {...}` holding `reduce`'s section, the
readings of the `readings` names and `consistency`, the section set against
the harness's own spans. `recorded` and `main` stand in for the calls the
harness and `trace.reduce` would make of `reduce`, `readings` and
`print_table`, and go when they make them.

`reduce` is the reduction a traced run would report as a `program`
section: each idle gap of the traced segment put down to the main thread's
phase at its middle (the innermost of PHASES among the main thread's open
spans, else the root step's self time, else "outside spans"), and each
kernel launch call to the spans open on its own thread at its start, and,
for a launch on a thread that is neither the main thread nor an input
worker (autograd's device thread: the backward and its masks), to the main
thread's spans open then too.
"""

import bisect
import contextlib
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench import trace as bench_trace  # noqa: E402

PHASES = ("forward", "backward", "optimizer", "fetch", "evaluator", "input_wait")
ROOTS = ("train_step", "eval_step")
INPUT_SPANS = ("collate", "place")  # a thread that records these is an input worker
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")
OUTSIDE = "outside spans"
THREAD_MASK = 0xFFFFFFFF  # spans' thread ids (threading.get_ident()) are compared with launches' by their low 32 bits


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_PREFIXES)


class _ThreadSpans:
    """One thread's spans, for the chain of spans open at a time: the span
    with the latest start at or before t, then up its parents while they
    do not hold t (spans of one thread nest, so the innermost span holding
    t is an ancestor of that one, or that one)."""

    def __init__(self, rows: List[int], spans: list):
        self.spans = spans
        self.rows = sorted(rows, key=lambda r: spans[r][1])
        self.starts = [spans[r][1] for r in self.rows]

    def chain(self, t: int) -> List[int]:
        k = bisect.bisect_right(self.starts, t) - 1
        row = self.rows[k] if k >= 0 else -1
        while row >= 0 and not (self.spans[row][2] is not None and t < self.spans[row][2]):
            row = self.spans[row][3]
        out = []
        while row >= 0:
            out.append(row)
            row = self.spans[row][3]
        return out


def _gaps(device_events, span_ns: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The idle gaps of the segment, as trace.reduce_events finds them."""
    lo, hi = span_ns
    busy = bench_trace.merge([(max(s, lo), min(s + d, hi)) for _, s, d in device_events if min(s + d, hi) > max(s, lo)])
    return bench_trace.gaps_of(busy, lo, hi)


def _phase(names: List[str]) -> str:
    for name in names:
        if name in PHASES:
            return name
    return f"{names[-1]} (self)" if names and names[-1] in ROOTS else OUTSIDE


def reduce(device_events, launches, span_ns: Tuple[int, int], recording: dict) -> dict:
    """device_events: (name, start_ns, duration_ns) of the device's
    activity; launches: (name, start_ns, duration_ns, thread) of the CUDA
    runtime's kernel-launch calls; span_ns: the traced segment; recording:
    util/profiling.py::stop()'s. {} where the segment holds no root step."""
    lo, hi = span_ns
    spans = [[n, t0, t1, p, tid & THREAD_MASK, i] for n, t0, t1, p, tid, i in recording["spans"]]
    inside = [r for r, s in enumerate(spans) if s[2] is not None and lo <= s[1] and s[2] <= hi]
    roots = [r for r in inside if spans[r][0] in ROOTS and spans[r][3] < 0]
    if not roots:
        return {}
    main = max({spans[r][4] for r in roots}, key=lambda tid: sum(spans[r][4] == tid for r in roots))
    by_thread: Dict[int, List[int]] = {}
    for r, s in enumerate(spans):
        if s[2] is not None:
            by_thread.setdefault(s[4], []).append(r)
    threads = {tid: _ThreadSpans(rows, spans) for tid, rows in by_thread.items()}
    workers = {tid for tid, rows in by_thread.items() if any(spans[r][0] in INPUT_SPANS for r in rows)}
    names_of = lambda rows: [spans[r][0] for r in rows]  # noqa: E731

    per_name: Dict[str, dict] = {}
    child_ns = {}
    for r in inside:
        if spans[r][3] >= 0:
            child_ns[spans[r][3]] = child_ns.get(spans[r][3], 0) + spans[r][2] - spans[r][1]
    for r in inside:
        name, t0, t1 = spans[r][:3]
        p = per_name.setdefault(name, {"count": 0, "host_ms": 0.0, "self_ms": 0.0, "idle_ms": 0.0, "launches": 0})
        p["count"] += 1
        p["host_ms"] += (t1 - t0) / 1e6
        p["self_ms"] += (t1 - t0 - child_ns.get(r, 0)) / 1e6

    idle_ns: Dict[str, int] = {}
    gaps: Dict[str, int] = {}
    for a, b in _gaps(device_events, span_ns):
        mid = (a + b) // 2
        label = _phase(names_of(threads[main].chain(mid)))
        idle_ns[label] = idle_ns.get(label, 0) + (b - a)
        gaps[label] = gaps.get(label, 0) + 1
        for name in {spans[r][0] for t in threads.values() for r in t.chain(mid)}:
            if name in per_name:
                per_name[name]["idle_ms"] += (b - a) / 1e6

    calls: Dict[str, int] = {}
    by_phase: Dict[str, int] = {}
    in_steps = 0
    for name, t, _, tid in launches:
        if not lo <= t < hi:
            continue
        calls[name] = calls.get(name, 0) + 1
        own = threads[tid].chain(t) if tid in threads else []
        held = own if tid == main else own + (threads[main].chain(t) if tid not in workers else [])
        names = set(names_of(held))
        for n in names:
            if n in per_name:
                per_name[n]["launches"] += 1
        label = "input worker" if tid in workers else _phase(names_of(threads[main].chain(t)))
        by_phase[label] = by_phase.get(label, 0) + 1
        in_steps += bool(names & set(ROOTS))
    return {"steps": len(roots), "root": spans[roots[0]][0], "main_thread": main, "workers": sorted(workers),
            "idle_s": {k: v / 1e9 for k, v in idle_ns.items()}, "gaps": gaps, "launch_calls": calls,
            "launches": {"in_steps": in_steps, "by_phase": by_phase}, "per_name": per_name,
            "dropped": recording["dropped"]}


def readings(section: dict) -> Dict[str, float]:
    """The per-layer readings a traced run would report from the section,
    under the names of the metrics they would feed (a step: a traced train
    step or eval batch)."""
    if not section:
        return {}
    n, per, idle = section["steps"], section["per_name"], section["idle_s"]
    ms = lambda name: per.get(name, {}).get("host_ms", 0.0)  # noqa: E731
    mean = lambda name: ms(name) / per[name]["count"] if per.get(name, {}).get("count") else None  # noqa: E731
    launched = section["launches"]["in_steps"] if section["launch_calls"] else None
    if section["root"] == "train_step":
        out = {f"step.{p}_ms.train": ms(p) / n for p in ("forward", "backward", "optimizer")}
        out.update({f"idle.{p}_ms.train": 1e3 * idle.get(p, 0.0) / n for p in ("forward", "backward", "optimizer")})
        if launched is not None:
            out["step.launches.train"] = launched / n
            out["step.mask_launches.train"] = per.get("hash_mask", {}).get("launches", 0) / n
        out.update({f"input.{p}_ms.train": mean(p) for p in INPUT_SPANS if mean(p) is not None})
        return out
    out = {"eval.evaluator_ms.serve": (ms("fetch") + ms("evaluator")) / n,
           "idle.evaluator_ms.serve": 1e3 * (idle.get("fetch", 0.0) + idle.get("evaluator", 0.0)) / n}
    if launched is not None:
        out["step.launches.serve"] = launched / n
    return out


def consistency(section: dict, device_events, span_ns: Tuple[int, int], host_spans: Dict[str, list],
                traced_steps: List[dict]) -> dict:
    """The section against the harness's own spans in the same run
    (host_spans and traced_steps as trace.reduce_events gets them): the
    phases' idle and host time over the dispatch span's, the launches a step
    over the dispatch gaps a step, and (serve) the fetch and evaluator idle
    over the harness's catch-all bucket."""
    if not section:
        return {}
    labelled = bench_trace.label_gaps(_gaps(device_events, span_ns), {
        "input_wait": host_spans.get("input_wait", []), "dispatch": host_spans.get("dispatch", [])})
    dispatch_ns, dispatch_gaps = labelled.get("dispatch", (0, 0))
    n = section["steps"]
    idle, per = section["idle_s"], section["per_name"]
    phases = ("forward", "backward", "optimizer") if section["root"] == "train_step" else ("forward",)
    out = {"harness_dispatch_idle_ms_a_step": dispatch_ns / 1e6 / n,
           "phases_idle_ms_a_step": 1e3 * sum(idle.get(p, 0.0) for p in phases) / n,
           "root_self_idle_ms_a_step": 1e3 * idle.get(f"{section['root']} (self)", 0.0) / n,
           "harness_dispatch_ms_a_step": (1e3 * sum(s["dispatch_s"] for s in traced_steps) / len(traced_steps)
                                          if traced_steps else None),
           "phases_host_ms_a_step": sum(per.get(p, {}).get("host_ms", 0.0) for p in phases) / n,
           "dispatch_gaps_a_step": dispatch_gaps / n,
           "launches_a_step": section["launches"]["in_steps"] / n}
    if dispatch_ns > 0:
        out["idle_share_of_dispatch"] = out["phases_idle_ms_a_step"] / out["harness_dispatch_idle_ms_a_step"]
    if out["harness_dispatch_ms_a_step"]:
        out["host_share_of_dispatch"] = out["phases_host_ms_a_step"] / out["harness_dispatch_ms_a_step"]
    if section["root"] == "eval_step":
        out["evaluator_idle_s"] = idle.get("fetch", 0.0) + idle.get("evaluator", 0.0)
        out["harness_other_idle_s"] = labelled.get(bench_trace.OTHER, (0, 0))[0] / 1e9
    return out


def print_table(section: dict, stream) -> None:
    n = section["steps"]
    print(f"port_bench phases: {n} traced {section['root']} spans; a step:", file=stream)
    for name, p in sorted(section["per_name"].items(), key=lambda kv: -kv[1]["host_ms"]):
        print(f"  {name:14s} host {p['host_ms'] / n:10.3f} ms  self {p['self_ms'] / n:10.3f} ms  idle "
              f"{p['idle_ms'] / n:9.3f} ms  launches {p['launches'] / n:9.1f}  ({p['count']} spans)", file=stream)
    for label, s in sorted(section["idle_s"].items(), key=lambda kv: -kv[1]):
        print(f"  idle under {label}: {1e3 * s / n:.3f} ms a step in {section['gaps'][label] / n:.1f} gaps",
              file=stream)


def _thread_of(event) -> int:
    """A CUDA runtime event's thread: the low 32 bits of the calling
    thread's pthread id, which kineto keeps as the event's resource id (its
    thread id is a small index of its own)."""
    return int(event.device_resource_id()) & THREAD_MASK


@contextlib.contextmanager
def recorded(report=None):
    """In this process, a traced run's harness turns the program's span
    recorder on where it starts the profiler and off where it stops it, and
    its trace reduction also hands the device events, the profiler's launch
    calls and the spans to `reduce`, and the section to `consistency`;
    `report(section, checks)` gets both. Yields a dict holding the
    "recording" once the trace stops and the "section"."""
    import torch

    from port_bench import harness
    from wav2vec2forbrain_tpu_torch.util import profiling

    state: dict = {}
    start_trace, stop_trace, reduce_events = (harness.Window.maybe_start_trace, harness.Window.maybe_stop_trace,
                                              bench_trace.reduce_events)

    def maybe_start_trace(win):
        was = win.prof
        start_trace(win)
        if was is None and win.prof is not None:
            profiling.start()

    def maybe_stop_trace(win, force: bool = False):
        was = win.trace_done
        stop_trace(win, force)
        if win.trace_done and not was:
            state["recording"], state["prof"] = profiling.stop(), win.prof

    def reduce_with_spans(events, span_ns, host_spans, traced_steps):
        out = reduce_events(events, span_ns, host_spans, traced_steps)
        cpu = torch.autograd.DeviceType.CPU
        launches = [(e.name(), e.start_ns(), e.duration_ns(), _thread_of(e))
                    for e in state["prof"].profiler.kineto_results.events()
                    if e.device_type() == cpu and is_launch(e.name())]
        section = reduce(events, launches, span_ns, state["recording"])
        state["section"] = section
        if report is not None:
            report(section, consistency(section, events, span_ns, host_spans, traced_steps))
        return out

    harness.Window.maybe_start_trace = maybe_start_trace
    harness.Window.maybe_stop_trace = maybe_stop_trace
    bench_trace.reduce_events = reduce_with_spans
    try:
        yield state
    finally:
        harness.Window.maybe_start_trace = start_trace
        harness.Window.maybe_stop_trace = stop_trace
        bench_trace.reduce_events = reduce_events
        profiling.stop()


def main(argv: Optional[list] = None) -> int:
    from port_bench import run as bench_run

    def report(section, checks):
        if section:
            print_table(section, sys.stderr)
        print("port_bench phases: " + json.dumps({"program": section, "readings": readings(section),
                                                   "consistency": checks}), file=sys.stderr)

    with recorded(report):
        return bench_run.main(list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
